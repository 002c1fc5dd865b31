"""merge_db: byte parity vs the oracle merge, plus remainder-spill behavior."""

import hashlib
import json
import shutil

import pytest

from kwage.cli.kwage import main as kwage_main
from kwage.core import FilterInfo, str_to_accession
from kwage.io.bloom_file import read_bloom_file, write_bloom_file
from kwage.io.db_file import DBFileReader
from kwage.pipeline import (
    BuildOptions,
    build_bloom_from_file,
    build_db_from_bloom_files,
)
from kwage.pipeline.merge_db import merge_database_files, merge_databases


@pytest.fixture(scope="module")
def split_dbs(golden_dir, data_dir, tmp_path_factory):
    """The 4-filter param group split into two 2-filter databases."""
    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    work = tmp_path_factory.mktemp("merge")
    opts = BuildOptions(
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
    )
    group = manifest["db_groups"][2]
    blooms = []
    for acc in group:
        info = FilterInfo(run_accession=str_to_accession(acc))
        rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
        path = work / f"{acc}.bloom"
        write_bloom_file(str(path), rec)
        blooms.append(str(path))
    param = read_bloom_file(blooms[0], with_bits=False).param
    a, b = work / "part_a.db", work / "part_b.db"
    build_db_from_bloom_files(str(a), param, blooms[:2])
    build_db_from_bloom_files(str(b), param, blooms[2:])
    full = work / "full.db"
    build_db_from_bloom_files(str(full), param, blooms)
    return work, str(a), str(b), str(full), manifest


def _sha(p):
    with open(p, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_merge_equals_direct_build(split_dbs, tmp_path):
    work, a, b, full, _ = split_dbs
    ca, cb = tmp_path / "a.db", tmp_path / "b.db"
    shutil.copy(a, ca)
    shutil.copy(b, cb)
    # smallest-first pairing: both have 2 filters; main pops (a, b) ->
    # merge_database_files(file_large=b, file_small=a): b's columns first.
    merge_databases([str(ca), str(cb)], verbose=False)
    assert not cb.exists() or not ca.exists()
    merged = cb if cb.exists() else ca
    hdr = DBFileReader(str(merged)).header
    assert hdr.num_filter == 4
    assert DBFileReader(str(merged)).verify_crc32()


def test_merge_column_order_and_search(split_dbs, tmp_path, capsys):
    work, a, b, full, manifest = split_dbs
    ca, cb = tmp_path / "a.db", tmp_path / "b.db"
    shutil.copy(a, ca)
    shutil.copy(b, cb)
    merge_database_files(str(ca), str(cb), 2048, verbose=False)
    # file_large = ca keeps its columns first, then cb's appended = build order
    assert _sha(ca) == _sha(full)


def test_merge_remainder_spill(split_dbs, tmp_path):
    work, a, b, full, manifest = split_dbs
    ca, cb = tmp_path / "a.db", tmp_path / "b.db"
    shutil.copy(a, ca)
    shutil.copy(b, cb)
    rem = merge_database_files(str(ca), str(cb), 3, verbose=False)
    assert rem == (1, str(cb))
    h1 = DBFileReader(str(ca)).header
    h2 = DBFileReader(str(cb)).header
    assert h1.num_filter == 3 and h2.num_filter == 1
    assert DBFileReader(str(ca)).verify_crc32()
    assert DBFileReader(str(cb)).verify_crc32()

    # Search over the spilled pair == search over the unmerged pair.
    query_file = "tests/data/queries.fasta"
    import io, sys

    def run(dbs):
        out = tmp_path / "o.json"
        assert kwage_main(["--o.json", "-t", "0.5", "-i", query_file]
                          + [x for d in dbs for x in ("-d", d)]
                          + ["-o", str(out)]) == 0
        return out.read_text()

    merged_out = run([str(ca), str(cb)])
    orig_out = run([a, b])
    assert merged_out == orig_out


def test_merge_matches_reference_binary_digest(tmp_path):
    """Live-oracle golden: the reference merge_db binary (MPI-stubbed
    build), run on this exact deterministic input set, consolidated all
    17 filters into sra.2.db with the sha256 below and deleted the
    consumed files. Our defragmenter must reproduce those bytes."""
    import hashlib
    import zlib

    import numpy as np

    from kwage.cli.merge_db import main as merge_main
    from kwage.core import FilterInfo, str_to_accession
    from kwage.core.params import BloomParam
    from kwage.io.bloom_file import BloomFilterRecord, write_bloom_file
    from kwage.pipeline import build_db_from_bloom_files

    rng = np.random.default_rng(5)
    param = BloomParam(kmer_len=31, log_2_filter_len=18, num_hash=3, hash_func=0)
    nb = param.filter_len // 8

    def mkdb(dbname, accs):
        paths = []
        for acc in accs:
            bits = rng.integers(0, 256, size=nb, dtype=np.uint8)
            rec = BloomFilterRecord(
                param=param,
                crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
                info=FilterInfo(run_accession=str_to_accession(acc)),
                bits=bits,
            )
            p = tmp_path / f"{acc}.bloom"
            write_bloom_file(str(p), rec)
            paths.append(str(p))
        build_db_from_bloom_files(str(tmp_path / dbname), param, paths)

    mkdb("sra.0.db", [f"SRR{i}" for i in range(1, 6)])
    mkdb("sra.1.db", [f"SRR{i}" for i in range(6, 9)])
    mkdb("sra.2.db", [f"SRR{i}" for i in range(9, 18)])

    assert merge_main([str(tmp_path / f"sra.{i}.db") for i in range(3)]) == 0
    assert not (tmp_path / "sra.0.db").exists()
    assert not (tmp_path / "sra.1.db").exists()
    digest = hashlib.sha256((tmp_path / "sra.2.db").read_bytes()).hexdigest()
    assert digest == "5ebe26db340142d96858559da62434093f86c7a0bba49003c4fa553af99136bb"
