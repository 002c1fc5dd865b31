"""Inspection CLI tools vs oracle outputs captured at golden-generation time.

The golden .txt files are the stdout of the reference dump_db/dump_bloom
binaries run on the e2e corpus artifacts (which our pipeline reproduces
byte-identically, so running our tools on our artifacts must match).
"""

import io
import json
import sys

import pytest

from kwage.cli import bloom_diff, dump_bloom, dump_db, inventory_dump, sra_diff


@pytest.fixture(scope="module")
def artifacts(golden_dir, data_dir, tmp_path_factory):
    """Rebuild the e2e corpus artifacts with our pipeline."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.bloom_file import read_bloom_file, write_bloom_file
    from kwage.pipeline import (
        BuildOptions,
        build_bloom_from_file,
        build_db_from_bloom_files,
    )

    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    work = tmp_path_factory.mktemp("cli_tools")
    opts = BuildOptions(
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
    )
    blooms = {}
    for acc in manifest["accessions"][:4]:
        info = FilterInfo(run_accession=str_to_accession(acc))
        rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
        path = work / f"{acc}.bloom"
        write_bloom_file(str(path), rec)
        blooms[acc] = str(path)

    group = manifest["db_groups"][2]  # 4 filters, L=13, h=3
    param = None
    for acc in group:
        if acc not in blooms:
            info = FilterInfo(run_accession=str_to_accession(acc))
            rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
            path = work / f"{acc}.bloom"
            write_bloom_file(str(path), rec)
            blooms[acc] = str(path)
    param = read_bloom_file(blooms[group[0]], with_bits=False).param
    db_path = work / "sra.2.db"
    build_db_from_bloom_files(str(db_path), param, [blooms[a] for a in group])
    return blooms, str(db_path), manifest


def _capture(fn, argv):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        rc = fn(argv)
        return rc, sys.stdout.getvalue()
    finally:
        sys.stdout = old


def test_dump_bloom_matches_oracle(artifacts, golden_dir):
    blooms, _, manifest = artifacts
    acc = manifest["accessions"][0]
    rc, out = _capture(dump_bloom.main, [blooms[acc]])
    assert rc == 0
    with open(golden_dir / "e2e" / "dump_bloom.txt") as f:
        want = f.read()
    # The first line embeds the (temp) path; compare from line 2 on.
    assert out.splitlines()[1:] == want.splitlines()[1:]


def test_dump_db_matches_oracle(artifacts, golden_dir):
    _, db_path, _ = artifacts
    rc, out = _capture(dump_db.main, ["--bits", "4", "-i", db_path])
    assert rc == 0
    with open(golden_dir / "e2e" / "dump_db.txt") as f:
        want = f.read()
    assert out.splitlines()[1:] == want.splitlines()[1:]


def test_bloom_diff_identical_and_different(artifacts, capsys):
    blooms, _, manifest = artifacts
    accs = manifest["accessions"]
    rc = bloom_diff.main([blooms[accs[0]], blooms[accs[0]]])
    assert rc == 0
    err = capsys.readouterr().err
    assert "crc32 values are the same" in err
    assert "differ by 0 bits" in err

    # Same param group, different content -> nonzero diff.
    same_group = manifest["db_groups"][2]
    rc = bloom_diff.main([blooms[same_group[0]], blooms[same_group[1]]])
    assert rc == 0
    err = capsys.readouterr().err
    assert "have different crc32 values" in err


def test_inventory_roundtrip_and_dump(tmp_path, capsys):
    from kwage.core import Date, FilterInfo, str_to_accession
    from kwage.io.inventory import read_inventory, write_inventory

    infos = [
        FilterInfo(
            run_accession=str_to_accession(f"SRR{i}"),
            experiment_title=f"exp {i}",
            number_of_bases=100 * i,
            number_of_spots=i,
            date_received=Date.parse("2019-07-04T00:00:00Z"),
        )
        for i in range(1, 4)
    ]
    path = tmp_path / "inv.bin"
    write_inventory(str(path), infos)
    back = read_inventory(str(path))
    assert [b.run_accession for b in back] == [i.run_accession for i in infos]

    rc = inventory_dump.main([str(path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Metadata file contains 3 FilterInfo objects" in out
    assert "SRR1" in out and "date_received : 2019-7-4" in out


def test_sra_diff(tmp_path, capsys):
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory

    a = [FilterInfo(run_accession=str_to_accession(x)) for x in ("SRR1", "SRR2", "SRR3")]
    b = [FilterInfo(run_accession=str_to_accession(x)) for x in ("SRR2", "SRR4")]
    p1, p2 = tmp_path / "a.bin", tmp_path / "b.bin"
    write_inventory(str(p1), a)
    write_inventory(str(p2), b)
    rc = sra_diff.main([str(p1), str(p2)])
    assert rc == 0
    out = capsys.readouterr().out
    # SRR4 remains unvisited in file 2 when file 1 exhausts (sra_diff.cpp:52-66)
    assert "1: SRR1" in out and "1: SRR3" in out
    assert "There are 1 accessions remaining in the second file" in out


def test_dump_db_unsupported_compression_prints_header(artifacts, tmp_path, capsys):
    """An RLE/unknown compression value still prints the full header and
    exits 0 with the reference's bail message (dump_db.cpp:130-160)."""
    import shutil
    import struct

    _, db_path, _ = artifacts
    rle = tmp_path / "rle.db"
    shutil.copy(db_path, rle)
    data = bytearray(rle.read_bytes())
    # Header field 9 (compression) at offset 32 (<IIIIIIIiI...): set RLE=1.
    struct.pack_into("<I", data, 32, 1)
    rle.write_bytes(bytes(data))

    rc, out = _capture(dump_db.main, ["-i", str(rle)])
    err = capsys.readouterr().err
    assert rc == 0
    assert "compression = RLE" in out
    assert "kmer_len =" in out
    assert "Compressed database files are not currently supported!" in err
