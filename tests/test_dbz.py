"""Compressed .dbz databases (engine extension): byte-level format,
search equality with .db, adaptive 100-accession multi-query batch
(BASELINE config 2)."""

import io
import json
import sys
import zlib

import numpy as np
import pytest

from kwage.cli.kwage import main as kwage_main
from kwage.core import FilterInfo, str_to_accession
from kwage.core.params import BloomParam
from kwage.io.bloom_file import BloomFilterRecord, write_bloom_file
from kwage.io.db_file import DBFileReader
from kwage.io.dbz_file import DBZFileReader, open_database
from kwage.pipeline import (
    BuildOptions,
    build_bloom_from_sequences,
    build_db_from_bloom_files,
    build_dbz_from_bloom_files,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """100 synthetic accessions, adaptive sizing, one query per 10th."""
    work = tmp_path_factory.mktemp("dbz")
    rng = np.random.default_rng(42)
    opts = BuildOptions(
        kmer_len=31,
        min_kmer_count=1,
        min_log_2_filter_len=12,
        max_log_2_filter_len=18,
        min_log_2_count_len=12,
        max_log_2_count_len=18,
    )
    paths = {}
    queries = []
    for i in range(100):
        acc = f"SRR2{i:06d}"
        # Varying sizes exercise the adaptive BloomParam solver.
        n = 200 + 37 * i
        seq = "".join(rng.choice(list("ACGT"), size=n))
        rec = build_bloom_from_sequences(
            [seq], opts, FilterInfo(run_accession=str_to_accession(acc))
        )
        p = work / f"{acc}.bloom"
        write_bloom_file(str(p), rec)
        paths.setdefault(rec.param, []).append(str(p))
        if i % 10 == 0:
            queries.append((acc, seq[50:150]))
    return work, paths, queries


def _build_pair(work, param, blooms):
    db = work / "pair.db"
    dbz = work / "pair.dbz"
    build_db_from_bloom_files(str(db), param, blooms)
    build_dbz_from_bloom_files(str(dbz), param, blooms, chunk_bits=1 << 12)
    return str(db), str(dbz)


def test_dbz_roundtrip_and_crc(corpus):
    work, groups, _ = corpus
    param, blooms = max(groups.items(), key=lambda kv: len(kv[1]))
    db, dbz = _build_pair(work, param, blooms)

    r_db = DBFileReader(db)
    r_dbz = DBZFileReader(dbz)
    # Same logical content: identical crc32, identical decompressed slices.
    assert r_db.header.crc32 == r_dbz.header.crc32
    assert np.array_equal(r_db.read_slices(), r_dbz.read_slices())
    assert r_dbz.verify_crc32()
    # Row gather equivalence (chunk cache path).
    rows = np.array([0, 1, 5, 1000, r_db.header.filter_len - 1])
    assert np.array_equal(r_db.read_slice_rows(rows), r_dbz.read_slice_rows(rows))
    # Annotations round-trip.
    assert [i.run_accession for i in r_db.read_all_filter_info()] == [
        i.run_accession for i in r_dbz.read_all_filter_info()
    ]
    # It actually compresses (sparse filters -> well under 1.0).
    import os

    assert os.path.getsize(dbz) < os.path.getsize(db)
    # Sniffing dispatcher.
    assert isinstance(open_database(dbz), DBZFileReader)
    assert isinstance(open_database(db), DBFileReader)


def _run_kwage(args):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = kwage_main(args)
    finally:
        sys.stdout = old
    assert rc == 0
    return buf.getvalue()


def test_config2_adaptive_multiquery_db_vs_dbz(corpus, tmp_path):
    """100 adaptive accessions; batched multi-query search over all DB
    shards; .db and .dbz outputs byte-identical."""
    work, groups, queries = corpus
    db_dir = tmp_path / "db"
    dbz_dir = tmp_path / "dbz"
    db_dir.mkdir()
    dbz_dir.mkdir()
    for gi, (param, blooms) in enumerate(sorted(groups.items())):
        build_db_from_bloom_files(str(db_dir / f"sra.{gi}.db"), param, blooms)
        build_dbz_from_bloom_files(
            str(dbz_dir / f"sra.{gi}.dbz"), param, blooms, chunk_bits=1 << 12
        )

    qfile = tmp_path / "queries.fasta"
    with open(qfile, "w") as f:
        for acc, q in queries:
            f.write(f">q_{acc}\n{q}\n")

    for t in ("1", "0.6"):
        out_db = _run_kwage(["-d", str(db_dir), "-i", str(qfile), "-t", t, "--o.json"])
        out_dbz = _run_kwage(["-d", str(dbz_dir), "-i", str(qfile), "-t", t, "--o.json"])
        assert out_db == out_dbz
        # Every query hits its own accession.
        payload = json.loads(out_db)
        assert len(payload) == len(queries)
        for entry, (acc, _) in zip(payload, queries):
            runs = {r["sample_metadata"]["run"] for r in entry["results"]}
            assert acc in runs


def test_merge_db_refuses_dbz(corpus, tmp_path):
    from kwage.pipeline.merge_db import merge_database_files

    work, groups, _ = corpus
    param, blooms = max(groups.items(), key=lambda kv: len(kv[1]))
    dbz1 = tmp_path / "a.dbz"
    dbz2 = tmp_path / "b.dbz"
    build_dbz_from_bloom_files(str(dbz1), param, blooms[:2], chunk_bits=1 << 12)
    build_dbz_from_bloom_files(str(dbz2), param, blooms[2:4], chunk_bits=1 << 12)
    with pytest.raises(ValueError):
        merge_database_files(str(dbz1), str(dbz2), max_num_filters=8, verbose=False)


def test_device_search_multichunk_fusion(corpus, tmp_path, monkeypatch):
    """A tiny fusion budget forces the multi-chunk streaming path; hit
    lists must stay identical to the host engine."""
    from kwage.ops.search import search_files_device
    from kwage.search.engine import search_database_files

    work, groups, queries = corpus
    dbs = []
    for gi, (param, blooms) in enumerate(sorted(groups.items())):
        db = tmp_path / f"sra.{gi}.db"
        build_db_from_bloom_files(str(db), param, blooms)
        dbs.append(str(db))

    q = [(i, s) for i, (_, s) in enumerate(queries)]
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", "20000")  # a few KiB
    for t in (1.0, 0.5):
        dev = search_files_device(dbs, q, t)
        host = search_database_files(dbs, q, t)
        assert set(dev) == set(host)
        for qid in host:
            assert [
                (m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                for m in dev[qid]
            ] == [
                (m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                for m in host[qid]
            ]


def test_device_search_slab_streams_single_wide_file(corpus, tmp_path, monkeypatch):
    """A budget smaller than ONE file forces intra-file column-slab
    streaming (ops.search.eval_chunk_cols) — the production-L regime,
    where a full 2048-filter file at L=26 is 16 GiB and exceeds HBM.
    Hit lists must stay identical to the host engine."""
    from kwage.io.dbz_file import open_database
    from kwage.ops.search import search_files_device
    from kwage.search.engine import search_database_files

    work, groups, queries = corpus
    param, blooms = max(groups.items(), key=lambda kv: len(kv[1]))
    db = tmp_path / "wide.db"
    build_db_from_bloom_files(str(db), param, blooms)
    h = open_database(str(db)).header
    file_bytes = h.filter_len * ((h.slice_size + 3) // 4) * 4
    # Three-plus slabs through the one file.
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(max(file_bytes // 3, 4)))

    q = [(i, s) for i, (_, s) in enumerate(queries)]
    for t in (1.0, 0.5):
        dev = search_files_device([str(db)], q, t)
        host = search_database_files([str(db)], q, t)
        assert set(dev) == set(host)
        for qid in host:
            assert [
                (m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                for m in dev[qid]
            ] == [
                (m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                for m in host[qid]
            ]


def test_resident_slab_streams_single_wide_file(corpus, tmp_path):
    """ResidentSearcher with a budget below one file's size serves via
    per-call column-slab streaming, identical hit lists to the host."""
    from kwage.search.engine import search_database_files
    from kwage.search.resident import ResidentSearcher

    work, groups, queries = corpus
    param, blooms = max(groups.items(), key=lambda kv: len(kv[1]))
    db = tmp_path / "wide.db"
    build_db_from_bloom_files(str(db), param, blooms)
    rs = ResidentSearcher([str(db)], budget_bytes=1 << 12)
    assert rs.resident_bytes == 0  # nothing fit: the chunk stayed host-side

    q = [(i, s) for i, (_, s) in enumerate(queries)]
    for t in (1.0, 0.5):
        dev = rs.search(q, t)
        host = search_database_files([str(db)], q, t)
        assert set(dev) == set(host)
        for qid in host:
            assert [
                (m.num_kmers_found, m.subject_info.run_accession) for m in dev[qid]
            ] == [
                (m.num_kmers_found, m.subject_info.run_accession) for m in host[qid]
            ]


def test_mixed_db_dbz_fusion(corpus, tmp_path):
    """Same-param .db and .dbz files fuse into one device matrix; hits
    equal the host engine run over the same mixed set."""
    from kwage.ops.search import search_files_device
    from kwage.search.engine import search_database_files

    work, groups, queries = corpus
    param, blooms = max(groups.items(), key=lambda kv: len(kv[1]))
    half = len(blooms) // 2
    db = tmp_path / "a.db"
    dbz = tmp_path / "b.dbz"
    build_db_from_bloom_files(str(db), param, blooms[:half])
    build_dbz_from_bloom_files(str(dbz), param, blooms[half:], chunk_bits=1 << 12)
    paths = [str(db), str(dbz)]
    q = [(i, s) for i, (_, s) in enumerate(queries)]
    dev = search_files_device(paths, q, 1.0)
    host = search_database_files(paths, q, 1.0)
    assert set(dev) == set(host)
    for qid in host:
        assert [
            (m.num_kmers_found, m.subject_info.run_accession) for m in dev[qid]
        ] == [(m.num_kmers_found, m.subject_info.run_accession) for m in host[qid]]


def test_seek_based_search_matches_in_memory(corpus, tmp_path):
    """in_memory=False (per-row seeks, the reference's access pattern,
    kwage.cpp:404-433) must produce identical results."""
    from kwage.search.engine import search_database_files

    work, groups, queries = corpus
    dbs = []
    for gi, (param, blooms) in enumerate(sorted(groups.items())):
        db = tmp_path / f"sra.{gi}.db"
        build_db_from_bloom_files(str(db), param, blooms)
        dbs.append(str(db))
    q = [(i, s) for i, (_, s) in enumerate(queries)]
    for t in (1.0, 0.5):
        mem = search_database_files(dbs, q, t, in_memory=True)
        seek = search_database_files(dbs, q, t, in_memory=False)
        assert set(mem) == set(seek)
        for qid in mem:
            assert [
                (m.num_kmers_found, m.subject_info.run_accession) for m in mem[qid]
            ] == [(m.num_kmers_found, m.subject_info.run_accession) for m in seek[qid]]
