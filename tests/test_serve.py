"""Device-resident search service (search/resident.py): load once, query
many times, output byte-identical to the kwage CLI (engine extension)."""

import json
import socket

import pytest


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory, data_dir, golden_dir):
    """A small maestro-built corpus to serve."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    with open(golden_dir / "e2e" / "manifest.json") as f:
        man = json.load(f)
    work = tmp_path_factory.mktemp("serve")
    accs = man["accessions"]
    write_inventory(str(work / "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a)) for a in accs])
    opt = MaestroOptions(
        metadata_file=str(work / "inv.bin"),
        scratch_bloom_dir=str(work / "bloom"),
        scratch_database_dir=str(work / "db"),
        status_file=str(work / "status.bin"),
        kmer_len=man["k"], min_kmer_count=man["min_kmer_count"],
        false_positive_probability=man["fp"],
        min_log_2_filter_len=man["minL"], max_log_2_filter_len=man["maxL"],
        min_log_2_count_len=man["minLc"], max_log_2_count_len=man["maxLc"],
        num_workers=2,
    )
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    return str(work / "db"), man


def _cli_output(db_dir, queries, threshold, fmt, tmp_path):
    import io
    import sys

    from kwage.cli.kwage import main as kwage_main

    out = tmp_path / "cli.out"
    args = ["-d", db_dir, "-t", str(threshold), f"--{fmt}", "-o", str(out)]
    args += queries
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        assert kwage_main(args) == 0
    finally:
        sys.stdout = old
    return out.read_text()


def test_resident_searcher_matches_cli(db_dir, data_dir, tmp_path):
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import ResidentSearcher

    db, man = db_dir
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:3]
    rs = ResidentSearcher(find_db_files([db]))
    for threshold, fmt in ((1.0, "o.json"), (0.5, "o.csv"), (0.75, "o.json")):
        want = _cli_output(db, queries, threshold, fmt, tmp_path)
        got = rs.render(queries, threshold, fmt.split(".")[1])
        assert got == want, (threshold, fmt)


def test_search_server_round_trips(db_dir, data_dir, tmp_path):
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import SearchServer

    db, man = db_dir
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:2]
    server = SearchServer(find_db_files([db]), host="127.0.0.1")
    server.start()
    try:
        with socket.create_connection(server.address, timeout=30) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            # Several requests over ONE connection: the resident matrix
            # answers each without reloading.
            for threshold in (1.0, 0.5):
                f.write(json.dumps({"queries": queries,
                                    "threshold": threshold}) + "\n")
                f.flush()
                reply = json.loads(f.readline())
                assert reply["ok"], reply
                want = _cli_output(db, queries, threshold, "o.json", tmp_path)
                assert reply["output"] == want
            # Malformed request -> structured error, connection stays up.
            f.write(json.dumps({"queries": queries, "threshold": 7}) + "\n")
            f.flush()
            reply = json.loads(f.readline())
            assert not reply["ok"] and "threshold" in reply["error"]
            f.write(json.dumps({"queries": queries, "threshold": 1.0}) + "\n")
            f.flush()
            assert json.loads(f.readline())["ok"]
    finally:
        server.shutdown()


def test_resident_budget_chunks_match(db_dir, data_dir, tmp_path):
    """A tiny HBM budget forces per-call-upload chunks; output stays
    byte-identical to the fully-resident server."""
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import ResidentSearcher

    db, _ = db_dir
    files = find_db_files([db])
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:3]
    full = ResidentSearcher(files)
    tiny = ResidentSearcher(files, budget_bytes=1 << 10)
    assert tiny.resident_bytes <= 1 << 10
    for threshold in (1.0, 0.5):
        assert tiny.render(queries, threshold) == full.render(queries, threshold)


def test_mesh_resident_searcher_matches_single(db_dir, data_dir, tmp_path):
    """MeshResidentSearcher (filters sharded over the 8-device mesh)
    renders byte-identical output to the single-device ResidentSearcher."""
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import MeshResidentSearcher, ResidentSearcher

    db, _man = db_dir
    files = find_db_files([db])
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:3]
    single = ResidentSearcher(files)
    mesh = MeshResidentSearcher(files)
    for threshold, fmt in ((1.0, "json"), (0.5, "csv"), (0.75, "json")):
        assert mesh.render(queries, threshold, fmt) == \
            single.render(queries, threshold, fmt), (threshold, fmt)


def test_search_server_token_auth(db_dir, data_dir, tmp_path):
    """With a shared secret, requests without a matching token are refused
    and tokened requests serve normally."""
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import SearchServer

    db, _man = db_dir
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:1]
    server = SearchServer(find_db_files([db]), host="127.0.0.1", secret="tok3n")
    server.start()
    try:
        with socket.create_connection(server.address, timeout=30) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            for req, ok in (
                ({"queries": queries, "threshold": 1.0}, False),
                ({"queries": queries, "threshold": 1.0, "token": "bad"}, False),
                ({"queries": queries, "threshold": 1.0, "token": "tok3n"}, True),
            ):
                f.write(json.dumps(req) + "\n")
                f.flush()
                reply = json.loads(f.readline())
                assert reply["ok"] is ok, reply
                if not ok:
                    assert "token" in reply["error"]
                else:
                    want = _cli_output(db, queries, 1.0, "o.json", tmp_path)
                    assert reply["output"] == want
    finally:
        server.shutdown()


def test_search_server_host_engine_matches_cli(db_dir, data_dir, tmp_path):
    """--serve-engine host: CPU-only backend (mmap + native kn_search),
    bytes identical to the batch CLI for the same queries."""
    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.search.resident import SearchServer

    db, man = db_dir
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:2]
    server = SearchServer(find_db_files([db]), host="127.0.0.1", engine="host")
    server.start()
    try:
        with socket.create_connection(server.address, timeout=30) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            for threshold in (1.0, 0.5):
                for fmt in ("json", "csv"):
                    f.write(json.dumps({"queries": queries,
                                        "threshold": threshold,
                                        "format": fmt}) + "\n")
                    f.flush()
                    reply = json.loads(f.readline())
                    assert reply["ok"], reply
                    want = _cli_output(db, queries, threshold, f"o.{fmt}", tmp_path)
                    assert reply["output"] == want
    finally:
        server.shutdown()
