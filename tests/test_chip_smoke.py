"""chip_smoke.py at tiny sizes on the CPU: its generators, its comparators,
and its refusal to report anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(kmer_len=31, num_hash=5, num_filter=64, log2_filter_len=13, num_files=3)


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cpu_run_exits_nonzero_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(str(tmp_path), env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def search(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    return cs.phase_search(work, TINY, 12, (100, 600), seed=0)


def test_search_planted_hits_and_parity(search):
    assert search["reduced"] is None
    assert search["queries_hit"] == {"1.0": 6, "0.5": 9}
    for t, out in search["outputs"].items():
        hits = cs.hits_by_query(out)
        assert len(hits) == search["queries_hit"][str(t)]


def test_warehouse_files_are_valid_dbs(search):
    from kwage.io.db_file import DBFileReader

    for f, path in enumerate(search["paths"]):
        r = DBFileReader(path)
        assert r.verify_crc32()
        assert r.header.num_filter == TINY["num_filter"]
        assert r.header.log_2_filter_len == TINY["log2_filter_len"]
        density = np.unpackbits(r.read_slices()).mean()
        assert 0.33 < density < 0.42, density  # a & (b | c): 37.5%
        info = r.read_filter_info(5)
        from kwage.core.accession import accession_to_str

        assert accession_to_str(info.run_accession) == cs.accession_of(f, 5)


def test_serve_replies_equal_batch_output(search):
    result = cs.phase_serve(search)
    assert result["requests"] == 4
    # The test backend has 8 virtual devices: the mesh searcher serves,
    # and each group's shards sit on distinct devices.
    assert all(len(set(s)) == 8 for s in result["shard_devices"])


def test_plan_plants_expectations():
    queries = cs.make_queries(8, (100, 300), seed=1)
    plants, expect = cs.plan_plants(queries, TINY, seed=1)
    assert set(expect[1.0]) == {0, 1, 2, 3}
    assert set(expect[0.5]) == {0, 1, 2, 3, 4, 5}
    assert all(len(v) <= 2 for v in expect[1.0].values())
    for rows, cols in plants.values():
        assert np.all(np.diff(rows) >= 0)
        assert rows.size == cols.size
        assert rows.size == 0 or rows.max() < 1 << TINY["log2_filter_len"]


def test_relabel_maps_deflines_to_server_labels():
    text = '[\n\t{\n\t\t"query": "q3",\n\t\t"threshold": 1.0\n\t},\n\t{\n\t\t"query": "q12"'
    assert cs.relabel(text) == text.replace('"q3"', '"command line seq 3"').replace(
        '"q12"', '"command line seq 12"')


@pytest.mark.parametrize("doc,want", [
    ("", {}),
    ('{\n"query": "q0",\n"threshold": 1.0,\n"results": []\n}', {"q0": set()}),
    (json.dumps([{"query": "q1", "results": [{"sample_metadata": {"run": "SRR1"}}]},
                 {"query": "q2", "results": []}]), {"q1": {"SRR1"}, "q2": set()}),
])
def test_hits_by_query(doc, want):
    assert cs.hits_by_query(doc) == want


def test_build_device_and_host_files_identical(tmp_path):
    result = cs.phase_build(str(tmp_path), 5, 6000, seed=0)
    assert result["sha256_identical"] and result["bloom_files"] == 5


def test_sriracha_device_equals_host(tmp_path):
    result = cs.phase_sriracha(str(tmp_path), 2000, 150, 0,
                               {21: (4, 800), 11: (32, 2200)},
                               {21: "hash", 11: "table"})
    assert result["k21"]["formulation"] == "hash"
    assert result["k11"]["formulation"] == "table"


def test_tree_digests(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x.db").write_bytes(b"abc")
    (tmp_path / "y.bloom").write_bytes(b"")
    (tmp_path / "z.txt").write_bytes(b"skip")
    d = cs.tree_digests(str(tmp_path), (".db", ".bloom"))
    assert set(d) == {os.path.join("a", "x.db"), "y.bloom"}
    assert d["y.bloom"] == "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"


def test_kernels_phase_runs_tiny():
    out = cs.phase_kernels(num_filter=64, log2_bits=12, log2_image=14, batch=2)
    assert out["transpose"]["bytes"] == 64 * (1 << 12) // 8
    assert out["set_filter_bits_multi"]["batch"] == 2


def test_search_drops_one_level_of_l_when_host_ram_is_short(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "host_ram_bytes", lambda: 1 << 30)
    spec = dict(TINY, log2_filter_len=19, num_files=2)
    result = cs.phase_search(str(tmp_path), spec, 8, (100, 300), seed=2)
    assert result["spec"]["log2_filter_len"] == 18
    assert result["reduced"].startswith("L=2^18")
    assert result["corpus_gib"] == 2 * (1 << 18) * 64 / 8 / 2**30
