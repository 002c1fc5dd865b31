"""Validation rigs: bloom_test ground-truth comparison, db_debug transpose
harness, sra_dump profiler, sra_meta probe, mem_usage."""

import numpy as np
import pytest

from kwage.cli import bloom_test, db_debug, sra_dump
from kwage.pipeline.sra_meta import number_of_bases
from kwage.utils import memory_usage


@pytest.fixture()
def fasta(tmp_path):
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(8)]
    # Repeat some reads so min_kmer_count > 1 has abundant k-mers.
    path = tmp_path / "reads.fasta"
    with open(path, "w") as f:
        for i, s in enumerate(seqs + seqs[:4]):
            f.write(f">r{i}\n{s}\n")
    return str(path)


def test_bloom_test_exact_match(fasta, capsys):
    # Large counting filter: the approximate path must equal ground truth.
    rc = bloom_test.main(
        ["--min-kmer-count", "2", "--len.max", "20", "--len.count", "18", fasta]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Bit differences             = 0" in out


def test_bloom_test_never_suppresses(fasta, capsys):
    # Tiny counting filter: collisions promote extra k-mers, but every
    # ground-truth bit must still be present (conservative update can
    # only over-promote).
    rc = bloom_test.main(
        ["--min-kmer-count", "3", "--len.max", "18", "--len.count", "10", fasta]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "ERROR" not in out


def test_db_debug_pass(capsys):
    rc = db_debug.main(["-n", "17", "--len", "13"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("PASS")


def test_db_debug_odd_width(capsys):
    # 9 filters: exercises the non-byte-aligned slice padding path.
    rc = db_debug.main(["-n", "9", "--len", "12", "--seed", "3"])
    assert rc == 0
    assert capsys.readouterr().out.startswith("PASS")


def test_sra_dump(fasta, capsys):
    rc = sra_dump.main(["--print", "--max-read", "2", fasta])
    captured = capsys.readouterr()
    assert rc == 0
    assert captured.out.count(">") == 2
    assert "Found 2 reads; 800 bases" in captured.err


def test_sra_meta_local(fasta):
    assert number_of_bases(fasta) == (400 * 12, 12)


def test_memory_usage_bounds():
    m = memory_usage()
    assert 0.0 <= m <= 1.0
    assert m > 0.0  # this process alone uses some RAM


def test_profiling_scopes():
    from kwage.utils import report, reset, scope

    reset()
    with scope("unit"):
        pass
    with scope("unit"):
        pass
    r = report()
    assert r["unit"]["count"] == 2
    assert r["unit"]["total_sec"] >= 0.0


def test_device_trace_noop_without_env(monkeypatch):
    from kwage.utils import device_trace

    monkeypatch.delenv("KWAGE_TRACE_DIR", raising=False)
    with device_trace():
        x = 1
    assert x == 1


def test_read_sra_repository(tmp_path):
    from kwage.io.ncbi_config import read_sra_repository

    cfg = tmp_path / "user-settings.mkfg"
    cfg.write_text(
        '/LIBS/GUID = "xyz"\n'
        '/repository/user/main/public/root = "/data/ncbi"\n'
    )
    assert read_sra_repository(str(cfg)) == "/data/ncbi/sra"
    # malformed: missing quotes
    cfg.write_text("/repository/user/main/public/root = /data/ncbi\n")
    assert read_sra_repository(str(cfg)) is None
    assert read_sra_repository(str(tmp_path / "missing.mkfg")) is None
