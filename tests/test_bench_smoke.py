"""Smoke tests: the driver-facing bench scripts must run end to end
(tiny workloads on the test backend) and print well-formed JSON."""

import json
import subprocess
import sys
import os


def _run(script, env_extra):
    env = dict(os.environ)
    env.update(env_extra)
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, env=env,
        timeout=600, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.strip().splitlines() if l.startswith("{")]
    assert lines, proc.stdout
    return [json.loads(l) for l in lines]


def test_bench_smoke():
    out = _run(
        "bench.py",
        {"BENCH_LOG2_L": "12", "BENCH_FILES": "1", "BENCH_NQ": "2", "BENCH_NK": "64"},
    )
    rec = out[-1]
    assert rec["metric"] == "kmer_queries_per_sec_per_chip"
    assert rec["device"]["platform"] == "cpu"
    assert rec["device"]["kind"] == "cpu"
    assert rec["device"]["count"] >= 1
    assert rec["value"] > 0
    assert rec["vs_baseline"] > 0
    assert rec["complete_match_kmer_queries_per_sec"] > 0


def test_bench_refuses_implicit_cpu():
    """Without JAX_PLATFORMS=cpu, a CPU fallback is no measurement: the
    bench exits non-zero and prints no result line."""
    env = dict(os.environ, BENCH_LOG2_L="12", BENCH_FILES="1",
               BENCH_NQ="2", BENCH_NK="64")
    env.pop("JAX_PLATFORMS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True, env=env,
        timeout=600, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
    assert "needs an accelerator" in proc.stderr


def test_bench_scaling_smoke():
    out = _run(
        "bench_scaling.py",
        {"SCALING_LOG2_L": "12", "SCALING_NQ": "1", "SCALING_NK": "32"},
    )
    assert out[0]["devices"] == 1
    assert out[0]["scaling_efficiency"] == 1.0
