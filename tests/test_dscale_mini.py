"""Miniature of the distributed at-scale proof
(tools/run_at_scale_distributed.py): coordinator + 2 subprocess workers
over TCP build the corpus; the result SET equals a single-process run
over the same inputs (db packing order legitimately differs under
dynamic pulling) and the packed corpus searches byte-identically to the
reference binary when the oracle is present. The full-size run (1000
accessions) is the tool's default."""

import json
import os
import subprocess
import sys


def test_dscale_mini(tmp_path):
    env = dict(os.environ)
    # The latency-bound phase (8 pre-imported workers) is the FULL run's
    # proof; at mini scale its
    # speedup floor cannot be met on one core, so skip it here.
    env.update(SCALE_N_ACC="24", SCALE_GENOME="2500", SCALE_WORKERS="2",
               SCALE_SKIP_LATENCY="1")
    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools", "run_at_scale_distributed.py")
    proc = subprocess.run(
        [sys.executable, script, str(tmp_path / "work")], env=env,
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    phases = {json.loads(l)["phase"]: json.loads(l)
              for l in proc.stdout.splitlines() if l.startswith("{")}
    assert phases["distributed_run"]["worker_rcs"] == [0, 0]
    assert phases["search_parity"]["distributed_equals_single"] is True
    # Per-task queue overhead measured on the real wire protocol: sane,
    # sub-10ms medians on loopback, and the batch-16 amortization holds.
    oh = phases["queue_overhead"]
    assert 0 < oh["o_task_ms_batch16"] <= oh["o_task_ms_batch1"] < 10
    # One of two workers SIGKILLed mid-run with --task-timeout: the
    # coordinator re-queues its pre-marked in-flight tasks and the corpus
    # completes with the single-process result set.
    assert phases["crash_recovery"]["result_set_equals_single"] is True
    assert phases["done"]["ok"] is True
