"""Phase timings for the batched device build (diagnosis tool).

Runs warm batches through prepare/dispatch/finish separately and prints
where the time goes: host pack, upload+count dispatch, readback block,
solve+scatter+readback, .bloom write. Env: PH_N_ACC (8), PH_BP (300000),
PH_REPS (5).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

N = int(os.environ.get("PH_N_ACC", "8"))
BP = int(os.environ.get("PH_BP", "300000"))
REPS = int(os.environ.get("PH_REPS", "5"))


def main() -> None:
    from kwage.core import FilterInfo
    from kwage.pipeline.make_bloom import (
        BuildOptions,
        dispatch_device_batch,
        finish_device_batch,
        prepare_device_batch,
    )

    work = tempfile.mkdtemp(prefix="bench_phases.")
    try:
        rng = np.random.default_rng(0)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        read_len = 300
        paths = []
        for a in range(N):
            genome = lut[rng.integers(0, 4, size=BP // 4, dtype=np.uint8)]
            starts = rng.integers(0, genome.size - read_len + 1, size=BP // read_len)
            p = os.path.join(work, f"a{a}.fasta")
            with open(p, "wb") as f:
                for r, st in enumerate(starts):
                    f.write(b">r%d\n" % r)
                    f.write(genome[st : st + read_len].tobytes())
                    f.write(b"\n")
            paths.append(p)

        opts = BuildOptions(
            min_kmer_count=2, min_log_2_filter_len=18, max_log_2_filter_len=24,
            min_log_2_count_len=18, max_log_2_count_len=24,
        )

        def run_once():
            t = {}
            t0 = time.perf_counter()
            prep = prepare_device_batch([(p, FilterInfo()) for p in paths], opts)
            t["prepare"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            handles = dispatch_device_batch(prep, opts)
            t["dispatch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            nv = np.asarray(handles[4])
            t["count_readback"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            recs = finish_device_batch(prep, opts, handles)
            t["finish_rest"] = time.perf_counter() - t0
            assert all(not isinstance(r, Exception) for r in recs), recs
            t["total"] = sum(t.values())
            return t, int(nv.sum())

        run_once()  # warm compiles
        acc = {}
        for _ in range(REPS):
            t, _nv = run_once()
            for k, v in t.items():
                acc.setdefault(k, []).append(v)
        print(json.dumps({
            k: {"median_ms": round(1000 * float(np.median(v)), 1),
                "min_ms": round(1000 * float(np.min(v)), 1)}
            for k, v in acc.items()
        }, indent=1))
        med_total = float(np.median(acc["total"]))
        print(json.dumps({"filters_per_sec_serial": round(N / med_total, 1)}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
