"""Build-side benchmark: Bloom filters built/s + ingest Mbp/s
(the BASELINE "Bloom filters built/s" metric).

Builds a synthetic corpus of FASTA accessions, then times the complete
maestro pipeline (resolve -> count/threshold -> adaptive sizing ->
.bloom -> transpose -> .db) for the host-parity path and, when a device
is present, the exact-count device path. Prints one JSON line per mode.

Env overrides: BUILD_N_ACC (default 32), BUILD_BP (bases/accession,
default 300000), BUILD_WORKERS (default 4).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

N_ACC = int(os.environ.get("BUILD_N_ACC", "32"))
BP = int(os.environ.get("BUILD_BP", "300000"))
WORKERS = int(os.environ.get("BUILD_WORKERS", "4"))
DEVICE_BATCH = int(os.environ.get("BUILD_DEVICE_BATCH", "16"))


def main() -> None:
    import jax

    from kwage.utils.runtime import enable_compile_cache

    # Persistent compile cache: device-mode figures reflect steady state,
    # not the one-time kernel compiles.
    enable_compile_cache()

    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    work = tempfile.mkdtemp(prefix="bench_build.")
    try:
        rng = np.random.default_rng(0)
        src = os.path.join(work, "fa")
        os.makedirs(src)
        accs = [f"SRR5{i:06d}" for i in range(N_ACC)]
        read_len = 300
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        for acc in accs:
            # Reads sampled from a per-accession genome at ~4x coverage, so
            # true k-mers recur (min_kmer_count de-noising has signal to keep).
            n_reads = BP // read_len
            genome = lut[rng.integers(0, 4, size=max(BP // 4, read_len), dtype=np.uint8)]
            starts = rng.integers(0, genome.size - read_len + 1, size=n_reads)
            with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
                for r, st in enumerate(starts):
                    f.write(b">r%d\n" % r)
                    f.write(genome[st : st + read_len].tobytes())
                    f.write(b"\n")
        write_inventory(
            os.path.join(work, "inv.bin"),
            [FilterInfo(run_accession=str_to_accession(a)) for a in accs],
        )

        modes = [("host", False)]
        if jax.default_backend() != "cpu":
            modes.append(("device", True))

        for name, device_build in modes:
            scratch = os.path.join(work, name)
            opt = MaestroOptions(
                metadata_file=os.path.join(work, "inv.bin"),
                scratch_bloom_dir=os.path.join(scratch, "bloom"),
                scratch_database_dir=os.path.join(scratch, "db"),
                status_file=os.path.join(scratch, "status.bin"),
                min_kmer_count=2,
                min_log_2_filter_len=18,
                max_log_2_filter_len=24,
                min_log_2_count_len=18,
                max_log_2_count_len=24,
                # Device mode: the scheduler runs its own two-stage
                # pipeline (1 parse thread + 1 device dispatcher);
                # num_workers only sizes the db-packing pool there.
                num_workers=2 if device_build else WORKERS,
                device_build=device_build,
                device_batch=DEVICE_BATCH,
            )
            if device_build:
                # Warm the jit caches with one same-shaped BATCH build
                # BEFORE the run: the figure should reflect steady state,
                # not the one-time compiles.
                from kwage.core import FilterInfo as _FI
                from kwage.io.sequence import iter_sequences
                from kwage.pipeline.make_bloom import build_blooms_device_batch

                jobs = []
                for a in accs[: opt.device_batch]:
                    seqs = [s for _, s in iter_sequences(os.path.join(src, f"{a}.fasta"))]
                    jobs.append((seqs, _FI()))
                build_blooms_device_batch(jobs, opt.build_options())

            # Device mode reports the best of 3 runs (fresh scratch each)
            # as the steady-state figure. Host mode is single-shot.
            reps = 3 if device_build else 1
            best = None
            for rep in range(reps):
                if rep:
                    shutil.rmtree(scratch, ignore_errors=True)
                    opt.scratch_bloom_dir = os.path.join(scratch, f"bloom{rep}")
                    opt.scratch_database_dir = os.path.join(scratch, f"db{rep}")
                    opt.status_file = os.path.join(scratch, f"status{rep}.bin")
                m = Maestro(opt, LocalFastaResolver(src))
                m.restore()
                t0 = time.perf_counter()
                m.run()
                dt_rep = time.perf_counter() - t0
                ok_rep = sum(1 for s in m.status if s == STATUS_DATABASE_SUCCESS)
                if best is None or ok_rep / dt_rep > best[0] / best[1]:
                    best = (ok_rep, dt_rep)
            ok, dt = best
            print(
                json.dumps(
                    {
                        "metric": f"bloom_filters_built_per_sec_{name}",
                        "device": {
                            "platform": jax.devices()[0].platform,
                            "kind": jax.devices()[0].device_kind,
                            "count": len(jax.devices()),
                        },
                        "value": round(ok / dt, 3),
                        "unit": f"filters/s ({BP} bp each; {WORKERS} workers; end-to-end incl. transpose)",
                        "mbp_per_sec": round(ok * BP / dt / 1e6, 2),
                    }
                )
            )
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
