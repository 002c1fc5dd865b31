"""Resident-search THROUGHPUT at serving scale (VERDICT r04 task 4).

ATSCALE_r04 recorded only a 35 ms warm latency for 4 queries; the
serving claim's actual workload is hundreds of queries per batch. This
tool builds an ATSCALE-shaped corpus (SCALE_N_ACC filters at L=18, the
reference's operating band, packed into 2048-filter .db files by
maestro), loads it into ResidentSearcher once, and drives >=512-query
batches (mixed 100-400 bp lengths) at BOTH thresholds:

  - warm queries/s for the complete-match (t=1.0) and counting (t=0.8)
    paths, median of 5 batch repeats after a warm-up pass;
  - rendered output byte-identical to the host engine on the same batch
    (the serving parity contract).

Writes results/RESIDENT.json. Env: SCALE_N_ACC (default 4350),
RESIDENT_NQ (default 512), SCALE_GENOME (default 28000).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"]
    if os.environ.get("PYTHONPATH") else "")

import numpy as np
from results import write_results  # noqa: E402

N_ACC = int(os.environ.get("SCALE_N_ACC", "4350"))
NQ = int(os.environ.get("RESIDENT_NQ", "512"))
GENOME = int(os.environ.get("SCALE_GENOME", "28000"))
COV = 4
READ_LEN = 160
K = 31


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)
    return {"phase": phase, **kw}


def main() -> int:
    from kwage.utils.runtime import enable_compile_cache, require_accelerator

    require_accelerator("bench_resident.py")
    enable_compile_cache()
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    results = []
    work = tempfile.mkdtemp(prefix="kwage_resident.")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        src = os.path.join(work, "fa")
        os.makedirs(src)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        n_reads = GENOME * COV // READ_LEN
        infos = []
        genomes = []
        for i in range(N_ACC):
            acc = f"SRR7{i:06d}"
            genome = lut[rng.integers(0, 4, size=GENOME, dtype=np.uint8)]
            if i % 8 == 0:
                genomes.append(genome)
            starts = rng.integers(0, GENOME - READ_LEN + 1, size=n_reads)
            parts = []
            for r, st in enumerate(starts):
                parts.append(b">r%d\n" % r)
                parts.append(genome[st:st + READ_LEN].tobytes())
                parts.append(b"\n")
            with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
                f.write(b"".join(parts))
            infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                    number_of_bases=n_reads * READ_LEN))
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        results.append(log("generate", accessions=N_ACC,
                           dt_sec=round(time.perf_counter() - t0, 1)))

        opt = MaestroOptions(
            metadata_file=inv,
            scratch_bloom_dir=os.path.join(work, "bloom"),
            scratch_database_dir=os.path.join(work, "db"),
            status_file=os.path.join(work, "status.bin"),
            min_kmer_count=2, kmer_len=K, num_workers=2,
            lazy_inventory=True,
        )
        t0 = time.perf_counter()
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        n_built = int((m.status == STATUS_DATABASE_SUCCESS).sum())
        assert n_built == N_ACC, m.summary()
        results.append(log("build", filters=n_built,
                           dt_sec=round(time.perf_counter() - t0, 1)))

        # Mixed-length query batch: 100-400 bp slices of known genomes
        # (hit-bearing) plus 25% random (miss-heavy).
        queries = []
        for i in range(NQ):
            ln = int(rng.choice([100, 150, 200, 300, 400]))
            if i % 4 == 3:
                queries.append(
                    lut[rng.integers(0, 4, size=ln)].tobytes().decode())
            else:
                g = genomes[int(rng.integers(0, len(genomes)))]
                st = int(rng.integers(0, len(g) - ln))
                queries.append(g[st:st + ln].tobytes().decode())

        from kwage.cli.kwage import find_db_files
        from kwage.search.resident import (
            HostResidentSearcher,
            ResidentSearcher,
        )

        paths = find_db_files([opt.scratch_database_dir])
        t0 = time.perf_counter()
        searcher = ResidentSearcher(paths)
        dt_load = time.perf_counter() - t0

        host = HostResidentSearcher(paths)
        row = {"db_files": len(paths), "load_sec": round(dt_load, 1),
               "batch_queries": NQ}
        for name, thr in (("complete", 1.0), ("counting", 0.8)):
            out = searcher.render(queries, thr)      # compile + warm
            t_samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                out2 = searcher.render(queries, thr)
                t_samples.append(time.perf_counter() - t0)
            assert out2 == out
            dt = sorted(t_samples)[2]
            host_out = host.render(queries, thr)
            row[name] = {
                "warm_batch_sec": round(dt, 3),
                "queries_per_s": round(NQ / dt, 1),
                "ms_per_query": round(dt / NQ * 1e3, 3),
                "byte_identical_to_host": out == host_out,
                "spread_s": [round(t, 3) for t in sorted(t_samples)],
            }
        results.append(log("resident_batch", **row))

        ok = all(row[n]["byte_identical_to_host"]
                 for n in ("complete", "counting"))
        results.append(log("done", ok=ok))
        write_results("RESIDENT.json", results)
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
