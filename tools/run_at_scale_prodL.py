"""Production filter-length (L>=26) at-scale proof (VERDICT r04 task 1).

The reference's production operating point is L up to 32: counting
stages at 2^32 bits (make_bloom.cpp:103-129), multi-GiB .db files under
the quota min(2048, 64GiB*8/2^L) (options.h:137-138,
maestro_main.cpp:87-106), and the 1 GiB transpose tiling that exists
for that scale (build_db.cpp:236-248). Every prior at-scale artifact
was L=18. This tool runs ONE continuous maestro job with the filter
length pinned to L=26 (--len.min = --len.max = 26, a legitimate
production configuration; the solver otherwise needs ~6.4M distinct
k-mers per accession to land there):

  - a full quota file is 2048 filters x 8 MB = 16 GiB (SCALE_L=28 gives
    64 GiB, past one card's memory, so the device path's wave streaming
    is forced by real memory pressure);
  - run A (--halt-after) packs the full 2048-filter file plus a
    forced-flush partial; run B restarts from the checkpoint and packs
    the remainder into a second partial;
  - merge_db consolidates the partials (sha-checked against the
    reference merge_db binary);
  - the corpus searches byte-identically to the reference kwage binary
    (host engine); on an accelerator, the device engine must match the
    host byte-for-byte and the ShardedDatabase wave plan is recorded
    (wave count, bytes/wave, memory budget actually used).

The run moves ~30 GB of .bloom + .db traffic, so it is bound by the
disk. The device phases run in this process (the kwage CLI is called
in-process): one JAX process per card. Env knobs:
  SCALE_N_ACC (default 2268)  SCALE_HALT (default 2100)
  SCALE_GENOME (default 30000)  SCALE_L (default 26)
  SCALE_DEVICE ("0" skips the device phases; default: run them when JAX
                finds an accelerator)
  SCALE_KEEP ("1" keep the workdir)
Writes results/ATSCALE_PRODL.json under the checkout; one JSON line per
phase.
"""

from __future__ import annotations

import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"]
    if os.environ.get("PYTHONPATH") else "")

from results import write_results  # noqa: E402
from run_at_scale import _use_device, kwage_in_process  # noqa: E402

N_ACC = int(os.environ.get("SCALE_N_ACC", "2268"))
HALT = int(os.environ.get("SCALE_HALT", "2100"))
GENOME = int(os.environ.get("SCALE_GENOME", "30000"))
LPROD = int(os.environ.get("SCALE_L", "26"))
COV = 4
READ_LEN = 160
K = 31
ORACLE = "/tmp/oracle"


def _rss_mb() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rc = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (ru.ru_maxrss + rc.ru_maxrss) / 1024.0


def log(phase: str, **kw) -> dict:
    rec = {"phase": phase, **kw, "peak_rss_mb": round(_rss_mb(), 1)}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    from kwage.core import FilterInfo, str_to_accession
    from kwage.core.params import filters_per_file_quota
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    results = []
    if len(sys.argv) > 1:
        work = sys.argv[1]
        os.makedirs(work, exist_ok=True)
    else:
        work = tempfile.mkdtemp(prefix="kwage_prodL.")
    try:
        # -- corpus --------------------------------------------------------
        t0 = time.perf_counter()
        rng = np.random.default_rng(1)
        src = os.path.join(work, "fa")
        os.makedirs(src)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        accs = [f"SRR8{i:06d}" for i in range(N_ACC)]
        n_reads = GENOME * COV // READ_LEN
        infos = []
        query_seqs: list[tuple[str, str]] = []
        for ai, acc in enumerate(accs):
            genome = lut[rng.integers(0, 4, size=GENOME, dtype=np.uint8)]
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
            if ai in (7, 1024, HALT + 10, N_ACC - 3):
                query_seqs.append(
                    (acc, genome[1000:1400].tobytes().decode()))
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        results.append(log(
            "generate", accessions=N_ACC, L=LPROD,
            filter_mb=round((1 << LPROD) / 8e6, 1),
            full_file_gib=round(2048 * (1 << LPROD) / 8 / 2**30, 1),
            dt_sec=round(time.perf_counter() - t0, 1)))

        # Quota formula proof at production lengths
        # (options.h:137-138: min(2048, 64GiB*8/2^L)).
        results.append(log("quota_check", quotas={
            str(L): filters_per_file_quota(L) for L in range(24, 33)}))
        assert filters_per_file_quota(26) == 2048
        assert filters_per_file_quota(29) == 1024
        assert filters_per_file_quota(32) == 128

        def mk_opt(**kw):
            base = dict(
                metadata_file=inv,
                scratch_bloom_dir=os.path.join(work, "bloom"),
                scratch_database_dir=os.path.join(work, "db"),
                status_file=os.path.join(work, "status.bin"),
                min_kmer_count=2,
                kmer_len=K,
                num_workers=2,
                lazy_inventory=True,
                min_log_2_filter_len=LPROD,
                max_log_2_filter_len=LPROD,
            )
            base.update(kw)
            return MaestroOptions(**base)

        # -- maestro run A (halted) + B (restart) --------------------------
        opt = mk_opt(limit_num_download=HALT)
        t0 = time.perf_counter()
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        dt_a = time.perf_counter() - t0
        n_a = int((m.status == STATUS_DATABASE_SUCCESS).sum())
        results.append(log(
            "maestro_run_A", committed=n_a, dt_sec=round(dt_a, 1),
            filters_per_sec=round(n_a / dt_a, 2),
            db_files=sorted(os.listdir(opt.scratch_database_dir))))

        opt = mk_opt(limit_num_download=0)
        t0 = time.perf_counter()
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        dt_b = time.perf_counter() - t0
        n_b = int((m.status == STATUS_DATABASE_SUCCESS).sum())
        assert n_b == N_ACC, m.summary()
        db_files = sorted(os.listdir(opt.scratch_database_dir))
        results.append(log(
            "maestro_run_B_restart", committed=n_b - n_a,
            dt_sec=round(dt_b, 1), db_files=db_files))

        # -- shape proof: one full 2048 x 2^26 file + >= 2 partials --------
        from kwage.io.dbz_file import open_database

        sizes = {}
        for f in db_files:
            h = open_database(
                os.path.join(opt.scratch_database_dir, f)).header
            sizes[f] = (h.num_filter, h.log_2_filter_len)
        quota = filters_per_file_quota(LPROD)
        full = [f for f, (n, L) in sizes.items()
                if n == quota and L == LPROD]
        partial = [f for f, (n, L) in sizes.items() if n < quota]
        require_full = int(os.environ.get("SCALE_REQUIRE_FULL", "1"))
        assert len(full) >= require_full, sizes
        assert len(partial) >= 2, sizes
        assert all(L == LPROD for _, L in sizes.values()), sizes
        full_bytes = (os.path.getsize(
            os.path.join(opt.scratch_database_dir, full[0]))
            if full else None)
        results.append(log(
            "shape_check", files={f: list(v) for f, v in sizes.items()},
            full_file_bytes=full_bytes))

        # -- merge the partials (oracle sha cross-check) -------------------
        from kwage.pipeline.merge_db import merge_databases

        oracle_ok = None
        if os.path.isfile(os.path.join(ORACLE, "merge_db")):
            odir = os.path.join(work, "omerge")
            os.makedirs(odir)
            opaths = []
            for f in partial:
                dst = os.path.join(odir, f)
                shutil.copy(os.path.join(opt.scratch_database_dir, f), dst)
                opaths.append(dst)
        t0 = time.perf_counter()
        ppaths = [os.path.join(opt.scratch_database_dir, f)
                  for f in partial]
        merge_databases(ppaths, verbose=False)
        remaining = [p for p in ppaths if os.path.exists(p)]
        assert len(remaining) == 1, remaining
        merged = remaining[0]
        dt_merge = time.perf_counter() - t0
        if os.path.isfile(os.path.join(ORACLE, "merge_db")):
            proc = subprocess.run(
                [os.path.join(ORACLE, "merge_db"), *opaths],
                capture_output=True, text=True)
            osurv = [p for p in opaths if os.path.exists(p)]
            if proc.returncode == 0 and len(osurv) == 1:
                osha = hashlib.sha256(
                    open(osurv[0], "rb").read()).hexdigest()
                msha = hashlib.sha256(
                    open(merged, "rb").read()).hexdigest()
                oracle_ok = osha == msha
            shutil.rmtree(odir, ignore_errors=True)
        nm = open_database(merged).header.num_filter
        results.append(log(
            "merge_partials", merged_filters=nm,
            oracle_sha_identical=oracle_ok,
            dt_sec=round(dt_merge, 1)))

        # -- host search vs the reference binary ---------------------------
        corpus = opt.scratch_database_dir
        qfasta = os.path.join(work, "queries.fasta")
        with open(qfasta, "w") as f:
            for acc, q in query_seqs:
                f.write(f">{acc}\n{q}\n")

        def run_kwage(cmd: list[str]) -> str:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=7200)
            assert proc.returncode == 0, proc.stderr[-3000:]
            return proc.stdout

        t0 = time.perf_counter()
        host_out = run_kwage([sys.executable, "-m", "kwage.cli.kwage",
                              "-d", corpus, "-t", "0.8", "-i", qfasta])
        dt_host = time.perf_counter() - t0
        oracle_same = None
        dt_oracle = None
        if os.path.isfile(os.path.join(ORACLE, "kwage")):
            t0 = time.perf_counter()
            oracle_out = run_kwage([os.path.join(ORACLE, "kwage"), "-d",
                                    corpus, "-t", "0.8", "-i", qfasta])
            dt_oracle = time.perf_counter() - t0
            oracle_same = host_out == oracle_out
        results.append(log(
            "search_host", queries=len(query_seqs),
            dt_sec=round(dt_host, 2),
            oracle_dt_sec=round(dt_oracle, 2) if dt_oracle else None,
            byte_identical_to_oracle=oracle_same,
            any_hits='"run"' in host_out))

        # -- device phases ------------------------------------------------
        use_device = _use_device()
        dev_same = wave_same = None
        if use_device:
            # CLI device search: byte parity vs the host engine; a corpus
            # over the device budget streams in chunks.
            t0 = time.perf_counter()
            dev_out = kwage_in_process(
                ["-d", corpus, "-t", "0.8", "-i", qfasta, "--device"], work)
            dev_same = dev_out == host_out
            results.append(log(
                "search_device",
                dt_sec=round(time.perf_counter() - t0, 2),
                byte_identical_to_host=dev_same))

            # Wave plan under the device's own budget: ShardedDatabase
            # over every .db in the corpus.
            wave_rec = _wave_proof(corpus, qfasta)
            wave_same = wave_rec["hit_lists_equal_host"]
            results.append(log("sharded_wave_search", **wave_rec))

            # Device build at production L (cold = the XLA compiles;
            # warm = steady state).
            n_dev = min(int(os.environ.get("SCALE_DEVICE_N", "256")),
                        N_ACC)
            for label in ("cold", "warm"):
                dopt = mk_opt(
                    scratch_bloom_dir=os.path.join(work, f"dbl_{label}"),
                    scratch_database_dir=os.path.join(work, f"ddb_{label}"),
                    status_file=os.path.join(work, f"dst_{label}.bin"),
                    limit_num_download=n_dev,
                    device_build=True,
                )
                t0 = time.perf_counter()
                dm = Maestro(dopt, LocalFastaResolver(src))
                dm.restore()
                dm.run()
                dt_d = time.perf_counter() - t0
                n_d = int((dm.status == STATUS_DATABASE_SUCCESS).sum())
                results.append(log(
                    f"maestro_device_build_{label}", committed=n_d,
                    dt_sec=round(dt_d, 1),
                    filters_per_sec=round(n_d / dt_d, 2)))
                shutil.rmtree(dopt.scratch_bloom_dir, ignore_errors=True)
                shutil.rmtree(dopt.scratch_database_dir,
                              ignore_errors=True)

        ok = all(x is not False for x in
                 (oracle_same, oracle_ok, dev_same, wave_same))
        results.append(log("done", ok=ok, device_included=use_device))
        write_results("ATSCALE_PRODL.json", results)
        return 0 if ok else 1
    finally:
        if os.environ.get("SCALE_KEEP") != "1" and len(sys.argv) <= 1:
            shutil.rmtree(work, ignore_errors=True)


def _wave_proof(corpus: str, qfasta: str) -> dict:
    """ShardedDatabase groups over the full corpus with the device's
    own budget (not a synthetic test budget): record the wave plan and
    verify the hit lists equal the host engine's on the same queries."""
    import jax

    from kwage.cli.kwage import find_db_files
    from kwage.io.sequence import iter_sequences
    from kwage.parallel.mesh import make_search_mesh
    from kwage.parallel.sharded_search import (
        build_sharded_groups,
        search_sharded_groups,
    )
    from kwage.search.engine import search_database_files
    from kwage.utils.runtime import fusion_budget_bytes

    mesh = make_search_mesh()
    bytes_limit = int(jax.devices()[0].memory_stats()["bytes_limit"])
    budget = fusion_budget_bytes()
    paths = find_db_files([corpus])
    queries = [(i, s) for i, (_, s) in enumerate(iter_sequences(qfasta))]
    threshold = 0.8

    t0 = time.perf_counter()
    groups = build_sharded_groups(mesh, paths, budget_bytes=budget)
    dt_load = time.perf_counter() - t0
    wave_bytes = [int(w.nbytes) for sdb, _ in groups
                  for w, _ in getattr(sdb, "_waves", [])]
    n_waves = len(wave_bytes)

    t0 = time.perf_counter()
    dev_res = search_sharded_groups(groups, paths, queries, threshold)
    dt_search = time.perf_counter() - t0
    host_res = search_database_files(paths, queries, threshold)

    def canon(res):
        return {
            qid: [(m.num_kmers_found, m.num_query_kmer,
                   m.subject_info.run_accession) for m in lst]
            for qid, lst in res.items() if lst
        }

    return {
        "device_bytes_limit": bytes_limit,
        "budget_bytes": budget,
        "fused_matrix_bytes": int(sum(wave_bytes)),
        "n_groups": len(groups),
        "n_waves": n_waves,
        "bytes_per_wave": wave_bytes,
        "forced_by_memory_pressure": sum(wave_bytes) > budget,
        "load_plus_upload_sec": round(dt_load, 1),
        "search_sec": round(dt_search, 1),
        "hit_lists_equal_host": canon(dev_res) == canon(host_res),
    }


if __name__ == "__main__":
    sys.exit(main())
