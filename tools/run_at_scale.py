"""At-scale end-to-end proof at the reference's production design point.

One continuous maestro job over >=4096 synthetic accessions sized so the
adaptive solver lands at L=18 (the reference's operating band,
options.h:137-157: L in [18,32], 2048 filters/file, 64 GB cap):

  1. run A (--halt-after) packs TWO full 2048-filter .db files plus a
     forced-flush straggler;
  2. run B restarts from the checkpoint (restore rescans the staged
     scratch at scale) and flush-packs the remaining accessions into a
     second partial file;
  3. merge_db consolidates the two partials (sha256-checked against the
     reference merge_db oracle when /tmp/oracle is present);
  4. the merged corpus is searched with the host engine and (when an
     accelerator is present) the device engine, and both outputs are
     compared byte-for-byte against the reference kwage binary.

One process holds the accelerator: the device build and the device
search run in this process (the kwage CLI is called in-process), since a
second JAX process on the same card would find its memory taken.

Prints one JSON line per phase and writes results/ATSCALE.json under the
checkout. Env knobs:
  SCALE_N_ACC   total accessions        (default 4350; >= 4096)
  SCALE_HALT    run-A cursor cap        (default 4200)
  SCALE_GENOME  genome bp per accession (default 28000 -> ~25k valid
                31-mers -> BloomParam (L=18, h=5) for every accession)
  SCALE_COV     read coverage           (default 4)
  SCALE_DEVICE  "0" to skip the device phases (default: run them when
                JAX finds an accelerator)
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Runnable straight from a checkout, with or without `pip install -e .`.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
# Child processes (python -m kwage.cli.*) need the same: prepend the
# repo root to PYTHONPATH so spawned CLIs import from this checkout too.
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""
)

from results import write_results  # noqa: E402

N_ACC = int(os.environ.get("SCALE_N_ACC", "4350"))
HALT = int(os.environ.get("SCALE_HALT", "4200"))
GENOME = int(os.environ.get("SCALE_GENOME", "28000"))
COV = int(os.environ.get("SCALE_COV", "4"))
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


def _use_device() -> bool:
    """Device phases run unless SCALE_DEVICE=0, and only on an
    accelerator (the CPU backend is no measurement of one)."""
    if os.environ.get("SCALE_DEVICE") == "0":
        return False
    import jax

    from kwage.utils.runtime import enable_compile_cache

    if jax.default_backend() == "cpu":
        return False
    enable_compile_cache()
    return True


def kwage_in_process(argv: list[str], work: str) -> str:
    """Run the kwage CLI in this process (which may hold the accelerator)
    and return what it wrote."""
    from kwage.cli.kwage import main as kwage_main

    out = os.path.join(work, "kwage_out.txt")
    rc = kwage_main([*argv, "-o", out])
    assert rc == 0, f"kwage {argv} exited {rc}"
    with open(out) as f:
        return f.read()


def main() -> int:
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    results = []
    work = tempfile.mkdtemp(prefix="kwage_scale.")
    try:
        # -- corpus generation ------------------------------------------
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        src = os.path.join(work, "fa")
        os.makedirs(src)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        accs = [f"SRR9{i:06d}" for i in range(N_ACC)]
        n_reads = GENOME * COV // READ_LEN
        infos = []
        query_seqs: list[tuple[str, str]] = []
        for ai, acc in enumerate(accs):
            genome = lut[rng.integers(0, 4, size=GENOME, dtype=np.uint8)]
            starts = rng.integers(0, GENOME - READ_LEN + 1, size=n_reads)
            parts = []
            for r, st in enumerate(starts):
                parts.append(b">r%d\n" % r)
                parts.append(genome[st : st + READ_LEN].tobytes())
                parts.append(b"\n")
            with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
                f.write(b"".join(parts))
            infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                    number_of_bases=n_reads * READ_LEN))
            # Queries: a genome slice from a spread of accessions (file 1,
            # file 2, and both stragglers).
            if ai in (5, 2500, 4150, N_ACC - 5):
                query_seqs.append((acc, genome[1000:1000 + 400].tobytes().decode()))
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        results.append(log(
            "generate", accessions=N_ACC, bp_per_acc=n_reads * READ_LEN,
            total_mbp=round(N_ACC * n_reads * READ_LEN / 1e6, 1),
            dt_sec=round(time.perf_counter() - t0, 1)))

        # -- maestro runs A (halted) + B (restart) ----------------------
        opt = MaestroOptions(
            metadata_file=inv,
            scratch_bloom_dir=os.path.join(work, "bloom"),
            scratch_database_dir=os.path.join(work, "db"),
            status_file=os.path.join(work, "status.bin"),
            min_kmer_count=2,
            kmer_len=K,
            num_workers=2,
            lazy_inventory=True,
            limit_num_download=HALT,
        )
        t0 = time.perf_counter()
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        dt_a = time.perf_counter() - t0
        n_a = int((m.status == STATUS_DATABASE_SUCCESS).sum())
        results.append(log(
            "maestro_run_A", committed=n_a, dt_sec=round(dt_a, 1),
            filters_per_sec=round(n_a / dt_a, 1),
            db_files=sorted(os.listdir(opt.scratch_database_dir))))

        opt.limit_num_download = 0
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
            dt_sec=round(dt_b, 1),
            filters_per_sec=round((n_b - n_a) / dt_b, 1),
            db_files=db_files))

        # -- device-build at scale (same corpus prefix, fresh scratch) --
        # Two passes: the cold one pays the XLA compiles; the warm one,
        # same shapes in the same process, is the steady-state number —
        # the operating point of a long-running build service.
        use_device = _use_device()
        if use_device:
            n_dev = min(int(os.environ.get("SCALE_DEVICE_N", "1024")), N_ACC)
            for label in ("cold", "warm"):
                dopt = MaestroOptions(
                    metadata_file=inv,
                    scratch_bloom_dir=os.path.join(work, f"dbloom_{label}"),
                    scratch_database_dir=os.path.join(work, f"ddb_{label}"),
                    status_file=os.path.join(work, f"dstatus_{label}.bin"),
                    min_kmer_count=2,
                    kmer_len=K,
                    num_workers=2,
                    lazy_inventory=True,
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
                    filters_per_sec=round(n_d / dt_d, 1)))

        # Shape proof: >= 2 full 2048-filter files + >= 2 partials.
        from kwage.io.dbz_file import open_database

        sizes = {}
        for f in db_files:
            h = open_database(os.path.join(opt.scratch_database_dir, f)).header
            sizes[f] = (h.num_filter, h.log_2_filter_len)
        full = [f for f, (n, L) in sizes.items() if n == 2048 and L == 18]
        partial = [f for f, (n, L) in sizes.items() if n < 2048]
        require_full = int(os.environ.get("SCALE_REQUIRE_FULL", "2"))
        assert len(full) >= require_full, sizes
        assert len(partial) >= 2, sizes
        results.append(log("shape_check", files={f: list(v) for f, v in sizes.items()}))

        # -- merge_db the partials (in place, reference semantics) ------
        from kwage.pipeline.merge_db import merge_databases

        t0 = time.perf_counter()
        corpus = os.path.join(work, "corpus")
        os.makedirs(corpus)
        for f in full:
            shutil.copy(os.path.join(opt.scratch_database_dir, f),
                        os.path.join(corpus, f))
        ppaths = []
        for f in partial:
            dst = os.path.join(corpus, f)
            shutil.copy(os.path.join(opt.scratch_database_dir, f), dst)
            ppaths.append(dst)
        merge_databases(ppaths, verbose=False)
        remaining = [p for p in ppaths if os.path.exists(p)]
        assert len(remaining) == 1, remaining
        merged = remaining[0]
        oracle_ok = None
        if os.path.isfile(os.path.join(ORACLE, "merge_db")):
            import hashlib

            odir = os.path.join(work, "omerge")
            os.makedirs(odir)
            opaths = []
            for f in partial:
                dst = os.path.join(odir, f)
                shutil.copy(os.path.join(opt.scratch_database_dir, f), dst)
                opaths.append(dst)
            proc = subprocess.run(
                [os.path.join(ORACLE, "merge_db"), *opaths],
                capture_output=True, text=True)
            osurv = [p for p in opaths if os.path.exists(p)]
            if proc.returncode == 0 and len(osurv) == 1:
                osha = hashlib.sha256(open(osurv[0], "rb").read()).hexdigest()
                msha = hashlib.sha256(open(merged, "rb").read()).hexdigest()
                oracle_ok = osha == msha
        nm = open_database(merged).header.num_filter
        results.append(log(
            "merge_partials", merged_filters=nm,
            oracle_sha_identical=oracle_ok,
            dt_sec=round(time.perf_counter() - t0, 1)))

        # -- search the merged corpus: host vs oracle vs device ---------
        qfasta = os.path.join(work, "queries.fasta")
        with open(qfasta, "w") as f:
            for acc, q in query_seqs:
                f.write(f">{acc}\n{q}\n")

        def run_kwage(cmd: list[str]) -> str:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=1800)
            assert proc.returncode == 0, proc.stderr
            return proc.stdout

        t0 = time.perf_counter()
        host_out = run_kwage([sys.executable, "-m", "kwage.cli.kwage",
                              "-d", corpus, "-t", "0.8", "-i", qfasta])
        dt_host = time.perf_counter() - t0
        oracle_same = None
        if os.path.isfile(os.path.join(ORACLE, "kwage")):
            t0 = time.perf_counter()
            oracle_out = run_kwage([os.path.join(ORACLE, "kwage"), "-d",
                                    corpus, "-t", "0.8", "-i", qfasta])
            dt_oracle = time.perf_counter() - t0
            oracle_same = host_out == oracle_out
        else:
            dt_oracle = None
        results.append(log(
            "search_host", queries=len(query_seqs),
            dt_sec=round(dt_host, 2),
            oracle_dt_sec=round(dt_oracle, 2) if dt_oracle else None,
            byte_identical_to_oracle=oracle_same))

        dev_same = None
        if use_device:
            t0 = time.perf_counter()
            dev_out = kwage_in_process(
                ["-d", corpus, "-t", "0.8", "-i", qfasta, "--device"], work)
            dev_same = dev_out == host_out
            results.append(log(
                "search_device", dt_sec=round(time.perf_counter() - t0, 2),
                byte_identical_to_host=dev_same))
            # Steady-state: resident searcher answers repeat queries with
            # the matrices already on device and the kernels compiled --
            # the serving operating point (the CLI number above includes
            # the load, the upload and the compiles).
            from kwage.cli.kwage import find_db_files
            from kwage.io.sequence import iter_sequences
            from kwage.search.resident import ResidentSearcher

            queries = [s for _, s in iter_sequences(qfasta)]
            searcher = ResidentSearcher(find_db_files([corpus]))
            t0 = time.perf_counter()
            first = searcher.render(queries, 0.8)
            dt_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            second = searcher.render(queries, 0.8)
            dt_warm = time.perf_counter() - t0
            results.append(log(
                "search_device_resident",
                first_query_sec=round(dt_first, 2),
                warm_query_sec=round(dt_warm, 3),
                byte_identical=(first == second)))

        ok = (oracle_same is not False) and (oracle_ok is not False) and (
            dev_same is not False)
        results.append(log("done", ok=ok))
        write_results("ATSCALE.json", results)
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
