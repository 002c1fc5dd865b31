"""At-scale proof for the DISTRIBUTED work queue: coordinator + N
subprocess workers over TCP on a production-L corpus.

Generates the same synthetic corpus shape as tools/run_at_scale.py
(solver lands at L>=18), serves it with `maestro --coordinator`, runs
SCALE_WORKERS (default 2) independent `maestro --worker` subprocesses
pulling over TCP, then verifies: every accession terminal, the packed
corpus searches byte-identically to a fresh single-process maestro run
over the same inputs, and (oracle present) byte-identical to the
reference kwage binary.

Usage: python tools/run_at_scale_distributed.py [workdir]
Env: SCALE_N_ACC (default 1000), SCALE_GENOME (20000), SCALE_COV (3),
     SCALE_WORKERS (2).
One JSON line per phase; exit 0 = all checks passed.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# Runnable straight from a checkout, with or without `pip install -e .`.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
# Child processes (python -m kwage.cli.*) need the same: prepend the
# repo root to PYTHONPATH so spawned CLIs import from this checkout too.
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""
)


_RESULTS: list = []


def log(phase, **kw):
    rec = {"phase": phase, **kw}
    print(json.dumps(rec), flush=True)
    _RESULTS.append(rec)
    return rec


def measure_queue_overhead(work, infos, k=300):
    """Per-message queue overhead, measured on the REAL wire protocol: an
    in-process CoordinatorServer over k accessions, driven by a synthetic
    client that answers every task instantly (zero work), timing each
    message round trip (connect + one-line JSON request + locked handler
    + one-line reply). This is the 'o' in the crossover formula
    (README): W workers beat one local worker when task_time t >
    o_task/(W-1); the coordinator serializes at 1/o_coord tasks/s.
    Reference analog: the MPI_Iprobe master loop + MPI_Send task
    messages (maestro_main.cpp:1201-1862) whose per-task cost this
    replaces."""
    import statistics

    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        Maestro,
        MaestroOptions,
        SourceResolver,
        STATUS_BLOOM_SUCCESS,
        STATUS_DATABASE_SUCCESS,
    )
    from kwage.parallel.remote import (
        CoordinatorServer,
        _param_to_dict,
        _send_msg,
    )
    from kwage.core.params import BloomParam

    qdir = os.path.join(work, "qoverhead")
    os.makedirs(qdir, exist_ok=True)
    inv = os.path.join(qdir, "inv.bin")
    write_inventory(inv, infos[:k])
    opt = MaestroOptions(
        metadata_file=inv,
        scratch_bloom_dir=os.path.join(qdir, "bloom"),
        scratch_database_dir=os.path.join(qdir, "db"),
        status_file=os.path.join(qdir, "status.bin"),
        s3_no_write=True,
    )
    m = Maestro(opt, SourceResolver())
    coord = CoordinatorServer(m)
    coord.start()
    addr = coord.address
    param = _param_to_dict(BloomParam(
        kmer_len=32, log_2_filter_len=18, num_hash=5, hash_func=0))
    t_next, t_down, t_done, t_db = [], [], [], []
    eid = 0

    def timed(bucket, msg):
        nonlocal eid
        if "op" in msg and msg["op"] != "next":
            msg = dict(msg, eid=f"probe:{eid}")
            eid += 1
        t0 = time.perf_counter()
        r = _send_msg(addr, msg)
        bucket.append(time.perf_counter() - t0)
        return r

    try:
        while True:
            r = timed(t_next, {"op": "next", "worker": "probe", "n": 1})
            op = r.get("op")
            if op == "quit":
                break
            if op == "wait":
                time.sleep(0.02)
                continue
            if op == "bloom":
                idx = r["idx"]
                timed(t_down, {"op": "downloaded", "idx": idx})
                timed(t_done, {"op": "bloom_done", "idx": idx,
                               "status": STATUS_BLOOM_SUCCESS,
                               "param": param, "dt": 0.0, "mem": 0.0,
                               "worker": "probe"})
            elif op == "db":
                timed(t_db, {"op": "db_done", "db_index": r["db_index"],
                             "members": r["members"],
                             "status": STATUS_DATABASE_SUCCESS,
                             "dt": 0.0, "mem": 0.0, "worker": "probe"})
    finally:
        coord.shutdown()

    def ms(xs):
        return round(statistics.median(xs) * 1e3, 3) if xs else None

    o_next, o_down, o_done = ms(t_next), ms(t_down), ms(t_done)
    # Per-task overhead at pull batch B: one "next" per B tasks, one
    # "downloaded" + one "bloom_done" per task, plus the db_done share
    # (members are packed per quota; amortized per member).
    db_share = (sum(t_db) / k * 1e3) if t_db else 0.0
    o_task_1 = o_next + o_down + o_done + db_share
    o_task_16 = o_next / 16 + o_down + o_done + db_share
    return {
        "tasks_measured": k,
        "next_ms": o_next, "downloaded_ms": o_down,
        "bloom_done_ms": o_done, "db_done_ms": ms(t_db),
        "db_done_amortized_ms": round(db_share, 3),
        "o_task_ms_batch1": round(o_task_1, 3),
        "o_task_ms_batch16": round(o_task_16, 3),
        "coord_ceiling_tasks_per_s": round(1e3 / o_task_16, 1),
    }


def main() -> int:
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory

    n_acc = int(os.environ.get("SCALE_N_ACC", 1000))
    genome = int(os.environ.get("SCALE_GENOME", 20000))
    cov = int(os.environ.get("SCALE_COV", 3))
    n_workers = int(os.environ.get("SCALE_WORKERS", 2))
    work = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="dscale_")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "src")
    os.makedirs(src, exist_ok=True)

    rng = random.Random(20260818)
    t0 = time.time()
    infos = []
    for i in range(n_acc):
        acc = f"SRR{9000000 + i}"
        g = "".join(rng.choice("ACGT") for _ in range(genome))
        with open(os.path.join(src, acc + ".fasta"), "w") as f:
            for r in range(cov):
                a = rng.randrange(0, max(1, genome - 150))
                f.write(f">r{r}\n{g[a:a + 150 * 20]}\n")
        infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                number_of_bases=genome * cov))
    inv = os.path.join(work, "inventory.bin")
    write_inventory(inv, infos)
    log("generate", accessions=n_acc, dt_sec=round(time.time() - t0, 1))

    def maestro_args(scratch, extra):
        # --status is CWD-relative by default (the reference's behavior):
        # pin it per scratch or concurrent/sequential runs share state.
        return [sys.executable, "-m", "kwage.cli.maestro",
                "--meta", inv, "--scratch", scratch,
                "--status", os.path.join(scratch, "status.bin"),
                "--source-dir", src, "--s3.no-write",
                "--min-kmer-count", "1", "--len.min", "16",
                "--len.max", "20"] + extra

    def wait_port(port, deadline=60.0):
        import socket

        t0 = time.time()
        while time.time() - t0 < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                return
            except OSError:
                time.sleep(0.1)
        raise TimeoutError(f"coordinator port {port} never opened")

    # Pre-start every measured process (python + jax imports are ~2.4 s
    # EACH on this one-core box -- serialized spawn cost that real
    # deployments pay in parallel on their own hosts), hold at a READY
    # barrier, then start the clock: both sides are measured from
    # imports-done, so the numbers compare queue mechanics + work, not
    # interpreter startup.
    wrapper = (
        "import sys\n"
        "import kwage.cli.maestro as mm\n"
        "print('READY', flush=True)\n"
        "sys.stdin.readline()\n"
        "sys.exit(mm.main(sys.argv[1:]))\n")

    def start_held(args, env=None):
        p = subprocess.Popen(
            [sys.executable, "-c", wrapper] + args[3:],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, text=True)
        line = p.stdout.readline().strip()
        if line != "READY":
            rc = p.poll()
            err = p.stderr.read() if p.stderr else ""
            raise RuntimeError(
                f"held child failed before READY (rc={rc}, "
                f"first line={line!r}): {err[-4000:]}")
        # A held child that logs >~64 KiB would block on the full pipe
        # until the wait() timeout; drain both pipes in daemon threads
        # for the rest of its life.
        for stream in (p.stdout, p.stderr):
            threading.Thread(
                target=lambda s=stream: [None for _ in s],
                daemon=True).start()
        return p

    def release(p):
        p.stdin.write("\n")
        p.stdin.flush()
        p.stdin.close()

    # Distributed run: coordinator + N subprocess workers over TCP.
    # EVERY process (coordinator included -- it also runs the default
    # local worker pool and would otherwise drain the queue while the
    # held workers import) waits at the READY barrier; the clock starts
    # before the coordinator's release.
    dscratch = os.path.join(work, "dist")
    port = 7941
    coord = start_held(maestro_args(
        dscratch, ["--coordinator", f"127.0.0.1:{port}"]))
    workers = [start_held(maestro_args(dscratch,
                                       ["--worker", f"127.0.0.1:{port}"]))
               for _ in range(n_workers)]
    t0 = time.time()
    release(coord)
    wait_port(port)
    for w in workers:
        release(w)
    rc_coord = coord.wait(timeout=3600)
    rcs = [w.wait(timeout=600) for w in workers]
    dt_dist = time.time() - t0
    # host_cores matters for reading this number: on a 1-core box the
    # coordinator + N workers time-slice one CPU, so the compute-bound
    # zero-latency regime can only LOSE to a single process here; the
    # latency-bound regime below is where dynamic balance pays (and is
    # the reference's actual deployment profile).
    log("distributed_run", workers=n_workers, coordinator_rc=rc_coord,
        worker_rcs=rcs, dt_sec=round(dt_dist, 1),
        filters_per_sec=round(n_acc / dt_dist, 1),
        host_cores=os.cpu_count())
    if rc_coord != 0 or any(r != 0 for r in rcs):
        log("done", ok=False)
        return 1

    # Single-process run over the SAME inputs for the parity baseline.
    sscratch = os.path.join(work, "single")
    sp_run = start_held(maestro_args(sscratch, []))
    t0 = time.time()
    release(sp_run)
    rc = sp_run.wait(timeout=3600)
    dt_single = time.time() - t0
    log("single_run", rc=rc, dt_sec=round(dt_single, 1),
        filters_per_sec=round(n_acc / dt_single, 1))

    # Query set + search helpers (used by the parity phases below AND the
    # crash-recovery phase).
    qf = os.path.join(work, "q.fasta")
    with open(qf, "w") as f:
        for i in range(4):
            acc = f"SRR{9000000 + rng.randrange(n_acc)}"
            with open(os.path.join(src, acc + ".fasta")) as g:
                g.readline()
                seq = g.readline().strip()
            f.write(f">q{i}\n{seq[:200]}\n")

    def search(dbdir):
        out = subprocess.run(
            [sys.executable, "-m", "kwage.cli.kwage", "-d",
             os.path.join(dbdir, "database"), "-t", "0.8", "-i", qf,
             "--o.json"],
            capture_output=True, text=True)
        assert out.returncode == 0, out.stderr
        return out.stdout

    def result_set(text):
        out = set()
        query = None
        for line in text.splitlines():
            ls = line.strip().strip(",")
            if ls.startswith('"query"'):
                query = ls
            elif ls.startswith('"run_accession"') or ls.startswith(
                    '"num_kmers_found"'):
                out.add((query, ls))
        return out

    # -- per-task queue overhead + crossover check ------------------------
    oh = measure_queue_overhead(work, infos)
    log("queue_overhead", **oh)
    # Crossover formula (README): W workers beat ONE local worker when
    # t > o/(W-1); vs the single process's P-thread pool, W workers win
    # when W/(t+o) > P/t. On this 1-core box wall-parallelism is absent,
    # so the checkable prediction for the CPU-bound regime is the
    # SLOWDOWN (t+o)/t: every queue millisecond serializes with work.
    t_task_ms = dt_single / n_acc * 1e3
    o_ms = oh["o_task_ms_batch16"]  # workers pull KWAGE_WORKER_PULL=16
    pred_slowdown = (t_task_ms + o_ms) / t_task_ms
    obs_slowdown = dt_dist / dt_single
    log("crossover_check", regime="cpu_bound_1core",
        t_task_ms=round(t_task_ms, 2), o_task_ms=o_ms,
        predicted_slowdown=round(pred_slowdown, 2),
        observed_slowdown=round(obs_slowdown, 2),
        crossover_task_ms_for_2_workers=round(o_ms / (2 - 1), 2),
        crossover_task_ms_for_8_workers=round(o_ms / (8 - 1), 2))

    # -- worker-crash recovery at scale ------------------------------------
    # Kill one of 2 workers (exact PID) mid-run with --task-timeout set:
    # its pre-marked in-flight tasks must be re-queued by the coordinator
    # (maestro_main.cpp:1404-1408 pre-mark semantics) and the corpus must
    # still complete with every accession terminal.
    if os.environ.get("SCALE_SKIP_CRASH") != "1":
        cscratch = os.path.join(work, "crash")
        cport = port + 2
        ccoord = start_held(maestro_args(
            cscratch, ["--coordinator", f"127.0.0.1:{cport}",
                       "--task-timeout", "5"]))
        cworkers = [start_held(maestro_args(
            cscratch, ["--worker", f"127.0.0.1:{cport}"]))
            for _ in range(2)]
        t0 = time.time()
        release(ccoord)
        wait_port(cport)
        for w in cworkers:
            release(w)
        # Let the victim get real in-flight work, then SIGKILL it.
        time.sleep(max(0.5, dt_dist / 4))
        cworkers[0].kill()
        rc_cc = ccoord.wait(timeout=3600)
        rc_survivor = cworkers[1].wait(timeout=600)
        cworkers[0].wait(timeout=30)
        dt_crash = time.time() - t0
        a_crash = search(cscratch) if rc_cc == 0 else ""
        crash_equal = rc_cc == 0 and result_set(a_crash) == result_set(
            search(sscratch))
        log("crash_recovery", coordinator_rc=rc_cc,
            survivor_rc=rc_survivor, dt_sec=round(dt_crash, 1),
            result_set_equals_single=crash_equal)
        if not crash_equal:
            log("done", ok=False)
            return 1

    # -- latency-bound (download-dominated) regime -----------------------
    # The reference's deployment profile: workers spend most wall time
    # waiting on NCBI, not computing (worker_main.cpp's whole reason to
    # exist). A fake fasterq-dump sleeps SCALE_SIM_DELAY then streams the
    # local reads, so per-accession latency dominates. The single process
    # can overlap at most --workers (4) downloads; the queue fields as
    # many workers as there are hosts -- dynamic balance wins as soon as
    # worker count exceeds the single process's thread pool.
    lat_ratio = None
    if os.environ.get("SCALE_SKIP_LATENCY") != "1":
        lat_n = int(os.environ.get("SCALE_LAT_N", 400))
        lat_delay = float(os.environ.get("SCALE_SIM_DELAY", 0.25))
        lat_workers = int(os.environ.get("SCALE_LAT_WORKERS", 8))
        lat_inv = os.path.join(work, "inventory_lat.bin")
        write_inventory(lat_inv, infos[:lat_n])
        bindir = os.path.join(work, "bin")
        os.makedirs(bindir, exist_ok=True)
        tool = os.path.join(bindir, "fasterq-dump")
        with open(tool, "w") as f:
            f.write(
                "#!/bin/sh\n"
                f"sleep {lat_delay}\n"
                'for last; do :; done\n'
                f'cat "{src}/$last.fasta"\n')
        os.chmod(tool, 0o755)
        env = dict(os.environ)
        env["PATH"] = bindir + os.pathsep + env["PATH"]
        env["KWAGE_NO_VDB"] = "1"
        env["KWAGE_WORKER_PULL"] = "4"  # keep tail balance at high latency

        def lat_args(scratch, extra):
            return [sys.executable, "-m", "kwage.cli.maestro",
                    "--meta", lat_inv, "--scratch", scratch,
                    "--status", os.path.join(scratch, "status.bin"),
                    "--stream", "--s3.no-write",
                    "--min-kmer-count", "1", "--len.min", "16",
                    "--len.max", "20"] + extra

        ls = start_held(lat_args(os.path.join(work, "lat_single"), []),
                        env=env)
        t0 = time.time()
        release(ls)
        rc_ls = ls.wait(timeout=3600)
        dt_ls = time.time() - t0
        log("latency_single_run", rc=rc_ls, dt_sec=round(dt_ls, 1),
            sim_delay=lat_delay, accessions=lat_n,
            filters_per_sec=round(lat_n / dt_ls, 1))

        lscratch = os.path.join(work, "lat_dist")
        # --workers 1 pins the coordinator to (almost) pure scheduling,
        # like the reference's rank-0 master: the win below is the
        # REMOTE workers', not the coordinator's own thread pool's.
        # Held like everything else so its lone local thread cannot
        # pre-drain sleep-bound tasks while the workers import.
        lcoord = start_held(
            lat_args(lscratch, ["--coordinator", f"127.0.0.1:{port + 1}",
                                "--workers", "1"]), env=env)
        lws = [start_held(lat_args(lscratch,
                                   ["--worker", f"127.0.0.1:{port + 1}"]),
                          env=env)
               for _ in range(lat_workers)]
        t0 = time.time()
        release(lcoord)
        wait_port(port + 1)
        for w in lws:
            release(w)
        rc_lc = lcoord.wait(timeout=3600)
        rcs_lw = [w.wait(timeout=600) for w in lws]
        dt_ld = time.time() - t0
        lat_ratio = round(dt_ls / dt_ld, 2)
        log("latency_distributed_run", workers=lat_workers,
            coordinator_rc=rc_lc, worker_rcs=rcs_lw, dt_sec=round(dt_ld, 1),
            filters_per_sec=round(lat_n / dt_ld, 1),
            speedup_vs_single=lat_ratio)
        if rc_lc != 0 or any(r != 0 for r in rcs_lw):
            log("done", ok=False)
            return 1

    # Search both corpora with the same queries. Dynamic pulling packs
    # accessions into .db files in COMPLETION order, so file partitioning
    # (and the file-order tiebreak) differs from the sequential run --
    # exactly as with the reference's dynamic MPI scheduling. The RESULT
    # SET must match; byte order may not.
    a = search(dscratch)
    b = search(sscratch)
    identical = result_set(a) == result_set(b)
    has_hits = "num_kmers_found" in a
    oracle_same = None
    oracle = "/tmp/oracle/kwage"
    if os.path.exists(oracle):
        from kwage.cli.kwage import find_db_files

        dbs = find_db_files([os.path.join(dscratch, "database")])
        dargs = []
        for d in dbs:
            dargs += ["-d", d]
        o = subprocess.run(
            [oracle] + dargs + ["-t", "0.8", "-i", qf, "--o.json"],
            capture_output=True, text=True)
        oracle_same = o.stdout == a
    log("search_parity", distributed_equals_single=identical,
        any_hits=has_hits, byte_identical_to_oracle=oracle_same)
    ok = identical and has_hits and oracle_same is not False
    if lat_ratio is not None:
        ok = ok and lat_ratio >= 1.3
    log("done", ok=ok, latency_speedup=lat_ratio)
    rnd = os.environ.get("KWAGE_ROUND", "04")
    with open(f"DSCALE_r{rnd}.json", "w") as f:
        json.dump(_RESULTS, f, indent=1)
    if sys.argv[1:] == []:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
