"""Dynamic cross-host work distribution for maestro (DCN work queue).

The reference's rank-0 master hands each task to whichever MPI rank
frees up (maestro_main.cpp:339-457 event loop; workers block in
MPI_Probe, worker_main.cpp:27-112). The equivalent here keeps the
queue host-side and boring (SURVEY §5.8): a CoordinatorServer wraps the
SAME Maestro state machine (status bytes, retry deques, per-shape
quotas, forced flush, atomic checkpoints) and serves tasks over TCP to
RemoteWorker pull loops on other hosts. A slow accession occupies one
worker while every other host keeps pulling -- the dynamic balance the
static shard_inventory partition lacks.

Assumptions match the reference's: scratch directories live on shared
storage (the reference requires a 2-3 TB Lustre/FSX scratch shared by
all ranks, README.md:217), so any worker can read any .bloom when
packing a database file.

Wire protocol: one JSON line per connection, one reply line back.
  worker -> {"op": "next", "worker": name, "n": max_tasks}
  coord  -> {"op": "bloom", "idx": i, "accession": a, "phase": p}
          | {"op": "bloom_batch", "items": [{idx, accession, phase}, ...]}
          | {"op": "db", "db_index": n, "param": {...}, "members": [...],
             "accessions": [...]}
          | {"op": "wait"} | {"op": "quit"}
  worker -> {"op": "downloaded", "idx": i, "eid": id}       (interim event)
  worker -> {"op": "bloom_done", "idx": i, "status": s, "param": {...}|null,
             "dt": t, "mem": f, "worker": name, "eid": id}
  worker -> {"op": "db_done", "db_index": n, "members": [...], "status": s,
             "dt": t, "mem": f, "worker": name, "eid": id}

Fault model: like the reference, a vanished worker stalls its pre-marked
task until the job restarts (the status byte was pre-marked at dispatch,
maestro_main.cpp:1404-1408, so a restart retries it); an optional
``task_timeout`` re-queues overdue tasks instead (engine extension).
Event delivery is at-least-once: workers buffer undelivered completion
events locally and retry/reconnect (a transient coordinator outage never
kills a worker mid-task), and the coordinator dedupes replays by the
per-worker event id ``eid`` (a delivered event whose REPLY was lost gets
resent, and must not double-apply)."""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time

from ..core.params import BloomParam
from ..utils.mem_usage import memory_usage
from .maestro import (
    STATUS_BLOOM_FAIL_1,
    STATUS_BLOOM_FAIL_10,
    STATUS_BLOOM_SUCCESS,
    STATUS_DATABASE_FAIL,
    STATUS_DOWNLOAD_SUCCESS,
    Maestro,
    MaestroOptions,
    SourceResolver,
    execute_bloom_task,
)


def _param_to_dict(p: BloomParam) -> dict:
    return {
        "kmer_len": p.kmer_len,
        "log_2_filter_len": p.log_2_filter_len,
        "num_hash": p.num_hash,
        "hash_func": p.hash_func,
    }


def _param_from_dict(d: dict) -> BloomParam:
    return BloomParam(
        kmer_len=d["kmer_len"],
        log_2_filter_len=d["log_2_filter_len"],
        num_hash=d["num_hash"],
        hash_func=d["hash_func"],
    )


class QueueAuthError(RuntimeError):
    """The coordinator refused a message for a bad/missing shared-secret
    token (KWAGE_QUEUE_SECRET mismatch) -- a configuration error."""


def _send_msg(address: tuple[str, int], msg: dict, timeout: float = 30.0) -> dict:
    with socket.create_connection(address, timeout=timeout) as sock:
        f = sock.makefile("rw", encoding="utf-8")
        f.write(json.dumps(msg) + "\n")
        f.flush()
        line = f.readline()
    return json.loads(line) if line.strip() else {}


class CoordinatorServer:
    """Rank-0 scheduler: the Maestro state machine served over TCP.

    Dispatch decisions run under one lock inside pull requests (the
    reference's MPI_Iprobe loop inverted into request/response); the
    priorities are identical: database packing first, then restored
    downloads, retries, fresh work (maestro_main.cpp:404-456).
    """

    def __init__(self, maestro: Maestro, host: str = "127.0.0.1", port: int = 0,
                 task_timeout: float | None = None, secret: str | None = None):
        # Default is unauthenticated on loopback (like the reference's MPI
        # world); binding a routable address is an explicit choice. With a
        # shared secret (argument or KWAGE_QUEUE_SECRET env), every message
        # must carry a matching "token" field or is refused -- cheap
        # tampering protection for trusted-but-shared networks.
        from ..utils.runtime import resolve_secret

        self._secret = resolve_secret(secret)
        self.m = maestro
        self.task_timeout = task_timeout
        self._lock = threading.Lock()
        self._in_flight_bloom: dict[int, float] = {}         # idx -> dispatch time
        self._in_flight_db: dict[int, tuple[list[int], float]] = {}
        self._db_members_in_flight: set[int] = set()
        # Replay dedupe: event ids already applied (bounded FIFO). A
        # worker whose send was processed but whose REPLY line was lost
        # resends the same eid; applying it twice would double-count
        # throughput and double-queue retries.
        from collections import OrderedDict

        self._seen_eids: OrderedDict[str, None] = OrderedDict()
        # Ready db groups popped from the maestro's event-driven map,
        # awaiting a pulling worker (one served per "next" request).
        from collections import deque

        self._pending_db: deque = deque()
        self._done = threading.Event()
        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                from ..utils.runtime import check_token

                line = self.rfile.readline().decode("utf-8")
                if not line.strip():
                    return
                msg = json.loads(line)
                if not check_token(msg, coord._secret):
                    reply = {"op": "denied", "error": "bad or missing token"}
                else:
                    reply = coord._handle(msg)
                self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    # -- scheduling under the lock ----------------------------------------

    def _is_replay(self, msg: dict) -> bool:
        eid = msg.get("eid")
        return eid is not None and eid in self._seen_eids

    def _mark_seen(self, msg: dict) -> None:
        # Called only AFTER the event applied cleanly: if the apply
        # raises, the worker's retry of the same eid must NOT be
        # classified as a replay (that would drop the completion).
        eid = msg.get("eid")
        if eid is None:
            return
        self._seen_eids[eid] = None
        if len(self._seen_eids) > 8192:
            self._seen_eids.popitem(last=False)

    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        with self._lock:
            if op == "next":
                return self._next_task(max(int(msg.get("n", 1)), 1))
            if op in ("downloaded", "bloom_done", "db_done") and self._is_replay(msg):
                return {"op": "ok", "dup": True}
            if op == "downloaded":
                idx = int(msg["idx"])
                s = int(self.m.status[idx])
                if not (STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10):
                    self.m.status[idx] = STATUS_DOWNLOAD_SUCCESS
                self._mark_seen(msg)
                return {"op": "ok"}
            if op == "bloom_done":
                idx = int(msg["idx"])
                self._in_flight_bloom.pop(idx, None)
                param = _param_from_dict(msg["param"]) if msg.get("param") else None
                self.m._absorb_bloom_event(idx, int(msg["status"]), param,
                                           float(msg.get("dt", 0.0)))
                self.m.checkpoint()
                self._mark_seen(msg)
                return {"op": "ok"}
            if op == "db_done":
                dbi = int(msg["db_index"])
                members, _t0 = self._in_flight_db.pop(dbi, (msg["members"], 0.0))
                self._db_members_in_flight.difference_update(members)
                for i in members:
                    self.m.status[i] = int(msg["status"])
                self.m.checkpoint(force=True)
                self._mark_seen(msg)
                return {"op": "ok"}
        return {"op": "error", "error": f"unknown op {op!r}"}

    def _requeue_overdue(self) -> None:
        if self.task_timeout is None:
            return
        now = time.time()
        for idx, t0 in list(self._in_flight_bloom.items()):
            if now - t0 > self.task_timeout:
                # The status byte already carries the pre-marked failure;
                # requeue through the retry deque.
                del self._in_flight_bloom[idx]
                self.m._retry.append(idx)
        for dbi, (members, t0) in list(self._in_flight_db.items()):
            if now - t0 > self.task_timeout:
                del self._in_flight_db[dbi]
                self._db_members_in_flight.difference_update(members)
                # Pre-marked DATABASE_FAIL stands; restore-time
                # restore_bloom recovers the members.

    def _next_task(self, n: int = 1) -> dict:
        m = self.m
        self._requeue_overdue()

        # Forced flush + completion bookkeeping (maestro_main.cpp:341-346,
        # 410-415): nothing fresh, nothing staged, nothing in flight.
        idle = not self._in_flight_bloom and not self._in_flight_db
        if m._cursor >= m._end and not m._download_ready and idle:
            m._forced_flush = True

        # Priority 1: database packing (any free worker can take a group).
        # Ready groups pop off the event-driven map into a dispatch deque;
        # one db task is served per pull.
        for g in m._take_ready_groups():
            self._pending_db.append(g)
        if self._pending_db:
            param, members = self._pending_db.popleft()
            dbi = m.database_index
            # Stride num_slice, like the local scheduler: a sliced
            # coordinator keeps the collision-free interleaved
            # sra.<index>.db numbering.
            m.database_index += m.opt.num_slice
            for i in members:
                m.status[i] = STATUS_DATABASE_FAIL  # pre-mark
            self._in_flight_db[dbi] = (members, time.time())
            self._db_members_in_flight.update(members)
            return {
                "op": "db",
                "db_index": dbi,
                "param": _param_to_dict(param),
                "members": members,
                "accessions": [m.accessions[i] for i in members],
            }

        # Priorities 2/3: restored downloads, retries, fresh cursor work.
        # A device-building worker pulls up to its batch size in one go
        # so its two fused dispatches cover the whole set. block_delay
        # is off: sleeping the --delay throttle here would hold the
        # scheduling lock and stall every completion RPC behind it.
        items = []
        delayed = False
        while len(items) < n:
            item = m._next_work_item(block_delay=False)
            if item == "delay":
                delayed = True
                break
            if item is None:
                break
            idx, phase = item
            self._in_flight_bloom[idx] = time.time()
            items.append({
                "idx": idx,
                "accession": m.accessions[idx],
                "phase": phase,
            })
        if len(items) == 1:
            return {"op": "bloom", **items[0]}
        if items:
            return {"op": "bloom_batch", "items": items}

        if delayed or not idle or self._pending_db or m._retry \
                or m._download_ready or m._cursor < m._end or bool(
            (m.status == STATUS_BLOOM_SUCCESS).any()
        ):
            return {"op": "wait"}
        self._done.set()
        return {"op": "quit"}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.m._end = self.m._compute_end()
        self.m.checkpoint(force=True)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def wait(self, poll: float = 0.2) -> None:
        """Block until every accession is terminal and workers were told
        to quit, then write the final checkpoint."""
        while not self._done.is_set():
            time.sleep(poll)
        self.m.checkpoint(force=True)
        self.m.display_status(force=True)

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RemoteWorker:
    """Worker-side pull loop (worker_main.cpp:27-112): ask for a task,
    run the shared pure functions, report the event. One worker per call;
    run several (threads or processes, one per host) for a fleet."""

    def __init__(self, opt: MaestroOptions, resolver: SourceResolver,
                 address: tuple[str, int], name: str = "",
                 event_retry_sec: float = 600.0, secret: str | None = None):
        from collections import deque

        from ..utils.runtime import resolve_secret

        self._secret = resolve_secret(secret)
        self.opt = opt
        self.resolver = resolver
        self.address = tuple(address)
        self.name = name or socket.gethostname()
        # At-least-once event delivery: undelivered completion events
        # buffer locally and retry in order; the coordinator dedupes
        # replays by eid. A coordinator blackholed longer than
        # event_retry_sec is treated as gone.
        self.event_retry_sec = event_retry_sec
        self._pending: deque[dict] = deque()
        # eids must be unique across worker RESTARTS too (the default
        # name is the hostname): a restarted worker reusing name:0..K
        # would have its fresh events deduped as replays of the dead
        # process's deliveries. Salt with a per-process random component.
        import uuid

        self._eid_salt = uuid.uuid4().hex[:8]
        self._eid = 0

    def _bloom_path(self, accession: str) -> str:
        import os

        return os.path.join(self.opt.scratch_bloom_dir, accession + ".bloom")

    def _send(self, msg: dict) -> dict:
        """_send_msg with the shared-secret token attached. A "denied"
        reply is a configuration error, not a transient fault: raise
        instead of letting retry loops spin on it forever."""
        if self._secret:
            msg = dict(msg, token=self._secret)
        reply = _send_msg(self.address, msg)
        if not reply:
            # Connection closed without a reply line (handler crash, or
            # the coordinator died between read and respond): treat as
            # UNDELIVERED so the event stays buffered and is resent --
            # the eid dedupe absorbs the case where it was applied but
            # the reply was lost. (The coordinator always replies with
            # at least an "op" field.)
            raise OSError("empty reply from coordinator")
        if reply.get("op") == "denied":
            # NOT an OSError subclass: the transient-fault retry loops
            # (except OSError) must not spin on a config error.
            raise QueueAuthError(
                f"coordinator refused {msg.get('op')}: {reply.get('error')}"
            )
        return reply

    def _queue_event(self, msg: dict) -> None:
        msg = dict(msg)
        msg["eid"] = f"{self.name}:{self._eid_salt}:{self._eid}"
        self._eid += 1
        self._pending.append(msg)

    def _try_flush_once(self) -> None:
        """Single best-effort drain pass (no sleeping): used for interim
        events fired from inside a build, which must not block it."""
        while self._pending:
            try:
                self._send(self._pending[0])
            except OSError:
                return
            self._pending.popleft()

    def _flush_events(self) -> bool:
        """Deliver every buffered event in order, retrying with backoff
        until event_retry_sec expires. True = drained."""
        deadline = time.time() + self.event_retry_sec
        backoff = 0.05
        while self._pending:
            try:
                self._send(self._pending[0])
            except OSError:
                if time.time() >= deadline:
                    return False
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            self._pending.popleft()
            backoff = 0.05
        return True

    def run(self, poll: float = 0.2) -> int:
        """Process tasks until the coordinator says quit. Returns the
        number of tasks executed."""
        import os

        from ..pipeline.build_db import build_db_from_bloom_files
        from .maestro import STATUS_DATABASE_SUCCESS, STATUS_DATABASE_UPLOAD_FAIL

        os.makedirs(self.opt.scratch_bloom_dir, exist_ok=True)
        os.makedirs(self.opt.scratch_database_dir, exist_ok=True)
        # Batched pulls amortize the per-task round trips (pull + event
        # flush) that dominated small-accession corpora: device workers
        # pull a fused dispatch's worth; host workers pull
        # KWAGE_WORKER_PULL tasks (default 16) and report each batch's
        # events in one flush. The coordinator re-queues pre-marked
        # tasks on worker loss either way (--task-timeout).
        pull_n = (self.opt.device_batch if self.opt.device_build
                  else max(1, int(os.environ.get("KWAGE_WORKER_PULL", "16"))))
        n_tasks = 0
        while True:
            try:
                task = self._send(
                    {"op": "next", "worker": self.name, "n": pull_n}
                )
            except OSError:
                # Coordinator gone: it shuts down once every accession is
                # terminal, and a worker mid-poll can miss the final
                # "quit" reply. Treat a vanished coordinator as shutdown
                # (the reference's MAESTRO_QUIT analog).
                import sys

                print("coordinator unreachable; worker exiting", file=sys.stderr)
                return n_tasks
            op = task.get("op")
            if op == "quit":
                return n_tasks
            if op == "wait":
                time.sleep(poll)
                continue
            n_tasks += 1
            if op == "bloom_batch":
                items = task["items"]
                acc_of = {it["idx"]: it["accession"] for it in items}
                def _on_downloaded_batch(key: int) -> None:
                    self._queue_event({"op": "downloaded", "idx": key})
                    self._try_flush_once()

                if self.opt.device_build:
                    from .maestro import execute_bloom_batch

                    results = execute_bloom_batch(
                        [
                            (it["idx"], it["accession"],
                             self._load_info(it["accession"]), it["phase"])
                            for it in items
                        ],
                        self.resolver,
                        self.opt,
                        lambda key: self._bloom_path(acc_of[key]),
                        on_downloaded=_on_downloaded_batch,
                    )
                else:
                    # Host path: per-accession native builds back to
                    # back; the batch exists to amortize the pull/flush
                    # round trips, not to fuse compute.
                    results = []
                    for it in items:
                        idx = int(it["idx"])
                        t0 = time.time()
                        status, param = execute_bloom_task(
                            it["accession"], self._load_info(it["accession"]),
                            it["phase"], self.resolver, self.opt,
                            self._bloom_path(it["accession"]),
                            on_downloaded=lambda i=idx: _on_downloaded_batch(i),
                        )
                        results.append((idx, status, param, time.time() - t0))
                for key, status, param, dt in results:
                    self._queue_event({
                        "op": "bloom_done", "idx": key, "status": status,
                        "param": _param_to_dict(param) if param else None,
                        "dt": dt, "mem": memory_usage(), "worker": self.name,
                    })
                if not self._flush_events():
                    return n_tasks
            elif op == "bloom":
                idx = int(task["idx"])
                acc = task["accession"]
                t0 = time.time()
                # FilterInfo comes from the shared inventory, loaded
                # locally (the reference ships it in the MPI message;
                # shared storage makes the seek equivalent).
                info = self._load_info(acc)

                def _on_downloaded() -> None:
                    self._queue_event({"op": "downloaded", "idx": idx})
                    self._try_flush_once()

                status, param = execute_bloom_task(
                    acc, info, task["phase"], self.resolver, self.opt,
                    self._bloom_path(acc),
                    on_downloaded=_on_downloaded,
                )
                self._queue_event({
                    "op": "bloom_done", "idx": idx, "status": status,
                    "param": _param_to_dict(param) if param else None,
                    "dt": time.time() - t0, "mem": memory_usage(),
                    "worker": self.name,
                })
                if not self._flush_events():
                    return n_tasks
            elif op == "db":
                t0 = time.time()
                dbi = int(task["db_index"])
                param = _param_from_dict(task["param"])
                blooms = [self._bloom_path(a) for a in task["accessions"]]
                ext = "dbz" if self.opt.compress_db else "db"
                db_path = os.path.join(
                    self.opt.scratch_database_dir, f"sra.{dbi}.{ext}"
                )
                status = STATUS_DATABASE_SUCCESS
                try:
                    build_db_from_bloom_files(
                        db_path, param, blooms, device=self.opt.device_transpose
                    )
                except (ValueError, OSError):
                    status = STATUS_DATABASE_FAIL
                if status == STATUS_DATABASE_SUCCESS and self.opt.s3_bucket \
                        and not self.opt.s3_no_write:
                    import subprocess

                    cmd = ["aws", "s3", "cp" if self.opt.save_db else "mv",
                           db_path,
                           f"{self.opt.s3_bucket}/{os.path.basename(db_path)}"]
                    if subprocess.run(cmd, capture_output=True).returncode != 0:
                        status = STATUS_DATABASE_UPLOAD_FAIL
                if status == STATUS_DATABASE_SUCCESS and not self.opt.save_bloom:
                    for b in blooms:
                        try:
                            os.unlink(b)
                        except OSError:
                            pass
                self._queue_event({
                    "op": "db_done", "db_index": dbi,
                    "members": task["members"], "status": status,
                    "dt": time.time() - t0, "mem": memory_usage(),
                    "worker": self.name,
                })
                if not self._flush_events():
                    return n_tasks
            else:
                raise RuntimeError(f"unexpected coordinator reply: {task}")

    def _load_info(self, accession: str):
        from ..core.accession import str_to_accession
        from ..core.info import FilterInfo
        from ..io.inventory import read_filter_info_at, scan_inventory_locations

        if not hasattr(self, "_loc"):
            pairs = scan_inventory_locations(self.opt.metadata_file)
            self._loc = {a: off for a, off in pairs}
        code = str_to_accession(accession)
        off = self._loc.get(code)
        if off is None:
            return FilterInfo(run_accession=code)
        return read_filter_info_at(self.opt.metadata_file, off)


def run_distributed_maestro(
    opt: MaestroOptions,
    resolver: SourceResolver,
    num_local_workers: int = 0,
    host: str = "127.0.0.1",
    port: int = 0,
    task_timeout: float | None = None,
) -> Maestro:
    """Convenience wrapper: start a coordinator (restoring state first)
    plus optional in-process workers, serve until completion, return the
    finished Maestro for inspection."""
    m = Maestro(opt, resolver)
    m.restore()
    coord = CoordinatorServer(m, host=host, port=port, task_timeout=task_timeout)
    coord.start()
    threads = []
    for w in range(num_local_workers):
        worker = RemoteWorker(opt, resolver, coord.address, name=f"local{w}")
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        threads.append(t)
    try:
        coord.wait()
        for t in threads:
            t.join(timeout=30)
    finally:
        coord.shutdown()
    return m
