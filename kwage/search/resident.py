"""Device-resident search service: load once, query many times.

The batch CLI (and the reference kwage binary) re-reads every database
file per invocation — and the device path re-uploads the fused signature
matrix each call. For serving, the matrix should live on device across
requests. ResidentSearcher fuses same-shape .db/.dbz files once (same
fusion/ordering rules as ops.search.search_files_device, so hit lists
stay byte-identical to the host engine / reference binary) and keeps the
device arrays + FilterInfo records resident; each query batch costs only
its own gathers.

serve() wraps it in a JSON-lines TCP loop (engine extension — the
reference has no server):

  request:  {"queries": ["ACGT...", ...], "threshold": 0.8,
             "format": "json" | "csv"}         (one line)
  response: {"ok": true, "output": "<rendered kwage JSON/CSV>"}
            | {"ok": false, "error": "..."}

The rendered output is byte-identical to what `kwage` would print for
the same queries against the same files.
"""

from __future__ import annotations

import json
import socketserver
import threading

import jax.numpy as jnp
import numpy as np

from ..ops.search import (
    db_bytes_to_words,
    eval_chunk_cols,
    make_query_batch,
    unpack_mask,
)
from .engine import MatchResult, query_threshold_count
from .output import render_csv, render_json


class ResidentSearcher:
    """Fused database groups resident on device, searchable repeatedly.

    Device-memory discipline: fused matrices stay device-resident up to
    ``budget_bytes`` (default ``fusion_budget_bytes()``, the same budget
    as the batch paths); overflow chunks stay host-side and upload per
    search call, so a corpus larger than the device serves correctly at
    reduced throughput instead of running out of memory.
    """

    def __init__(self, db_paths: list[str], budget_bytes: int | None = None):
        from ..io.dbz_file import open_database
        from ..utils.runtime import fusion_budget_bytes

        if budget_bytes is None:
            budget_bytes = fusion_budget_bytes()
        self._budget_bytes = budget_bytes
        self.db_paths = list(db_paths)
        self._readers = [open_database(p) for p in self.db_paths]
        groups: dict = {}
        for fi, r in enumerate(self._readers):
            groups.setdefault(r.header.param, []).append(fi)
        # Fused matrix chunks + file spans per BloomParam group, in
        # first-appearance order (matches search_files_device). Each
        # chunk is at most budget_bytes; chunks are device-resident until
        # the budget is spent, host-resident after.
        self._groups = []
        self.resident_bytes = 0
        for param, file_idxs in groups.items():
            chunk: list[int] = []
            used = 0
            chunks: list[list[int]] = []
            for fi in file_idxs:
                h = self._readers[fi].header
                sz = h.filter_len * ((h.slice_size + 3) // 4) * 4
                if chunk and used + sz > budget_bytes:
                    chunks.append(chunk)
                    chunk, used = [], 0
                chunk.append(fi)
                used += sz
            if chunk:
                chunks.append(chunk)
            for chunk in chunks:
                mats = []
                spans = []
                w0 = 0
                for fi in chunk:
                    w = db_bytes_to_words(self._readers[fi].read_slices())
                    mats.append(w)
                    spans.append((fi, w0, w0 + w.shape[1]))
                    w0 += w.shape[1]
                fused = np.hstack(mats)
                if self.resident_bytes + fused.nbytes <= budget_bytes:
                    self.resident_bytes += fused.nbytes
                    fused = jnp.asarray(fused)
                self._groups.append((param, fused, spans))
        self._info_cache: dict[tuple[int, int], object] = {}

    def search(self, queries: list[tuple[int, str]], threshold: float):
        """{query_id: [MatchResult]} — identical contract and ordering to
        search_files_device / the host engine."""
        if not queries:
            return {}
        results: dict[int, list] = {}
        buckets: dict[int, dict[int, list]] = {}
        for param, db, spans in self._groups:
            idx, valid, nk = make_query_batch(
                [q for _, q in queries],
                param.kmer_len, param.num_hash, param.log_2_filter_len,
            )
            idx_d, valid_d = jnp.asarray(idx), jnp.asarray(valid)
            # Host (over-budget) chunks upload per call; a chunk wider
            # than the budget (one 2048-filter file at L=28 is 64 GiB)
            # streams in column slabs instead of running out of memory.
            out = eval_chunk_cols(db, idx_d, valid_d, threshold,
                                  self._budget_bytes)
            if threshold == 1.0:
                mask_words = out
            else:
                counts = out
            for qi, (qid, _q) in enumerate(queries):
                if nk[qi] == 0:
                    continue
                for fi, lo, hi in spans:
                    nf = self._readers[fi].header.num_filter
                    if threshold == 1.0:
                        hits_mask = unpack_mask(mask_words[qi : qi + 1, lo:hi], nf)[0]
                        hits = [(int(f), int(nk[qi])) for f in np.nonzero(hits_mask)[0]]
                    else:
                        c = counts[qi, 32 * lo : 32 * hi][:nf]
                        qt = query_threshold_count(threshold, int(nk[qi]))
                        hits = [(int(f), int(c[f])) for f in np.nonzero(c >= qt)[0]]
                    if hits:
                        buckets.setdefault(qid, {}).setdefault(fi, []).extend(
                            (f, nm, int(nk[qi])) for f, nm in hits
                        )
        for qid, per_file in buckets.items():
            out = []
            for fi in sorted(per_file):
                for f, nm, n in per_file[fi]:
                    info = self._info_cache.get((fi, f))
                    if info is None:
                        info = self._readers[fi].read_filter_info(f)
                        self._info_cache[(fi, f)] = info
                    out.append(MatchResult(nm, n, info))
            out.sort(key=lambda m: -m.num_kmers_found)
            results[qid] = out
        return results

    def render(self, queries: list[str], threshold: float, fmt: str = "json") -> str:
        """Rendered hit lists, byte-identical to the kwage CLI for the
        same command-line queries (ids 'command line seq i')."""
        return _render(self, queries, threshold, fmt)


def _render(searcher, queries: list[str], threshold: float, fmt: str) -> str:
    pairs = [(i, q) for i, q in enumerate(queries)]
    res = searcher.search(pairs, threshold)
    ordered = [
        (f"command line seq {i}", res[i]) for i in sorted(res)
    ]
    if fmt == "csv":
        return render_csv(ordered)
    return render_json(ordered, threshold)


class MeshResidentSearcher:
    """ResidentSearcher over a device mesh: the fused matrices shard
    along the "filters" axis across every device (ShardedDatabase groups
    stay alive across requests; the same per-device budget streams
    over-budget corpora in column waves). Same search/render contract and
    bytes as ResidentSearcher."""

    def __init__(self, db_paths: list[str], mesh=None,
                 budget_bytes: int | None = None):
        if mesh is None:
            import jax

            from ..parallel import make_search_mesh

            mesh = make_search_mesh(1, len(jax.devices()))
        from ..parallel.sharded_search import build_sharded_groups

        self.db_paths = list(db_paths)
        self.mesh = mesh
        self._groups = build_sharded_groups(mesh, self.db_paths, budget_bytes)

    def search(self, queries: list[tuple[int, str]], threshold: float):
        from ..parallel.sharded_search import search_sharded_groups

        return search_sharded_groups(
            self._groups, self.db_paths, queries, threshold
        )

    def render(self, queries: list[str], threshold: float, fmt: str = "json") -> str:
        return _render(self, queries, threshold, fmt)


class HostResidentSearcher:
    """CPU twin of ResidentSearcher: mmapped .db slice matrices searched
    through the native kn_search kernel (engine extension -- serve without
    any accelerator attached). Same search/render contract and bytes as
    the device searchers / the batch CLI; the OS page cache plays the
    role of device residency across requests."""

    def __init__(self, db_paths: list[str]):
        self.db_paths = list(db_paths)

    def search(self, queries: list[tuple[int, str]], threshold: float):
        from .engine import search_database_files

        return search_database_files(self.db_paths, queries, threshold)

    def render(self, queries: list[str], threshold: float, fmt: str = "json") -> str:
        return _render(self, queries, threshold, fmt)


class SearchServer:
    """JSON-lines TCP server around a ResidentSearcher (one visible
    device), MeshResidentSearcher (several: the corpus shards across all
    of them), or HostResidentSearcher (engine="host": CPU-only)."""

    def __init__(self, db_paths: list[str], host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None, engine: str = "device"):
        from ..utils.runtime import resolve_secret

        # Loopback + unauthenticated by default; with a shared secret
        # (argument or KWAGE_QUEUE_SECRET env) every request must carry a
        # matching "token" field or is refused.
        self._secret = resolve_secret(secret)
        if engine == "host":
            searcher = HostResidentSearcher(db_paths)
        else:
            import jax

            if len(jax.devices()) > 1:
                searcher = MeshResidentSearcher(db_paths)
            else:
                searcher = ResidentSearcher(db_paths)
        self.searcher = searcher
        lock = threading.Lock()  # one device = one resource: serialize
        server_secret = self._secret

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.decode("utf-8").strip()
                    if not line:
                        continue
                    try:
                        from ..utils.runtime import check_token

                        req = json.loads(line)
                        if not check_token(req, server_secret):
                            raise PermissionError("bad or missing token")
                        queries = [str(q) for q in req["queries"]]
                        threshold = float(req.get("threshold", 1.0))
                        if not 0.0 < threshold <= 1.0:
                            raise ValueError("0.0 < threshold <= 1.0 required")
                        fmt = req.get("format", "json")
                        with lock:
                            out = searcher.render(queries, threshold, fmt)
                        reply = {"ok": True, "output": out}
                    except Exception as e:  # noqa: BLE001 -- wire boundary
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
