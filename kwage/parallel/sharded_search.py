"""Column-sharded bit-slice search over a device mesh (shard_map).

The signature matrix [filter_len, W] is sharded along the packed-filter
axis ("filters"); query slice indices are sharded along the batch axis
("data") and replicated across filter shards. Each device gathers its
local slice words, reduces across seeds/k-mers locally, and the per-shard
hit vectors are merged with an all_gather over the filters axis -- the
device equivalent of concatenating per-database-file hit lists in the
reference (kwage.cpp:154-177).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.search import (
    complete_kernel as _complete_kernel,
    counts_kernel as _counts_kernel,
    db_bytes_to_words,
    make_query_batch,
    unpack_mask,
)


def to_host(arr) -> np.ndarray:
    """Read a mesh output back as the GLOBAL array on every process.

    Single-process meshes (incl. the virtual CPU test mesh) read back
    directly. When the mesh spans processes (real multi-host pods,
    jax.distributed), outputs hold non-addressable shards; they are
    assembled with an all-gather so every host sees the full result --
    the analog of the reference's rank-0 MPI result merge
    (SriRachA/main.cpp:462-531), except no host is special."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def _sharded(fn, mesh: Mesh):
    # Per-query hit vectors are naturally sharded: the query axis follows
    # "data" and the packed-filter axis follows "filters" -- no collective
    # is needed at all (the concatenation of shard outputs IS the global
    # result). XLA reassembles the global array from the out_specs.
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(None, "filters"), P("data", None, None), P("data", None)),
            out_specs=P("data", "filters"),
        )
    )


def _total_hits_kernel(db_local, idx, kmer_valid, threshold_count):
    """Per-query TOTAL matching-filter count across the whole corpus: the
    per-shard reduction rides a psum over the "filters" axis (the
    analog of the reference's MPI_Allreduce(SUM) reconciliations,
    SriRachA/main.cpp:535-550)."""
    counts = _counts_kernel(db_local, idx, kmer_valid)   # [nq_local, Wl*32]
    local = (counts >= threshold_count[:, None]).sum(axis=1).astype(jnp.int32)
    return jax.lax.psum(local, axis_name="filters")


def sharded_total_hits(mesh: Mesh, db, idx, kmer_valid, threshold_count):
    """int32 [nq]: number of filters meeting the per-query threshold,
    reduced across all filter shards on-device."""
    fn = jax.jit(
        jax.shard_map(
            _total_hits_kernel,
            mesh=mesh,
            in_specs=(
                P(None, "filters"),
                P("data", None, None),
                P("data", None),
                P("data"),
            ),
            out_specs=P("data"),
        )
    )
    return fn(db, idx, kmer_valid, threshold_count)


def sharded_search_counts(mesh: Mesh, db, idx, kmer_valid):
    return _sharded(_counts_kernel, mesh)(db, idx, kmer_valid)


def sharded_search_complete(mesh: Mesh, db, idx, kmer_valid):
    return _sharded(_complete_kernel, mesh)(db, idx, kmer_valid)


class ShardedDatabase:
    """One BloomParam group of the corpus, sharded across a device mesh.

    Filters from many database files (same shape) are concatenated along
    the packed-word axis and placed with a NamedSharding over the
    "filters" mesh axis; queries are batched over "data".

    Memory discipline: each device holds at most ``budget_bytes`` of
    signature matrix at a time (default ``fusion_budget_bytes()``, the
    same budget as the single-device path, ops/search.py). A corpus wider
    than budget*n_shards streams through the mesh in column waves -- the
    sharded analog of the reference's 1 GiB transpose-buffer discipline
    (build_db.cpp:236-248). A single-wave corpus stays device-resident.
    Multi-wave streaming prefetches the NEXT wave while the current one
    computes, so two waves are transiently resident; waves are therefore
    sized at budget_bytes/2 per device, keeping the peak within budget.
    """

    def __init__(self, mesh: Mesh, param, slices: np.ndarray, num_filter: int,
                 budget_bytes: int | None = None):
        self._init_from_words(mesh, param, db_bytes_to_words(slices),
                              num_filter, budget_bytes)

    @classmethod
    def from_files(cls, mesh: Mesh, db_paths: list[str],
                   budget_bytes: int | None = None) -> "ShardedDatabase":
        """Fuse same-shape .db/.dbz files (in the given order) into one
        sharded group; file order then filter index is preserved so hit
        lists match the host engine byte-for-byte. Each file's columns
        stay word-aligned via its on-disk byte padding."""
        from ..io.dbz_file import open_database

        readers = [open_database(p) for p in db_paths]
        params = {r.header.param for r in readers}
        if len(params) != 1:
            raise ValueError("from_files requires a single BloomParam group")
        mats = [db_bytes_to_words(r.read_slices()) for r in readers]
        obj = cls.__new__(cls)
        obj._init_from_words(mesh, readers[0].header.param, np.hstack(mats),
                             sum(r.header.num_filter for r in readers),
                             budget_bytes)
        # (word_lo, word_hi, num_filter) per file, in path order.
        spans, w0 = [], 0
        for r, m in zip(readers, mats):
            spans.append((w0, w0 + m.shape[1], r.header.num_filter))
            w0 += m.shape[1]
        obj.file_spans = spans
        return obj

    def _init_from_words(self, mesh, param, words, num_filter, budget_bytes):
        from ..utils.runtime import fusion_budget_bytes

        self.mesh = mesh
        self.param = param
        self.num_filter = num_filter
        if budget_bytes is None:
            budget_bytes = fusion_budget_bytes(mesh.local_devices[0])
        n_shards = mesh.shape["filters"]
        bytes_per_word_col = words.shape[0] * 4
        # Columns per wave: the per-device budget times the shard count,
        # floored to at least one column per shard.
        max_cols = max((budget_bytes * n_shards) // max(bytes_per_word_col, 1), n_shards)
        if words.shape[1] > max_cols:
            # Multi-wave: _wave_dbs keeps the prefetched next wave resident
            # alongside the current one, so halve the per-wave footprint to
            # hold the documented per-device budget at peak. Floor to a
            # multiple of n_shards so the uniform shard padding can't push
            # a wave past budget/2.
            max_cols = max(
                (budget_bytes // 2 * n_shards) // max(bytes_per_word_col, 1),
                n_shards,
            )
            max_cols = max((max_cols // n_shards) * n_shards, n_shards)
        # (padded word matrix, real unpadded filter-column count) per wave.
        self._waves: list[tuple[np.ndarray, int]] = []
        self._spec_db = NamedSharding(mesh, P(None, "filters"))
        multi_wave = words.shape[1] > max_cols
        # Every wave shares one padded width so the whole stream reuses a
        # single XLA compilation (each distinct shape is a fresh compile).
        uniform = max_cols + ((-max_cols) % n_shards)
        col0 = 0
        while True:
            chunk = words[:, col0 : col0 + max_cols]
            # Real (bit-)columns this wave carries, in packed-column space:
            # wave padding is trimmed per wave, while padding INTERNAL to
            # the matrix (a fused file's final-word slack) survives and is
            # resolved by the caller's word spans / num_filter trim.
            real = chunk.shape[1] * 32
            width = uniform if multi_wave else chunk.shape[1] + ((-chunk.shape[1]) % n_shards)
            if chunk.shape[1] < width:
                chunk = np.pad(chunk, ((0, 0), (0, width - chunk.shape[1])))
            self._waves.append((chunk, real))
            col0 += max_cols
            if col0 >= words.shape[1]:
                break
        self.num_cols = words.shape[1] * 32
        self.num_waves = len(self._waves)
        self.W = sum(w.shape[1] for w, _ in self._waves)
        # Resident fast path: a single-wave corpus lives on the devices.
        self.db = (
            jax.device_put(self._waves[0][0], self._spec_db)
            if self.num_waves == 1
            else None
        )
        self._counts = _sharded(_counts_kernel, mesh)
        self._complete = _sharded(_complete_kernel, mesh)

    def _wave_dbs(self):
        """Yield device-resident signature matrices one wave at a time,
        prefetching the next wave's transfer (device_put is async) so the
        host->device copy overlaps the current wave's kernel."""
        if self.db is not None:
            yield self.db, self._waves[0][1]
            return
        pending = jax.device_put(self._waves[0][0], self._spec_db)
        for i, (_, real) in enumerate(self._waves):
            current = pending
            if i + 1 < len(self._waves):
                pending = jax.device_put(self._waves[i + 1][0], self._spec_db)
            yield current, real
            del current

    def _map_waves(self, fn) -> list:
        """Apply ``fn(db, real)`` to every wave, releasing each wave's
        device buffer BEFORE requesting the next.

        A plain ``for`` over ``_wave_dbs`` transiently pins THREE waves:
        when the loop calls next(), the generator uploads wave i+2 while
        the loop variable still references wave i — 3 × budget/2, past
        the budget whenever real memory pressure forces multi-wave
        streaming.  fn must block until the kernel has consumed db
        (to_host does).
        """
        out = []
        it = self._wave_dbs()
        while True:
            try:
                db, real = next(it)
            except StopIteration:
                return out
            out.append(fn(db, real))
            del db  # drop wave i before the generator uploads i+2

    def _prep(self, queries: list[str]):
        idx, valid, nk = make_query_batch(
            queries,
            self.param.kmer_len,
            self.param.num_hash,
            self.param.log_2_filter_len,
        )
        # Bucket both query-batch axes (serving calls arrive with varying
        # sizes; every distinct shape is a separate XLA compile), then pad
        # the batch to a multiple of the data axis.
        n_data = self.mesh.shape["data"]
        nq_b = max(n_data, 1 << int(np.ceil(np.log2(max(idx.shape[0], 1)))))
        nq_b += (-nq_b) % n_data
        nk_b = max(128, ((idx.shape[1] + 127) // 128) * 128)
        pad_q = nq_b - idx.shape[0]
        pad_k = nk_b - idx.shape[1]
        if pad_q or pad_k:
            idx = np.pad(idx, ((0, pad_q), (0, pad_k), (0, 0)))
            valid = np.pad(valid, ((0, pad_q), (0, pad_k)))
        spec_idx = NamedSharding(self.mesh, P("data", None, None))
        spec_valid = NamedSharding(self.mesh, P("data", None))
        return (
            jax.device_put(idx, spec_idx),
            jax.device_put(valid, spec_valid),
            nk,
        )

    def counts_cols(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Hit counts in packed-column space int [nq, num_cols] + k-mer
        counts (fused-file padding columns included; callers with word
        spans map columns to (file, filter))."""
        idx, valid, nk = self._prep(queries)
        parts = self._map_waves(
            lambda db, real: to_host(self._counts(db, idx, valid))[
                : len(queries), :real
            ]
        )
        counts = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return counts, nk

    def complete_cols(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Complete-match bool mask in packed-column space [nq, num_cols]."""
        idx, valid, nk = self._prep(queries)
        parts = self._map_waves(
            lambda db, real: unpack_mask(
                to_host(self._complete(db, idx, valid))[: len(queries)],
                real,
            )
        )
        mask = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return mask, nk

    def search_counts(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Per-filter hit counts int [nq, num_filter] + per-query k-mer counts."""
        counts, nk = self.counts_cols(queries)
        return counts[:, : self.num_filter], nk

    def total_hits(self, queries: list[str], threshold: float) -> np.ndarray:
        """Per-query corpus-wide matching-filter totals (psum over the
        "filters" axis). threshold must be > 0 so zero-count padding
        columns never match."""
        from ..search.engine import query_threshold_count

        idx, valid, nk = self._prep(queries)
        qt = np.ones(idx.shape[0], dtype=np.int32)  # padding queries: qt=1
        for i in range(len(queries)):
            qt[i] = max(query_threshold_count(threshold, int(nk[i])), 1)
        qt_d = jax.device_put(qt, NamedSharding(self.mesh, P("data")))
        parts = self._map_waves(
            lambda db, _real: to_host(
                sharded_total_hits(self.mesh, db, idx, valid, qt_d)
            ).astype(np.int64)
        )
        totals = np.zeros(idx.shape[0], dtype=np.int64)
        for p in parts:
            totals += p
        return totals[: len(queries)]

    def search_complete(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Complete-match bool mask [nq, num_filter] + per-query k-mer counts."""
        mask, nk = self.complete_cols(queries)
        return mask[:, : self.num_filter], nk


def build_sharded_groups(
    mesh: Mesh,
    db_paths: list[str],
    budget_bytes: int | None = None,
):
    """Fuse .db/.dbz files into budget-disciplined ShardedDatabase groups.

    Returns [(ShardedDatabase, file_indices)] in first-appearance order.
    The budget bounds HOST RAM too: a BloomParam group whose fused matrix
    exceeds budget * n_shards splits into file chunks loaded one at a
    time (the single-chip chunked_groups discipline, ops/search.py)
    before the per-chunk column waves bound device memory. Keep the returned groups
    alive to serve many query batches without reloading (the mesh
    serving primitive; see search/resident.py for the single-chip one).

    The budget is shared ACROSS groups: single-wave groups stay
    device-resident and claim their footprint from the pool, streaming
    groups size their waves within what remains — peak resident +
    2-wave-transient stays <= budget_bytes per device.  (Per-group
    budgets over-commit: a small group would sit resident while a large
    group's waves consumed the whole budget on top of it.)  When every chunk fits together, all
    go resident (the serving fast path); otherwise residency is capped
    at budget/2 so streaming groups keep at least half the pool.
    """
    from ..io.dbz_file import open_database
    from ..utils.runtime import fusion_budget_bytes

    groups: dict = {}
    headers = {}
    for fi, p in enumerate(db_paths):
        r = open_database(p)
        headers[fi] = r.header
        groups.setdefault(r.header.param, []).append(fi)

    if budget_bytes is None:
        budget_bytes = fusion_budget_bytes(mesh.local_devices[0])
    n_shards = mesh.shape["filters"]
    ram_cap = budget_bytes * n_shards
    chunked: list[list[int]] = []
    for _param, file_idxs in groups.items():
        chunk: list[int] = []
        used = 0
        for fi in file_idxs:
            h = headers[fi]
            sz = h.filter_len * ((h.slice_size + 3) // 4) * 4
            if chunk and used + sz > ram_cap:
                chunked.append(chunk)
                chunk, used = [], 0
            chunk.append(fi)
            used += sz
        if chunk:
            chunked.append(chunk)

    def chunk_dev_bytes(chunk):
        # Resident footprint per device, including the pad-to-n_shards
        # columns a single-wave matrix carries.
        cols = sum((headers[fi].slice_size + 3) // 4 for fi in chunk)
        cols += (-cols) % n_shards
        return cols * headers[chunk[0]].filter_len * 4 // n_shards

    total_dev = sum(chunk_dev_bytes(c) for c in chunked)
    resident_cap = budget_bytes if total_dev <= budget_bytes else budget_bytes // 2
    # Pass 1: greedy residency in order, bounded by the cap.
    spent = 0
    resident = []
    for chunk in chunked:
        sz = chunk_dev_bytes(chunk)
        ok = spent + sz <= resident_cap
        resident.append(ok)
        if ok:
            spent += sz
    # Pass 2: streaming chunks size waves within the pool the FINAL
    # resident total leaves free (a running subtraction would let a
    # later resident chunk overlap an earlier streaming chunk's waves).
    plan = [
        budget_bytes if ok else max(budget_bytes - spent, 1)
        for ok in resident
    ]

    return [
        (
            ShardedDatabase.from_files(
                mesh, [db_paths[fi] for fi in chunk], eff
            ),
            chunk,
        )
        for chunk, eff in zip(chunked, plan)
    ]


def search_sharded_groups(
    sharded_groups,
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
):
    """Search prebuilt budget-disciplined groups -> {query_id:
    [MatchResult]}; hit lists identical to the host engine / reference
    binary, including accumulation order (file order, then filter index)
    and the descending stable result sort (output.h:27-32,
    kwage.cpp:190-201)."""
    from ..io.dbz_file import open_database
    from ..search.engine import MatchResult, query_threshold_count

    if not queries:
        return {}
    results: dict[int, list] = {}
    buckets: dict[int, dict[int, list]] = {}  # qid -> file index -> hits
    readers = {}

    for sdb, file_idxs in sharded_groups:
        qtexts = [q for _, q in queries]
        if threshold == 1.0:
            mask, nk = sdb.complete_cols(qtexts)
        else:
            counts, nk = sdb.counts_cols(qtexts)
        for qi, (qid, _q) in enumerate(queries):
            if nk[qi] == 0:
                continue
            for (w_lo, w_hi, nf), fi in zip(sdb.file_spans, file_idxs):
                if threshold == 1.0:
                    hits_mask = mask[qi, 32 * w_lo : 32 * w_hi][:nf]
                    hits = [(int(f), int(nk[qi])) for f in np.nonzero(hits_mask)[0]]
                else:
                    c = counts[qi, 32 * w_lo : 32 * w_hi][:nf]
                    qt = query_threshold_count(threshold, int(nk[qi]))
                    hits = [(int(f), int(c[f])) for f in np.nonzero(c >= qt)[0]]
                if hits:
                    buckets.setdefault(qid, {}).setdefault(fi, []).extend(
                        (f, nm, int(nk[qi])) for f, nm in hits
                    )

    for qid, per_file in buckets.items():
        out = []
        for fi in sorted(per_file):  # file order == path order (kwage.cpp:86)
            if fi not in readers:
                readers[fi] = open_database(db_paths[fi])
            for f, nm, n in per_file[fi]:
                out.append(MatchResult(nm, n, readers[fi].read_filter_info(f)))
        out.sort(key=lambda m: -m.num_kmers_found)
        results[qid] = out
    return results


def sharded_search_files(
    mesh: Mesh,
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
    budget_bytes: int | None = None,
):
    """Mesh-sharded search over many database files -> {query_id:
    [MatchResult]}, the multi-chip analog of ops.search.search_files_device.
    One-shot convenience over build_sharded_groups + search_sharded_groups.
    """
    if not queries:
        return {}
    groups = build_sharded_groups(mesh, db_paths, budget_bytes)
    return search_sharded_groups(groups, db_paths, queries, threshold)
