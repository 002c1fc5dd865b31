"""Device-side bit-slice AND-reduce search kernel (JAX/XLA path).

The database lives in HBM as a uint32-packed signature matrix
``[filter_len, W]`` with ``W = ceil(num_filter / 32)`` (bit j of filter j
at word j//32, bit j%32 -- the little-endian view of the on-disk bytes).

Per query batch:
  1. gather the ``num_hash`` slice rows per k-mer (one HBM gather),
  2. AND across seeds -> per-k-mer match words,
  3. threshold == 1.0: AND across k-mers (padded k-mers contribute all-ones),
     otherwise: unpack bits and sum hit counts per filter (padded k-mers
     contribute zero).

The reference's early exits (kwage.cpp:460-482) are disk-seek
optimizations; with the matrix resident in HBM the masked full reduction
is both faster and result-identical.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.words import canonical_kmers
from ..native import murmur32_native
from ..utils.runtime import fusion_budget_bytes


def db_bytes_to_words(slices: np.ndarray) -> np.ndarray:
    """Disk slice matrix uint8 [L, slice_size] -> uint32 [L, W] (host)."""
    L, B = slices.shape
    pad = (-B) % 4
    if pad:
        slices = np.pad(slices, ((0, 0), (0, pad)))
    return np.ascontiguousarray(slices).reshape(L, -1, 4).view(np.uint32).reshape(L, -1)


def make_query_batch(
    queries: list[str], k: int, num_hash: int, log2_filter_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side query prep: pad per-query sorted-unique k-mer slice indices.

    Returns (idx int32 [nq, max_k, num_hash], kmer_valid bool [nq, max_k],
    num_kmers int32 [nq]).
    """
    per_query = []
    for q in queries:
        kmers = np.unique(canonical_kmers(q, k))
        h = murmur32_native(kmers, k, num_hash)
        mask = np.uint32((1 << log2_filter_len) - 1) if log2_filter_len < 32 else np.uint32(0xFFFFFFFF)
        per_query.append((h & mask).astype(np.int64))

    nq = len(per_query)
    max_k = max((p.shape[0] for p in per_query), default=0)
    # Bucket the k-mer axis to 128-multiples: every distinct shape is a
    # separate XLA compile, and serving batches vary per call.
    max_k = max(128, ((max_k + 127) // 128) * 128)
    idx = np.zeros((nq, max_k, num_hash), dtype=np.int32)
    valid = np.zeros((nq, max_k), dtype=bool)
    nk = np.zeros(nq, dtype=np.int32)
    for i, p in enumerate(per_query):
        idx[i, : p.shape[0]] = p
        valid[i, : p.shape[0]] = True
        nk[i] = p.shape[0]
    return idx, valid, nk


def _gather_and_reduce_seeds(db: jax.Array, idx: jax.Array, kmer_valid: jax.Array) -> jax.Array:
    """Gather + AND across seeds -> per-k-mer match words uint32 [nq, nk, W].

    Seeds gather SEQUENTIALLY, AND-ing into the accumulator: the peak
    intermediate is one [nq, nk, W] array instead of [nq, nk, nh, W],
    which keeps wide fused databases (W >= 512, i.e. 8+ files side by
    side) within device memory. Invalid (padding) k-mers produce all-zero
    match words.
    """
    nq, nk, nh = idx.shape
    km = db[idx[:, :, 0].reshape(-1)].reshape(nq, nk, -1)
    for h in range(1, nh):
        km = km & db[idx[:, :, h].reshape(-1)].reshape(nq, nk, -1)
    return jnp.where(kmer_valid[:, :, None], km, jnp.uint32(0))


def complete_kernel(db: jax.Array, idx: jax.Array, kmer_valid: jax.Array) -> jax.Array:
    """Threshold == 1.0 path: packed complete-match mask uint32 [nq, W].

    The AND across k-mers is a tree reduction (a fori_loop would serialize
    nk tiny vector ops; lax.reduce runs at gather speed). Plain function
    so shard_map can wrap it per-shard; use ``search_complete`` directly.
    """
    km = _gather_and_reduce_seeds(db, idx, kmer_valid)
    # Padded k-mers must not clear the AND: flip them to all-ones.
    km = jnp.where(kmer_valid[:, :, None], km, jnp.uint32(0xFFFFFFFF))
    return jax.lax.reduce(km, jnp.uint32(0xFFFFFFFF), jax.lax.bitwise_and, (1,))


search_complete = jax.jit(complete_kernel)


_CSA_GROUP = 32  # k-mers per carry-save group; counts <= 32 fit 6 bit planes


def _plane_add(a_planes: list, b_planes: list) -> list:
    """Ripple-add two bit-plane numbers (lists of uint32 plane arrays)."""
    n = max(len(a_planes), len(b_planes))
    out = []
    carry = None
    for j in range(n):
        terms = []
        if j < len(a_planes):
            terms.append(a_planes[j])
        if j < len(b_planes):
            terms.append(b_planes[j])
        if carry is not None:
            terms.append(carry)
        if len(terms) == 1:
            out.append(terms[0])
            carry = None
        elif len(terms) == 2:
            x, y = terms
            out.append(x ^ y)
            carry = x & y
        else:
            x, y, z = terms
            out.append(x ^ y ^ z)
            carry = (x & y) | (z & (x ^ y))
    if carry is not None:
        out.append(carry)
    return out


def counts_kernel(db: jax.Array, idx: jax.Array, kmer_valid: jax.Array) -> jax.Array:
    """Thresholded path: per-filter hit counts int32 [nq, W*32].

    Per-filter popcount-accumulate entirely in carry-save bit-plane
    arithmetic on packed words: each group of 32 k-mers folds into 6
    uint32 planes (5 bitwise ops/k-mer on [nq, W] vectors), the group
    plane-sets tree-reduce with ripple plane adders, and only the final
    ~log2(nk)-plane number expands to int32 lanes. No 32x bit expansion
    of the match words is ever written to device memory.
    """
    km = _gather_and_reduce_seeds(db, idx, kmer_valid)   # zeros for padding
    nq, nk, W = km.shape
    pad = (-nk) % _CSA_GROUP
    if pad:
        km = jnp.pad(km, ((0, 0), (0, pad), (0, 0)))     # zero words: no-ops
        nk += pad
    ng = nk // _CSA_GROUP
    g = jnp.moveaxis(km.reshape(nq, ng, _CSA_GROUP, W), 1, 0)  # [ng, nq, GROUP, W]

    n_acc = max(6, (nk).bit_length())  # accumulator planes: counts <= nk

    def step(acc, grp):  # acc [n_acc, nq, W]; grp [nq, GROUP, W]
        planes = [jnp.zeros((nq, W), jnp.uint32) for _ in range(6)]
        for k in range(_CSA_GROUP):
            carry = grp[:, k]
            for j in range(6):
                t = planes[j] & carry
                planes[j] = planes[j] ^ carry
                carry = t
        new = _plane_add([acc[j] for j in range(n_acc)], planes)[:n_acc]
        return jnp.stack(new), None

    # Derive the zero carry from the data so it carries the same mesh-axis
    # "varying" type as the body output under shard_map.
    acc0 = jnp.zeros((n_acc, nq, W), jnp.uint32) | (km[0, 0, 0] & jnp.uint32(0))
    planes, _ = jax.lax.scan(step, acc0, g)

    shifts = jnp.arange(32, dtype=jnp.uint32)
    total = jnp.zeros((nq, W, 32), jnp.int32)
    for j in range(n_acc):
        total = total + (
            ((planes[j][..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32) << j
        )
    return total.reshape(nq, W * 32)


search_counts = jax.jit(counts_kernel)


def eval_chunk_cols(
    words,
    idx_d,
    valid_d,
    threshold: float,
    budget_bytes: int,
) -> np.ndarray:
    """Hit counts (threshold < 1, int32 [nq, 32*W]) or packed complete
    mask (threshold == 1.0, uint32 [nq, W]) for one fused chunk.

    ``words`` is either a device-resident matrix (searched in one kernel
    call) or a host uint32 [L, W] matrix.  A host chunk wider than
    ``budget_bytes`` streams through the device in uniform column slabs
    (zero-padded tail; padding columns gather zero words, so they count
    0 / mask 0 and are trimmed by the caller's num_filter spans), each
    slab's device buffer released BEFORE the next upload so peak HBM
    stays one slab.  This is what lets a file larger than the budget (a
    full 2048-filter file at L=26 is 16 GiB, at L=28 64 GiB) search at
    all -- the reference reads it from disk in filter-sized strides
    (kwage.cpp:404-433); here the column axis is the streaming axis.
    """
    if not isinstance(words, np.ndarray):
        if threshold == 1.0:
            return np.asarray(search_complete(words, idx_d, valid_d))
        return np.asarray(search_counts(words, idx_d, valid_d))
    L, Wc = words.shape
    slab_w = max(int(budget_bytes // (L * 4)), 1)
    if slab_w >= Wc:
        db = jnp.asarray(words)
        if threshold == 1.0:
            return np.asarray(search_complete(db, idx_d, valid_d))
        return np.asarray(search_counts(db, idx_d, valid_d))
    parts = []
    for w0 in range(0, Wc, slab_w):
        slab = words[:, w0 : w0 + slab_w]
        real = slab.shape[1]
        if real < slab_w:  # uniform width: one XLA compile for the stream
            slab = np.pad(slab, ((0, 0), (0, slab_w - real)))
        db = jnp.asarray(slab)
        if threshold == 1.0:
            parts.append(np.asarray(search_complete(db, idx_d, valid_d))[:, :real])
        else:
            parts.append(
                np.asarray(search_counts(db, idx_d, valid_d))[:, : 32 * real]
            )
        db = None  # release before the next slab uploads (peak = 1 slab)
    return np.concatenate(parts, axis=1)


def unpack_mask(mask_words: np.ndarray, num_filter: int) -> np.ndarray:
    """Packed uint32 match mask [nq, W] -> bool [nq, num_filter] (host)."""
    # ascontiguousarray: sliced device outputs can carry non-contiguous
    # strides that .view() rejects (round-1 gotcha, resurfaced on large
    # query batches through the resident path).
    m = np.ascontiguousarray(np.asarray(mask_words))
    bits = np.unpackbits(m.view(np.uint8).reshape(m.shape[0], -1), axis=1, bitorder="little")
    return bits[:, :num_filter].astype(bool)


def search_files_device(
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
):
    """Device search over many database files -> {query_id: [MatchResult]}.

    Files with the same BloomParam are FUSED side by side into one wide
    signature matrix (each file's filters are byte-padded, so per-file
    column ranges stay word-aligned): wider gather rows amortize the
    per-row cost of the slice gather, the bulk of this kernel. Hit lists are identical
    to the host engine / reference binary, including accumulation order
    (file order, then filter index) and the descending result sort.
    """
    from ..io.dbz_file import open_database
    from ..search.engine import MatchResult, query_threshold_count

    if not queries:
        return {}
    readers = [open_database(p) for p in db_paths]
    groups: dict = {}
    for fi, r in enumerate(readers):
        groups.setdefault(r.header.param, []).append(fi)

    # Cap each fused matrix so huge corpora stream through device memory
    # in waves (tests shrink the budget to exercise the multi-chunk
    # path). A SINGLE file wider than the budget still becomes its own
    # chunk here; eval_chunk_cols streams its columns in budget-sized
    # slabs.
    budget = fusion_budget_bytes()
    chunked_groups: list[tuple[object, list[int]]] = []
    for param, file_idxs in groups.items():
        chunk: list[int] = []
        used = 0
        for fi in file_idxs:
            h = readers[fi].header
            sz = h.filter_len * ((h.slice_size + 3) // 4) * 4
            if chunk and used + sz > budget:
                chunked_groups.append((param, chunk))
                chunk, used = [], 0
            chunk.append(fi)
            used += sz
        if chunk:
            chunked_groups.append((param, chunk))

    results: dict[int, list] = {}
    buckets: dict[int, dict[int, list]] = {}  # qid -> file index -> hits
    batch_cache: dict = {}  # param -> (idx, valid, nk); shared across chunks

    for param, file_idxs in chunked_groups:
        words = []
        spans = []  # (file_idx, word_lo, word_hi)
        w0 = 0
        for fi in file_idxs:
            w = db_bytes_to_words(readers[fi].read_slices())
            words.append(w)
            spans.append((fi, w0, w0 + w.shape[1]))
            w0 += w.shape[1]
        fused = np.hstack(words)
        del words

        if param not in batch_cache:
            batch_cache[param] = make_query_batch(
                [q for _, q in queries], param.kmer_len, param.num_hash,
                param.log_2_filter_len,
            )
        idx, valid, nk = batch_cache[param]
        idx_d, valid_d = jnp.asarray(idx), jnp.asarray(valid)
        out = eval_chunk_cols(fused, idx_d, valid_d, threshold, budget)
        del fused
        if threshold == 1.0:
            mask_words = out
        else:
            counts = out

        for qi, (qid, _q) in enumerate(queries):
            if nk[qi] == 0:
                continue
            for fi, lo, hi in spans:
                nf = readers[fi].header.num_filter
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

    info_cache: dict[tuple[int, int], object] = {}
    for qid, per_file in buckets.items():
        out = []
        for fi in sorted(per_file):  # file order == path order (kwage.cpp:86)
            for f, nm, n in per_file[fi]:
                info = info_cache.get((fi, f))
                if info is None:
                    info = readers[fi].read_filter_info(f)
                    info_cache[(fi, f)] = info
                out.append(MatchResult(nm, n, info))
        out.sort(key=lambda m: -m.num_kmers_found)
        results[qid] = out
    return results


class DeviceSearcher:
    """A database file resident on device, searchable in query batches.

    Produces identical hit lists to the host engine / reference binary.
    """

    def __init__(self, header, slices: np.ndarray):
        self.header = header
        self.db = jnp.asarray(db_bytes_to_words(slices))

    @classmethod
    def from_file(cls, path: str):
        from ..io.dbz_file import open_database

        reader = open_database(path)
        return cls(reader.header, reader.read_slices()), reader

    def search(self, queries: list[str], threshold: float):
        """Returns per-query [(filter_idx, num_found, num_kmers), ...] lists."""
        from ..search.engine import query_threshold_count

        if not queries:
            return []
        hdr = self.header
        idx, valid, nk = make_query_batch(
            queries, hdr.kmer_len, hdr.num_hash, hdr.log_2_filter_len
        )
        out = []
        if threshold == 1.0:
            mask = unpack_mask(np.asarray(search_complete(self.db, jnp.asarray(idx), jnp.asarray(valid))), hdr.num_filter)
            for qi in range(len(queries)):
                if nk[qi] == 0:
                    out.append(None)
                    continue
                hits = np.nonzero(mask[qi])[0]
                out.append([(int(f), int(nk[qi]), int(nk[qi])) for f in hits])
        else:
            counts = np.asarray(search_counts(self.db, jnp.asarray(idx), jnp.asarray(valid)))[:, : hdr.num_filter]
            for qi in range(len(queries)):
                if nk[qi] == 0:
                    out.append(None)
                    continue
                qt = query_threshold_count(threshold, int(nk[qi]))
                hits = np.nonzero(counts[qi] >= qt)[0]
                out.append([(int(f), int(counts[qi, f]), int(nk[qi])) for f in hits])
        return out
