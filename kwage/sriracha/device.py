"""Device batch path for SriRachA per-read search.

Reads are padded into [batch, max_len] uint8 blocks and k-merized,
deduplicated (lexicographic sort + neighbor compare) and intersected with
the query k-mer sets entirely on device; the scalar gates, thresholding,
perfect-match culling and ordering are applied on host from the returned
integer counts so results are bit-identical to the sequential engine.

Intersection strategy (the reference binary-searches per k-mer,
SriRachA/search_by_kmer.cpp:54-134; log(n) DEPENDENT gathers leave a
vector machine waiting on memory latency at every step):

- k <= _table_k_limit() (13 or 14, by device memory): the whole 4^k
  space fits a dense lookup table of per-subject membership bitmasks --
  ONE gather per read k-mer.
- larger k, up to 32: a bucketed device hash table. The union of the subjects'
  64-bit canonical k-mers hashes into [2^m, C] buckets host-side; lookup
  is one row-gather of C candidate (hi, lo, mask) triples per read k-mer
  plus a vectorized compare -- constant work, no dependent chains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kmers import canonical_kmers_device
from .engine import SearchMatch, SrirachaOptions, StreamStats

# numpy scalar: a jnp scalar at module scope would initialize the jax
# backend at import time (see ops/hashing.py).
_SENTINEL = np.uint32(0xFFFFFFFF)
MAX_DEVICE_K = 32


def _encode(ascii_u8):
    x = ascii_u8.astype(jnp.int32)
    code = jnp.zeros_like(x)
    valid = jnp.zeros_like(x, dtype=bool)
    for chars, value in (((65, 97), 0), ((67, 99), 1), ((71, 103), 2), ((84, 116), 3)):
        hit = (x == chars[0]) | (x == chars[1])
        code = jnp.where(hit, value, code)
        valid = valid | hit
    return code.astype(jnp.uint32), valid


def _kmerize_batch(reads: jax.Array, lengths: jax.Array, k: int):
    """Shared per-batch prefix: canonical k-mers, per-read sort + dedup.

    Returns (sorted_k uint32 [B, nwin] with sentinel padding, uniq_mask
    bool [B, nwin], num_kmer int32 [B], num_unique int32 [B]).
    """
    B, L = reads.shape
    nwin = L - k + 1
    codes, base_valid = _encode(reads)
    comp = jnp.uint32(3) - codes

    pos = jnp.arange(L)
    base_valid = base_valid & (pos[None, :] < lengths[:, None])

    iv = (~base_valid).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), jnp.cumsum(iv, axis=1)], axis=1)
    win_valid = (cs[:, k:] - cs[:, :-k]) == 0
    win_valid = win_valid & (jnp.arange(nwin)[None, :] + k <= lengths[:, None])

    sense = jnp.zeros((B, nwin), jnp.uint32)
    anti = jnp.zeros((B, nwin), jnp.uint32)
    top = 2 * (k - 1)
    for j in range(k):
        cj = jax.lax.dynamic_slice_in_dim(codes, j, nwin, axis=1)
        pj = jax.lax.dynamic_slice_in_dim(comp, j, nwin, axis=1)
        sense = (sense << 2) | cj
        anti = (anti >> 2) | (pj << top)
    sense = sense & jnp.uint32((1 << (2 * k)) - 1)
    canon = jnp.minimum(sense, anti)

    canon = jnp.where(win_valid, canon, _SENTINEL)
    sorted_k = jnp.sort(canon, axis=1)
    s_valid = sorted_k != _SENTINEL
    prev = jnp.concatenate([jnp.full((B, 1), _SENTINEL), sorted_k[:, :-1]], axis=1)
    uniq_mask = s_valid & (sorted_k != prev)

    num_kmer = win_valid.sum(axis=1).astype(jnp.int32)
    num_unique = uniq_mask.sum(axis=1).astype(jnp.int32)
    return sorted_k, uniq_mask, num_kmer, num_unique


def _mix32(hi, lo):
    """32-bit avalanche mix of a (hi, lo) 64-bit word -> bucket hash.
    Pure uint32 xor-shift-multiply, identical on numpy and jnp arrays
    (constants are numpy scalars so neither backend promotes)."""
    u = np.uint32
    x = lo ^ (lo >> u(16))
    x = x * u(0x7FEB352D)
    x = x ^ (x >> u(15))
    x = x * u(0x846CA68B)
    x = x ^ (x >> u(16))
    y = hi ^ (hi >> u(16))
    y = y * u(0x9E3779B1)
    y = y ^ (y >> u(13))
    y = y * u(0x85EBCA6B)
    y = y ^ (y >> u(16))
    return x ^ y


_BUCKET_CAP = 8  # candidate triples gathered per lookup row


def _build_hash_group(kmer_sets: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """<=32 subjects' sorted-unique uint64 canonical k-mers -> bucketed
    hash table (keys_hi, keys_lo, masks), each [2^m, _BUCKET_CAP].

    Duplicate k-mers across subjects merge into one entry with OR'd
    membership bits. m grows until no bucket overflows its capacity
    (canonical k-mers are min(sense, revcomp) of random-ish sequence, so
    the mixed hash balances well; a couple of doublings suffice even on
    adversarial inputs). Empty slots hold the all-ones key, which is
    never a canonical k-mer (its reverse complement is all-zeros, which
    always compares smaller)."""
    words = np.concatenate(kmer_sets)
    owner = np.concatenate(
        [np.full(w.size, np.uint32(1) << np.uint32(s), np.uint32)
         for s, w in enumerate(kmer_sets)]
    )
    order = np.argsort(words, kind="stable")
    w, mk = words[order], owner[order]
    starts = np.ones(w.size, dtype=bool)
    starts[1:] = w[1:] != w[:-1]
    seg = np.cumsum(starts) - 1
    uniq_w = w[starts]
    uniq_m = np.zeros(uniq_w.size, np.uint32)
    np.bitwise_or.at(uniq_m, seg, mk)

    hi = (uniq_w >> np.uint64(32)).astype(np.uint32)
    lo = (uniq_w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    n = uniq_w.size
    m = max(int(np.ceil(np.log2(n / 4 + 1))), 4)
    while True:
        nb = 1 << m
        b = (_mix32(hi, lo) & np.uint32(nb - 1)).astype(np.int64)
        if n == 0 or np.bincount(b, minlength=nb).max() <= _BUCKET_CAP:
            break
        m += 1
    keys_hi = np.full((nb, _BUCKET_CAP), 0xFFFFFFFF, np.uint32)
    keys_lo = np.full((nb, _BUCKET_CAP), 0xFFFFFFFF, np.uint32)
    masks = np.zeros((nb, _BUCKET_CAP), np.uint32)
    bo = np.argsort(b, kind="stable")
    bs = b[bo]
    pos = np.arange(n) - np.searchsorted(bs, bs)
    keys_hi[bs, pos] = hi[bo]
    keys_lo[bs, pos] = lo[bo]
    masks[bs, pos] = uniq_m[bo]
    return keys_hi, keys_lo, masks


def _kmerize_batch64(reads: jax.Array, lengths: jax.Array, k: int):
    """64-bit twin of _kmerize_batch for k > 15: canonical k-mers as
    (hi, lo) uint32 pairs, per-read 2-key sort + neighbor dedup."""
    B, L = reads.shape
    nwin = L - k + 1
    hi, lo, valid = jax.vmap(lambda r: canonical_kmers_device(r, k))(reads)
    valid = valid & (jnp.arange(nwin)[None, :] + k <= lengths[:, None])
    hi_k = jnp.where(valid, hi, _SENTINEL)
    lo_k = jnp.where(valid, lo, _SENTINEL)
    hi_s, lo_s = jax.lax.sort((hi_k, lo_k), num_keys=2, dimension=1)
    s_valid = ~((hi_s == _SENTINEL) & (lo_s == _SENTINEL))
    prev_hi = jnp.concatenate([jnp.full((B, 1), _SENTINEL), hi_s[:, :-1]], axis=1)
    prev_lo = jnp.concatenate([jnp.full((B, 1), _SENTINEL), lo_s[:, :-1]], axis=1)
    uniq_mask = s_valid & ((hi_s != prev_hi) | (lo_s != prev_lo))
    num_kmer = valid.sum(axis=1).astype(jnp.int32)
    num_unique = uniq_mask.sum(axis=1).astype(jnp.int32)
    return hi_s, lo_s, uniq_mask, num_kmer, num_unique


@partial(jax.jit, static_argnames=("k", "ns_groups"))
def _read_batch_kernel_hash(
    reads: jax.Array, lengths: jax.Array, tables: tuple, k: int, ns_groups: tuple
):
    """Bucketed-hash variant for k > table range: the shared 64-bit
    k-merize/sort/dedup runs once, then per 32-subject group one
    row-gather of _BUCKET_CAP candidates + vectorized key compare."""
    hi_s, lo_s, uniq_mask, num_kmer, num_unique = _kmerize_batch64(reads, lengths, k)

    parts = []
    for (keys_hi, keys_lo, masks), ns in zip(tables, ns_groups):
        nb = keys_hi.shape[0]
        b = (_mix32(hi_s, lo_s) & jnp.uint32(nb - 1)).astype(jnp.int32)
        cand_hi = keys_hi[b]            # [B, nwin, C]
        cand_lo = keys_lo[b]
        cand_mk = masks[b]
        hit = (cand_hi == hi_s[..., None]) & (cand_lo == lo_s[..., None])
        # Table keys are unique, so a k-mer hits at most one of the C
        # candidate slots: max over slots == the OR of the hit masks.
        found = jnp.where(hit, cand_mk, jnp.uint32(0)).max(axis=2)  # [B, nwin]
        found = jnp.where(uniq_mask, found, jnp.uint32(0))
        shifts = jnp.arange(ns, dtype=jnp.uint32)
        bits = ((found[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)
        parts.append(bits.sum(axis=1))  # [B, ns]
    return jnp.concatenate(parts, axis=1), num_kmer, num_unique


MAX_TABLE_K = 14  # 4^14 * 4 B = 1 GiB membership table per 32 subjects


def _table_k_limit(num_tables: int = 1) -> int:
    """Largest k whose dense tables (``num_tables`` of 4^k uint32 each)
    fit in half the device's fusion budget: 14 on an accelerator, 13 on
    the CPU backend's test budget."""
    from ..utils.runtime import fusion_budget_bytes

    half = fusion_budget_bytes() // 2
    k = MAX_TABLE_K
    while k > 1 and num_tables * (4 << (2 * k)) > half:
        k -= 1
    return k


def uses_dense_table(subject_kmers: list[tuple[str, np.ndarray]], k: int) -> bool:
    """Which intersection search_reads_device runs for these subjects.

    The bucketed hash table's ~100 B/k-mer tables are fast while they
    stay cache-resident and slow once every candidate-row gather misses;
    the dense LUT's one-gather cost does not depend on the subjects' size
    (4^k table). Prefer the hash table up to KWAGE_SRIRACHA_HASH_MAX
    k-mers per 32-subject group, the LUT above it (k > _table_k_limit()
    has no LUT and always hashes). KWAGE_SRIRACHA_HASH_MAX=0 forces the
    LUT everywhere. The default crossover was set on another device and
    is not yet re-measured on the H100."""
    import os

    groups = [subject_kmers[g : g + 32] for g in range(0, len(subject_kmers), 32)]
    hash_max = int(os.environ.get("KWAGE_SRIRACHA_HASH_MAX", "65536"))
    biggest = max((sum(s.size for _, s in grp) for grp in groups), default=0)
    return k <= _table_k_limit(len(groups)) and (hash_max <= 0 or biggest > hash_max)


@partial(jax.jit, static_argnames=("k",))
def build_subject_table(subjects: jax.Array, k: int) -> jax.Array:
    """Dense membership LUT uint32 [4^k]: bit s set iff k-mer in subject s.

    ``subjects`` is uint32 [NS, Smax] padded with the sentinel (out of the
    4^k range, so padding scatters drop). NS <= 32. One scatter-add over
    the flattened (index, 1 << s) pairs builds the table in a single pass;
    addition is OR-equivalent here because each subject's k-mer list is
    sorted-unique (load_subject_kmers), so no (index, s) pair repeats.
    """
    size = 1 << (2 * k)
    ns, smax = subjects.shape
    idx = jnp.where(subjects >= size, jnp.uint32(size), subjects).astype(jnp.int32)
    bits = jnp.broadcast_to(
        (jnp.uint32(1) << jnp.arange(ns, dtype=jnp.uint32))[:, None], (ns, smax)
    )
    return (
        jnp.zeros(size, jnp.uint32)
        .at[idx.reshape(-1)]
        .add(bits.reshape(-1), mode="drop")
    )


@partial(jax.jit, static_argnames=("k", "ns_groups"))
def _read_batch_kernel_tables(
    reads: jax.Array, lengths: jax.Array, tables: tuple, k: int, ns_groups: tuple
):
    """Dense-LUT variant: the shared k-merize/sort/dedup runs ONCE, then one
    table gather per 32-subject group. ``ns_groups[i]`` = subjects in
    tables[i]."""
    sorted_k, uniq_mask, num_kmer, num_unique = _kmerize_batch(reads, lengths, k)

    parts = []
    for table, ns in zip(tables, ns_groups):
        masks = jnp.take(table, sorted_k.astype(jnp.int32), mode="fill", fill_value=0)
        masks = jnp.where(uniq_mask, masks, jnp.uint32(0))
        shifts = jnp.arange(ns, dtype=jnp.uint32)
        bits = ((masks[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)
        parts.append(bits.sum(axis=1))                # [B, ns]
    return jnp.concatenate(parts, axis=1), num_kmer, num_unique


def search_reads_device(
    read_iter,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: StreamStats | None = None,
    batch_size: int = 512,
    span_reads: int | None = None,
    mesh=None,
    auto_mesh: bool = True,
    profile: dict | None = None,
) -> list[list[SearchMatch]]:
    """Device-batched equivalent of engine.search_reads (bit-identical
    output) for every reference-legal k (1..32,
    SriRachA/search_by_kmer.cpp:94-98).

    The read iterator is consumed in spans of ``span_reads`` (default
    16 x batch_size), pipelined ONE span deep: span i+1 is listed,
    packed and dispatched before span i's single readback sync, so host
    packing overlaps device compute. Host RAM is bounded by TWO spans
    (plus their in-flight device buffers) -- still independent of
    accession size (the reference streams read ranges the same way,
    sra_stream.cpp:525-543) -- and ``stats`` counters run up to one
    span ahead of emitted matches. Gates apply in read order, span by
    span; gate state (perfect-match early-skip, intermediate culls)
    carries across spans, so output is identical to a fully
    materialized run.

    ``mesh`` (optional, 1-axis jax.sharding.Mesh): shard each read batch
    across devices along the batch axis with the subject tables
    replicated -- the on-device analog of the reference's per-rank read
    split (sra_stream.cpp:525-543); per-read work is independent, so no
    collective is introduced. Bit-identical to the single-device path.
    By default (``auto_mesh``) a batch-axis mesh over every visible
    device is built automatically when more than one is present.

    ``profile`` (optional dict) accumulates pipeline phase timings in
    place: ``pack_dispatch_s`` (host packing + async dispatch per span),
    ``sync_s`` (the one 3-transfer readback per span), ``gate_s``
    (vectorized gates + accumulation), ``spans``/``bp`` totals, and
    ``events`` -- the ("dispatch"|"sync", span#) order, which proves the
    1-deep overlap (span i+1 dispatches BEFORE span i syncs). Zero cost
    when None."""
    from itertools import islice

    ns = len(subject_kmers)
    if ns == 0:
        return []
    ns_groups = tuple(min(32, ns - g) for g in range(0, ns, 32))
    if span_reads is None:
        span_reads = 16 * batch_size

    use_table = uses_dense_table(subject_kmers, opt.kmer_len)
    if use_table:
        smax = max((s.size for _, s in subject_kmers), default=1)
        subjects = np.full((ns, smax), 0xFFFFFFFF, dtype=np.uint32)
        for i, (_, s) in enumerate(subject_kmers):
            subjects[i, : s.size] = s.astype(np.uint32)
        subjects_dev = jnp.asarray(subjects)
        tables = tuple(
            build_subject_table(subjects_dev[g : g + 32], opt.kmer_len)
            for g in range(0, ns, 32)
        )
    else:
        # Bucketed hash tables over the 64-bit canonical k-mer space.
        hash_tables = tuple(
            tuple(
                jnp.asarray(a)
                for a in _build_hash_group(
                    [s.astype(np.uint64) for _, s in subject_kmers[g : g + 32]]
                )
            )
            for g in range(0, ns, 32)
        )

    if mesh is None and auto_mesh:
        devs = jax.devices()
        if len(devs) > 1:
            from jax.sharding import Mesh

            mesh = Mesh(np.array(devs), ("data",))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = mesh.axis_names[0]
        batch_size += (-batch_size) % mesh.devices.size
        _rep = NamedSharding(mesh, P())
        if use_table:
            tables = tuple(jax.device_put(t, _rep) for t in tables)
        else:
            hash_tables = tuple(
                tuple(jax.device_put(a, _rep) for a in grp)
                for grp in hash_tables
            )

        def put_batch(block, lengths):
            return (
                jax.device_put(block, NamedSharding(mesh, P(ax, None))),
                jax.device_put(lengths, NamedSharding(mesh, P(ax))),
            )
    else:
        def put_batch(block, lengths):
            return jnp.asarray(block), jnp.asarray(lengths)

    def run_batch(block, lengths):
        if use_table:
            return _read_batch_kernel_tables(
                block, lengths, tables, opt.kmer_len, ns_groups
            )
        return _read_batch_kernel_hash(
            block, lengths, hash_tables, opt.kmer_len, ns_groups
        )

    results: list[list[SearchMatch]] = [[] for _ in range(ns)]
    num_perfect = [0] * ns

    # Bucket by padded length so jit recompiles only per bucket size.
    def pad_len(n):
        p = 64
        while p < n:
            p *= 2
        return p

    def dispatch_span(reads):
        """Pack + asynchronously dispatch every batch of a span; returns
        the pending device results (no host sync happens here)."""
        buckets: dict[int, list[int]] = {}
        for i, (seq, _, _) in enumerate(reads):
            if stats is not None:
                stats.num_reads += 1
                stats.num_bases += len(seq)
            buckets.setdefault(pad_len(max(len(seq), opt.kmer_len)), []).append(i)

        pend_chunks: list[list[int]] = []
        pend_c, pend_k, pend_u = [], [], []
        for L, idxs in sorted(buckets.items()):
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start : start + batch_size]
                # Row count pads to the full batch (zero rows =
                # zero-length reads, masked out): a ragged final chunk
                # would otherwise be a fresh shape and a fresh XLA
                # compile.
                block = np.zeros((batch_size, L), dtype=np.uint8)
                lengths = np.zeros(batch_size, dtype=np.int32)
                for r, i in enumerate(chunk):
                    seq = reads[i][0]
                    block[r, : len(seq)] = np.frombuffer(
                        seq.encode("ascii"), dtype=np.uint8
                    )
                    lengths[r] = len(seq)
                c, k_, u_ = run_batch(*put_batch(block, lengths))
                pend_chunks.append(chunk)
                pend_c.append(c)
                pend_k.append(k_)
                pend_u.append(u_)
        return pend_chunks, pend_c, pend_k, pend_u

    def readback_span(reads, pending):
        """ONE sync point per span, THREE transfers total: every batch
        was dispatched asynchronously and the per-batch results
        concatenate ON DEVICE. A per-batch np.asarray would serialize a
        host<->device round trip per 512 reads. Batch b's rows live at
        offset b*batch_size."""
        pend_chunks, pend_c, pend_k, pend_u = pending
        counts = np.zeros((len(reads), ns), dtype=np.int64)
        nk = np.zeros(len(reads), dtype=np.int64)
        nu = np.zeros(len(reads), dtype=np.int64)
        if pend_chunks:
            # Pow2-bucket the concat ARITY (shape-bucketing rule: every
            # distinct operand count is a fresh XLA compile): pad the
            # pending lists by repeating the first batch's arrays --
            # no new device work, same sharding -- and ignore the rows.
            arity = 1
            while arity < len(pend_chunks):
                arity *= 2
            pad = arity - len(pend_chunks)
            cc = np.asarray(jnp.concatenate(pend_c + [pend_c[0]] * pad, axis=0))
            kk = np.asarray(jnp.concatenate(pend_k + [pend_k[0]] * pad, axis=0))
            uu = np.asarray(jnp.concatenate(pend_u + [pend_u[0]] * pad, axis=0))
            for b, chunk in enumerate(pend_chunks):
                off = b * batch_size
                counts[chunk] = cc[off : off + len(chunk)]
                nk[chunk] = kk[off : off + len(chunk)]
                nu[chunk] = uu[off : off + len(chunk)]
        return counts, nk, nu

    if profile is not None:
        import time as _time

        profile.setdefault("pack_dispatch_s", 0.0)
        profile.setdefault("sync_s", 0.0)
        profile.setdefault("gate_s", 0.0)
        profile.setdefault("spans", 0)
        profile.setdefault("bp", 0)
        profile.setdefault("events", [])

    read_iter = iter(read_iter)
    prev: tuple | None = None  # (reads, pending) -- 1-deep span pipeline
    span_no = 0
    while True:
        reads = list(islice(read_iter, span_reads))
        # Pack + dispatch span i+1 BEFORE syncing span i's readback:
        # host packing overlaps device compute, and the next span's
        # uploads ride ahead of the sync.
        if reads:
            if profile is not None:
                t0 = _time.perf_counter()
                cur = (reads, dispatch_span(reads), span_no)
                profile["pack_dispatch_s"] += _time.perf_counter() - t0
                profile["spans"] += 1
                profile["bp"] += sum(len(r[0]) for r in reads)
                profile["events"].append(("dispatch", span_no))
            else:
                cur = (reads, dispatch_span(reads), span_no)
            span_no += 1
        else:
            cur = None
        if prev is None:
            if cur is None:
                break
            prev = cur
            continue
        reads, pending, prev_no = prev
        if profile is not None:
            t0 = _time.perf_counter()
            counts, nk, nu = readback_span(reads, pending)
            profile["sync_s"] += _time.perf_counter() - t0
            profile["events"].append(("sync", prev_no))
            _t_gate = _time.perf_counter()
        else:
            counts, nk, nu = readback_span(reads, pending)
        prev = cur

        # Vectorized gates + accumulation. Semantics are EXACTLY the
        # engine's sequential loop (float32 divisions, nan-passes-gate
        # complexity quirk, perfect-match early-skip in read order);
        # a per-(read, subject) Python loop here would cap end-to-end
        # throughput at ~10 Mbp/s regardless of the kernel rate.
        # Equivalences relied on:
        #   - the perfect-match cap: a subject stops accepting matches
        #     the moment its appended-perfect count reaches
        #     max_num_match, so keep = (perfects before this read
        #     < max); num_perfect advances only by KEPT perfects.
        #     max_num_match <= 0 keeps nothing (0 >= 0 skips), same as
        #     the scalar gate.
        #   - the 10x intermediate cull: sort_key is a total order
        #     (-score, read_index, read_subindex), so prefix culls never
        #     change the final top-max set; culling once per span
        #     preserves both bytes and the memory bound.
        lens = np.fromiter((len(r[0]) for r in reads), np.int64, len(reads))
        nu_f = nu.astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            complexity = nu_f / nk.astype(np.float32)
            scores = counts.astype(np.float32) / nu_f[:, None]  # [n, ns]
        ok = (lens >= opt.min_read_length) & (nk >= opt.min_valid_kmer)
        # nan complexity (nk == 0) passes the gate in the scalar loop
        # (nan < x is False), hence the negated comparison.
        ok &= ~(complexity < np.float32(opt.min_read_complexity))
        cand = ok[:, None] & (scores >= np.float32(opt.kmer_match_threshold))
        for s in range(ns):
            idxs = np.nonzero(cand[:, s])[0]
            if idxs.size == 0:
                continue
            perf = scores[idxs, s] == np.float32(1.0)
            before = num_perfect[s] + np.cumsum(perf) - perf
            keep = before < opt.max_num_match
            bucket = results[s]
            for i in idxs[keep]:
                seq, ridx, sidx = reads[i]
                bucket.append(SearchMatch(ridx, sidx, float(scores[i, s]), seq))
            num_perfect[s] += int(perf[keep].sum())
            if opt.max_num_match > 0 and len(bucket) > 10 * opt.max_num_match:
                bucket.sort(key=SearchMatch.sort_key)
                del bucket[opt.max_num_match :]
        if profile is not None:
            profile["gate_s"] += _time.perf_counter() - _t_gate

    for bucket in results:
        bucket.sort(key=SearchMatch.sort_key)
        if opt.max_num_match > 0 and len(bucket) > opt.max_num_match:
            del bucket[opt.max_num_match :]
    return results
