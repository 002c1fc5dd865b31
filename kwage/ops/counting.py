"""Device-side k-mer counting + thresholding + filter construction (JAX).

The reference de-noises with a scatter-heavy counting-Bloom (4-bit
conservative-update cells, make_bloom.cpp:506-621) because a CPU can chase
random bytes. Random read-modify-write serializes on an accelerator's
memory, so this path reformulates thresholding as sort -> segment-sum ->
compact, which runs as large fused vector passes:

  1. canonical k-mers of a read batch (vmapped rolling windows),
  2. global sort by the 64-bit word (two chained 32-bit stable sorts),
  3. segment boundaries give exact multiplicities,
  4. words with count >= min_count keep their murmur bits,
  5. one scatter into a byte-per-bit filter image, packed to uint32.

Exactness: this computes TRUE counts -- the GROUND TRUTH the reference's
own rig (bloom_test.cpp) measures its counting filter against. It matches
the reference pipeline bit-for-bit whenever the counting filter is
collision-free over the input (always true for the small-input parity
corpora; at scale the reference's approximation drifts by ~0.1%,
make_bloom.cpp:35-45, while this path stays exact). Host parity builds
use kwage.native; this path is the high-throughput device ingest engine.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .hashing import murmur32_device
from .kmers import canonical_kmers_device


@partial(jax.jit, static_argnames=("k",))
def batch_canonical_kmers(reads_ascii: jax.Array, k: int):
    """Padded read batch uint8 [R, L] -> flat (hi, lo, valid) over all windows.

    Padding bytes (anything non-ACGT, e.g. zeros) invalidate their windows
    exactly like the reference's window-reset semantics (word.h:101-103).
    """
    hi, lo, valid = jax.vmap(lambda r: canonical_kmers_device(r, k))(reads_ascii)
    return hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)


def _sort_words(hi, lo, valid):
    """Stable sort of (hi, lo) 64-bit keys; invalid entries sink to the end.

    Returns sorted (hi, lo, valid).
    """
    # Invalid -> all-ones key, sorted after every real word (word bits are
    # at most 2k <= 64 with the top bits zero for k < 32; for k == 32 the
    # all-ones key may collide with a real k-mer, so `valid` rides along
    # and keeps them distinguishable).
    inv = ~valid
    hi_k = jnp.where(inv, jnp.uint32(0xFFFFFFFF), hi)
    lo_k = jnp.where(inv, jnp.uint32(0xFFFFFFFF), lo)
    hi_s, lo_s, val_s = jax.lax.sort(
        (hi_k, lo_k, inv.astype(jnp.uint8)), num_keys=3
    )
    return hi_s, lo_s, val_s == 0


@partial(jax.jit, static_argnames=("min_count",))
def count_and_threshold(hi, lo, valid, min_count: int):
    """Exact multiset thresholding of canonical k-mer words.

    Returns (hi_s, lo_s, selected, num_valid, num_windows):
      - hi_s/lo_s: the words, sorted (invalid/padding sink to the end);
      - selected[i] is True iff position i is the FIRST occurrence of a
        valid word whose total count >= min_count;
      - num_valid: number of distinct thresholded words (the quantity the
        adaptive Bloom sizing consumes, make_bloom.cpp:330);
      - num_windows: total count of valid windows (duplicates included) --
        equivalently, where the valid prefix of the sorted arrays ends.
    """
    hi_s, lo_s, val_s = _sort_words(hi, lo, valid)
    n = hi_s.shape[0]

    prev_hi = jnp.concatenate([jnp.full((1,), 0xFFFFFFFF, jnp.uint32), hi_s[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), 0xFFFFFFFF, jnp.uint32), lo_s[:-1]])
    is_start = ((hi_s != prev_hi) | (lo_s != prev_lo)) & val_s
    # Position 0 is a start whenever it is valid (the sentinel above only
    # collides for the all-ones word, which `val_s` disambiguates).
    is_start = is_start.at[0].set(val_s[0])

    # In sorted order, a segment starting at p has >= m elements iff the
    # element at p+m-1 exists, is valid, and holds the same word -- an O(1)
    # shifted compare, replacing a segment-sum's million-way scatter.
    m = min_count - 1
    if m == 0:
        selected = is_start
    else:
        ahead_hi = jnp.concatenate([hi_s[m:], jnp.full((m,), 0xFFFFFFFF, jnp.uint32)])
        ahead_lo = jnp.concatenate([lo_s[m:], jnp.full((m,), 0xFFFFFFFF, jnp.uint32)])
        ahead_val = jnp.concatenate([val_s[m:], jnp.zeros((m,), bool)])
        selected = (
            is_start & ahead_val & (ahead_hi == hi_s) & (ahead_lo == lo_s)
        )
    return (
        hi_s,
        lo_s,
        selected,
        jnp.sum(selected.astype(jnp.int32)),
        jnp.sum(val_s.astype(jnp.int32)),
    )


def _pack_bit_image(image):
    """uint8 0/1 bit image [n*32] -> packed uint32 words [n], little-endian
    bit order (bit b of word w = image[32*w + b]).

    ``jnp.packbits`` to bytes, then each 4 bytes reinterpreted as one
    little-endian word: XLA fuses it into one pass that reads the byte
    image once, with no widened temporary in device memory.
    """
    packed = jnp.packbits(image, bitorder="little")
    return jax.lax.bitcast_convert_type(packed.reshape(-1, 4), jnp.uint32)


@partial(jax.jit, static_argnames=("k", "num_hash", "log2_filter_len"))
def set_filter_bits(hi, lo, selected, k: int, num_hash: int, log2_filter_len: int):
    """Scatter the murmur bits of selected words into a packed filter.

    Returns uint32 [2**log2_filter_len / 32] in the .db little-endian word
    layout (bit b of word w = filter bit 32*w + b).
    """
    L = 1 << log2_filter_len
    h = murmur32_device(hi, lo, k, num_hash)                      # [n, nh]
    idx = (h & jnp.uint32(L - 1)).astype(jnp.int32)
    # Unselected rows scatter out of bounds and are dropped.
    idx = jnp.where(selected[:, None], idx, jnp.int32(L))
    image = jnp.zeros(L, jnp.uint8).at[idx.reshape(-1)].set(1, mode="drop")
    return _pack_bit_image(image)


def filter_words_to_bytes(words) -> "np.ndarray":
    """Packed uint32 filter words -> on-disk LSB-first byte order (host)."""
    import numpy as np

    # ascontiguousarray: astype(order='K') keeps non-contiguous strides
    # on sliced device outputs, which .view() rejects.
    return np.ascontiguousarray(np.asarray(words), dtype="<u4").view(np.uint8)


@partial(jax.jit, static_argnames=("k", "min_count"))
def count_kmers_device(reads_ascii: jax.Array, k: int, min_count: int):
    """Fused phase 1: read batch -> (hi_s, lo_s, selected, num_valid)."""
    hi, lo, valid = batch_canonical_kmers(reads_ascii, k)
    return count_and_threshold(hi, lo, valid, min_count)


@partial(jax.jit, static_argnames=("k", "min_count", "num_acc"))
def count_kmers_device_multi(
    reads_ascii: jax.Array, acc_ids: jax.Array, k: int, min_count: int, num_acc: int
):
    """Multi-accession fused count: one dispatch thresholds a whole BATCH.

    ``acc_ids`` int32 [R] assigns each (padded) read to an accession slot
    in [0, num_acc). One 3-key sort by (accession, word) segments the
    global window stream per accession; the shifted-compare threshold
    then works within segments for free because an accession change also
    breaks word equality. Returns device arrays
    (acc_s, hi_s, lo_s, selected, num_valid[num_acc]) -- keep them
    device-resident and feed set_filter_bits_multi to avoid any large
    host readback (only num_valid and the final packed filters cross the
    link). Amortizes the reference's per-accession worker dispatch
    (worker_main.cpp:245-382) across the batch.
    """
    hi, lo, valid = jax.vmap(lambda r: canonical_kmers_device(r, k))(reads_ascii)
    return _count_multi_core(hi, lo, valid, acc_ids, min_count, num_acc)


@partial(jax.jit, static_argnames=("k", "min_count", "num_acc", "length"))
def count_kmers_device_multi_packed(
    packed: jax.Array,
    valid_words: jax.Array,
    acc_ids: jax.Array,
    k: int,
    min_count: int,
    num_acc: int,
    length: int,
):
    """count_kmers_device_multi over host-2-bit-packed reads
    (ops.kmers.pack_reads_host): a ~3.5x smaller host->device upload,
    decoded on device with pure vector shifts."""
    from .kmers import canonical_kmers_packed_device

    hi, lo, valid = jax.vmap(
        lambda p, v: canonical_kmers_packed_device(p, v, k, length)
    )(packed, valid_words)
    return _count_multi_core(hi, lo, valid, acc_ids, min_count, num_acc)


def _count_multi_core(hi, lo, valid, acc_ids, min_count: int, num_acc: int):
    acc = jnp.broadcast_to(acc_ids[:, None], hi.shape)
    hi, lo, valid, acc = (
        hi.reshape(-1), lo.reshape(-1), valid.reshape(-1), acc.reshape(-1)
    )
    inv = ~valid
    ones = jnp.uint32(0xFFFFFFFF)
    acc_k = jnp.where(inv, jnp.uint32(num_acc), acc.astype(jnp.uint32))
    hi_k = jnp.where(inv, ones, hi)
    lo_k = jnp.where(inv, ones, lo)
    acc_s, hi_s, lo_s, inv_s = jax.lax.sort(
        (acc_k, hi_k, lo_k, inv.astype(jnp.uint8)), num_keys=3
    )
    val_s = inv_s == 0

    prev_acc = jnp.concatenate([jnp.full((1,), num_acc, jnp.uint32), acc_s[:-1]])
    prev_hi = jnp.concatenate([jnp.full((1,), ones, jnp.uint32), hi_s[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), ones, jnp.uint32), lo_s[:-1]])
    is_start = (
        (acc_s != prev_acc) | (hi_s != prev_hi) | (lo_s != prev_lo)
    ) & val_s
    is_start = is_start.at[0].set(val_s[0])

    m = min_count - 1
    if m == 0:
        selected = is_start
    else:
        ahead_acc = jnp.concatenate([acc_s[m:], jnp.full((m,), num_acc, jnp.uint32)])
        ahead_hi = jnp.concatenate([hi_s[m:], jnp.full((m,), ones, jnp.uint32)])
        ahead_lo = jnp.concatenate([lo_s[m:], jnp.full((m,), ones, jnp.uint32)])
        ahead_val = jnp.concatenate([val_s[m:], jnp.zeros((m,), bool)])
        selected = (
            is_start
            & ahead_val
            & (ahead_acc == acc_s)
            & (ahead_hi == hi_s)
            & (ahead_lo == lo_s)
        )
    # Per-accession selected counts WITHOUT an n-element scatter-add:
    # acc_s is sorted, so a cumsum + num_acc binary searches give exact
    # segment totals.
    cs = jnp.cumsum(selected.astype(jnp.int32))
    ends = jnp.searchsorted(
        acc_s, jnp.arange(1, num_acc + 1, dtype=jnp.uint32), side="left"
    )
    upto = jnp.where(ends > 0, cs[jnp.maximum(ends - 1, 0)], 0)
    num_valid = jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.int32), upto]))
    return acc_s, hi_s, lo_s, selected, num_valid


@partial(jax.jit, static_argnames=("k", "num_hash", "log2_filter_len", "num_acc", "compact"))
def set_filter_bits_multi(
    acc_s, hi_s, lo_s, selected, slot_of_acc,
    k: int, num_hash: int, log2_filter_len: int, num_acc: int,
    compact: int = 0,
):
    """Batched scatter: every accession's murmur bits land in its own
    image of a [num_acc, 2**log2_filter_len / 32] packed stack in ONE
    scatter pass. ``slot_of_acc`` int32 [num_acc + 1] maps accession id
    -> image slot, or -1 to drop (accessions belonging to a different
    L-group); the +1 slot absorbs the invalid-window sentinel id.

    ``compact`` (static, power-of-two >= the total selected count, or 0
    to disable): XLA's scatter pays its per-row cost for DROPPED rows
    too, so hashing/scattering the full window stream costs
    window_count x num_hash updates even when few survive thresholding.
    One cheap argsort-compaction first shrinks that to
    selected_count x num_hash, which wins whenever selected << windows.
    """
    if compact and compact < acc_s.shape[0]:
        order = jnp.argsort(jnp.where(selected, jnp.uint8(0), jnp.uint8(1)))[:compact]
        acc_s = acc_s[order]
        hi_s = hi_s[order]
        lo_s = lo_s[order]
        selected = selected[order]
    L = 1 << log2_filter_len
    h = murmur32_device(hi_s, lo_s, k, num_hash)                  # [n, nh]
    # int32 index math caps num_acc * filter_len below 2^31; the batch
    # builder enforces it (build_blooms_device_batch).
    idx = (h & jnp.uint32(L - 1)).astype(jnp.int32)
    slot = slot_of_acc[jnp.minimum(acc_s, jnp.uint32(num_acc)).astype(jnp.int32)]
    base = slot.astype(jnp.int32) * jnp.int32(L)
    keep = selected & (slot >= 0)
    flat = jnp.where(keep[:, None], base[:, None] + idx, jnp.int32(num_acc) * jnp.int32(L))
    image = (
        jnp.zeros(num_acc * L, jnp.uint8).at[flat.reshape(-1)].set(1, mode="drop")
    )
    return _pack_bit_image(image).reshape(num_acc, L // 32)


def build_filter_device(
    reads_ascii: jax.Array,
    k: int,
    min_count: int,
    num_hash: int,
    log2_filter_len: int,
):
    """One-call read batch -> packed filter words (fixed shape).

    For adaptive sizing call count_kmers_device first, solve
    optimal_bloom_param from num_valid on the host, then set_filter_bits.
    """
    hi_s, lo_s, selected, _, _ = count_kmers_device(reads_ascii, k, min_count)
    return set_filter_bits(hi_s, lo_s, selected, k, num_hash, log2_filter_len)
