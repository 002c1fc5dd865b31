"""Device-side seed-vectorized murmur3-32 over 2-bit k-mer words (JAX).

The reference's AVX2 8-seed SIMD hash (hash.cpp:239-332) maps naturally to
a vector lane axis: the per-block message constant k1 is seed independent
and computed once per k-mer; the seed states update vectorized. All
arithmetic is uint32 (native 32-bit lanes, no 64-bit emulation).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# numpy scalars, NOT jnp: a jnp scalar at module scope initializes the
# jax backend at import time -- and reserves the accelerator's memory --
# for every CLI that merely imports the package. numpy uint32 scalars
# promote identically inside traced code.
import numpy as _np

_C1 = _np.uint32(0xCC9E2D51)
_C2 = _np.uint32(0x1B873593)
_C3 = _np.uint32(0xE6546B64)
_F1 = _np.uint32(0x85EBCA6B)
_F2 = _np.uint32(0xC2B2AE35)


def _rotl(x, r: int):
    return (x << r) | (x >> (32 - r))


def _fmix(h):
    h = h ^ (h >> 16)
    h = h * _F1
    h = h ^ (h >> 13)
    h = h * _F2
    return h ^ (h >> 16)


def _base_code(hi, lo, k: int, i: int):
    """2-bit code of base i (0-based, 5' end) from the (hi, lo) word pair."""
    bitpos = 2 * (k - 1 - i)
    if bitpos >= 32:
        return (hi >> (bitpos - 32)) & 3
    return (lo >> bitpos) & 3


def _code_to_ascii(code):
    # "ACGT"[code] as uint32, via VPU selects (cheaper than a gather).
    return jnp.where(
        code == 0, jnp.uint32(65),
        jnp.where(code == 1, jnp.uint32(67),
                  jnp.where(code == 2, jnp.uint32(71), jnp.uint32(84))),
    )


@partial(jax.jit, static_argnames=("k", "num_seeds"))
def murmur32_device(hi: jax.Array, lo: jax.Array, k: int, num_seeds: int) -> jax.Array:
    """Murmur3-32 of each k-mer for seeds 0..num_seeds-1 -> uint32 [n, num_seeds]."""
    n = hi.shape[0]
    nblocks = k // 4
    tail = k & 3

    h = jnp.broadcast_to(jnp.arange(num_seeds, dtype=jnp.uint32), (n, num_seeds))

    for blk in range(nblocks):
        k1 = jnp.zeros(n, jnp.uint32)
        for byte in range(4):
            k1 = k1 | (_code_to_ascii(_base_code(hi, lo, k, blk * 4 + byte)) << (8 * byte))
        k1 = k1 * _C1
        k1 = _rotl(k1, 15)
        k1 = k1 * _C2
        h = h ^ k1[:, None]
        h = _rotl(h, 13)
        h = h * jnp.uint32(5) + _C3

    if tail:
        k1 = jnp.zeros(n, jnp.uint32)
        for t in range(tail):
            k1 = k1 ^ (_code_to_ascii(_base_code(hi, lo, k, nblocks * 4 + t)) << (8 * t))
        k1 = k1 * _C1
        k1 = _rotl(k1, 15)
        k1 = k1 * _C2
        h = h ^ k1[:, None]

    return _fmix(h ^ jnp.uint32(k))


@partial(jax.jit, static_argnames=("k", "num_hash", "log2_filter_len"))
def slice_indices_device(
    hi: jax.Array, lo: jax.Array, k: int, num_hash: int, log2_filter_len: int
) -> jax.Array:
    """Per-(k-mer, seed) slice row indices: murmur %% 2**L -> int32 [n, num_hash]."""
    h = murmur32_device(hi, lo, k, num_hash)
    if log2_filter_len < 32:
        h = h & jnp.uint32((1 << log2_filter_len) - 1)
    return h.astype(jnp.int32)
