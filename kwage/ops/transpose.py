"""Device-side filter -> bit-slice transposition (JAX).

The reference's per-bit scatter loop (build_db.cpp:259-315) becomes a
dense bit-matrix transpose: unpack every bit to a byte, transpose, pack.
XLA fuses the three steps, so the byte-per-bit form is never written to
device memory. On an H100 80GB HBM3 at a 700 W limit this beat a packed
Hacker's-Delight 32x32 bit-block formulation by 2.3x (0.90 ms vs 2.06 ms
for a 2048 x 2^20-bit matrix; PERF.md), which is why it is the one
device transpose.

Inputs are processed in row chunks so arbitrary filter lengths stream
through device memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def unpack_bits_u8(x: jax.Array) -> jax.Array:
    """uint8 [..., B] -> uint8 bits [..., B*8], LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (x[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)


@jax.jit
def pack_bits_u8(bits: jax.Array) -> jax.Array:
    """uint8 bits [..., N] (N % 8 == 0) -> packed uint8 [..., N/8], LSB-first."""
    n = bits.shape[-1]
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    grouped = bits.reshape(*bits.shape[:-1], n // 8, 8)
    return (grouped * weights).sum(axis=-1).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("num_filter_padded",))
def transpose_bits_device(filters: jax.Array, num_filter_padded: int) -> jax.Array:
    """Packed filters uint8 [F, B] -> packed slices uint8 [B*8, P/8].

    ``num_filter_padded`` (P, multiple of 8) sets the output slice width;
    columns past F are zero. Matches the LSB-first layout of the .db format.
    """
    F = filters.shape[0]
    bits = unpack_bits_u8(filters)             # [F, B*8]
    bits_t = bits.T                            # [B*8, F]
    if num_filter_padded > F:
        bits_t = jnp.pad(bits_t, ((0, 0), (0, num_filter_padded - F)))
    return pack_bits_u8(bits_t)                # [B*8, P/8]


def transpose_chunks_device(
    filter_bytes: np.ndarray, chunk_bits: int = 1 << 20
) -> np.ndarray:
    """Full transpose of packed filters [F, L/8] -> packed slices [L, ceil(F/8)],
    streamed through the device in chunk_bits row chunks."""
    F, nbytes = filter_bytes.shape
    padded = (F + 7) // 8 * 8
    chunk_bytes = max(1, chunk_bits // 8)
    out = np.empty((nbytes * 8, padded // 8), dtype=np.uint8)
    for start in range(0, nbytes, chunk_bytes):
        stop = min(start + chunk_bytes, nbytes)
        res = transpose_bits_device(jnp.asarray(filter_bytes[:, start:stop]), padded)
        out[start * 8 : stop * 8] = np.asarray(res)
    return out
