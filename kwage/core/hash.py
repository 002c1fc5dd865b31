"""Murmur3-32 hashing of canonical k-mers (host / NumPy, seed-vectorized).

Reproduces the reference hash exactly (hash.cpp:114-332): the hash is
computed over the *decoded ASCII string* of the canonical k-mer (bases
rendered via "ACGT"[code], word.h:31-34), with the hash-function index
(0..num_hash-1) as the murmur seed. The reference's AVX2 8-seed SIMD pass
(hash.cpp:239-332) becomes a vectorized seed axis here and a vector lane
axis in the device kernel (kwage.ops.hashing).

The caller maps a hash value onto a filter with ``% filter_len`` (always a
power of two in this system, so ``& (2**L - 1)``).
"""

from __future__ import annotations

import numpy as np

# Hash function enum (hash.h:8-11)
MURMUR_HASH_32 = 0
UNKNOWN_HASH = 1

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_C3 = np.uint32(0xE6546B64)
_FMIX1 = np.uint32(0x85EBCA6B)
_FMIX2 = np.uint32(0xC2B2AE35)

# ASCII codes of "ACGT" indexed by the 2-bit base code.
_ASCII = np.array([65, 67, 71, 84], dtype=np.uint32)

MAX_SIMD_SEEDS = 8  # hash.cpp:7 (NUM_SIMD_HASH)


def hash_name(func: int) -> str:
    if func == MURMUR_HASH_32:
        return "murmur32"
    if func == UNKNOWN_HASH:
        return "unknown"
    raise ValueError(f"unknown hash function id {func}")


def parse_hash_function_name(name: str) -> int:
    name = name.lower()
    for f in range(UNKNOWN_HASH):
        if name == hash_name(f):
            return f
    return UNKNOWN_HASH


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - int(r)))


def _fmix(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h = h * _FMIX1
    h ^= h >> np.uint32(13)
    h = h * _FMIX2
    h ^= h >> np.uint32(16)
    return h


def _base_ascii(words: np.ndarray, k: int, i: int) -> np.ndarray:
    """ASCII byte of base ``i`` (0-based from the 5' end) of each word."""
    shift = np.uint64(2 * (k - 1 - i))
    return _ASCII[((words >> shift) & np.uint64(3)).astype(np.intp)]


def murmur32_words(words: np.ndarray, k: int, num_seeds: int) -> np.ndarray:
    """Murmur3-32 of each k-mer word for seeds 0..num_seeds-1.

    ``words``: uint64 array of 2-bit packed canonical k-mers.
    Returns uint32 array of shape ``(len(words), num_seeds)``.

    Matches hash.cpp:239-332 (the block bytes are the ASCII bases in
    sequence order, packed little-endian into each 4-byte block).
    """
    words = np.asarray(words, dtype=np.uint64)
    n = words.shape[0]
    nblocks = k // 4
    tail = k & 3

    h = np.tile(np.arange(num_seeds, dtype=np.uint32), (n, 1))

    for blk in range(nblocks):
        k1 = np.zeros(n, dtype=np.uint32)
        for byte in range(4):
            k1 |= _base_ascii(words, k, blk * 4 + byte) << np.uint32(8 * byte)
        k1 = k1 * _C1
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2
        h ^= k1[:, None]
        h = _rotl32(h, 13)
        h = h * np.uint32(5) + _C3

    if tail:
        k1 = np.zeros(n, dtype=np.uint32)
        for t in range(tail):
            k1 ^= _base_ascii(words, k, nblocks * 4 + t) << np.uint32(8 * t)
        k1 = k1 * _C1
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2
        h ^= k1[:, None]

    h ^= np.uint32(k)
    return _fmix(h)


def murmur32_string(s: str | bytes, seed: int) -> int:
    """Scalar murmur3-32 over an arbitrary byte string (hash.cpp:114-170)."""
    with np.errstate(over="ignore"):
        return _murmur32_string(s, seed)


def _murmur32_string(s: str | bytes, seed: int) -> int:
    if isinstance(s, str):
        s = s.encode("ascii")
    data = np.frombuffer(s, dtype=np.uint8)
    n = data.shape[0]
    nblocks = n // 4

    h = np.uint32(seed)
    for i in range(nblocks):
        k1 = np.uint32(
            int(data[4 * i])
            | (int(data[4 * i + 1]) << 8)
            | (int(data[4 * i + 2]) << 16)
            | (int(data[4 * i + 3]) << 24)
        )
        k1 = k1 * _C1
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2
        h = h ^ k1
        h = _rotl32(h, 13)
        h = h * np.uint32(5) + _C3

    tail = n & 3
    if tail:
        k1 = np.uint32(0)
        off = nblocks * 4
        for t in range(tail):
            k1 = k1 ^ np.uint32(int(data[off + t]) << (8 * t))
        k1 = k1 * _C1
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2
        h = h ^ k1

    h = h ^ np.uint32(n)
    return int(_fmix(h))


def bigsi_hash(words: np.ndarray, k: int, num_seeds: int, func: int = MURMUR_HASH_32) -> np.ndarray:
    """Multi-seed hash dispatch (hash.cpp:97-108)."""
    if func != MURMUR_HASH_32:
        raise ValueError("unknown hash function")
    return murmur32_words(words, k, num_seeds)


def slice_indices(words: np.ndarray, k: int, num_hash: int, log2_filter_len: int,
                  func: int = MURMUR_HASH_32) -> np.ndarray:
    """Per-(k-mer, seed) bit-slice row indices: murmur % 2**L (kwage.cpp:411-413)."""
    h = bigsi_hash(words, k, num_hash, func)
    mask = np.uint32((1 << log2_filter_len) - 1) if log2_filter_len < 32 else np.uint32(0xFFFFFFFF)
    return h & mask
