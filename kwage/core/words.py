"""2-bit DNA codec and canonical k-mer extraction (host / NumPy).

Semantics match the reference k-mer toolbox (word.h:19, word.h:73-168):

- bases are encoded lexicographically A=0, C=1, G=2, T=3 so that the
  canonical k-mer definition agrees with the original BIGSI python,
- a k-mer word packs bases MSB-first: the *first* base of the k-mer
  occupies the highest 2 bits of the 2k-bit word,
- the canonical word is ``min(sense, reverse_complement)`` compared as
  unsigned integers,
- any non-ACGT character resets the rolling window, i.e. a window is only
  valid when all k of its bases are ACGT (word.h:101-103).

The device-side (JAX) equivalent lives in ``kwage.ops.kmers``; this
module is the reference host implementation used for ingest parity and
as the test oracle for the device path.
"""

from __future__ import annotations

import numpy as np

MAX_WORD_LEN = 32
BITS_PER_BASE = 2

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3

_BASES = "ACGT"

# 256-entry code lookup: ACGT/acgt -> 0..3, everything else -> 255 (invalid).
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE_LUT[_b] = _i


def kmer_word_mask(k: int) -> int:
    """Bit mask covering the 2k low bits of a k-mer word (word.cpp:9-23)."""
    if not 1 <= k <= MAX_WORD_LEN:
        raise ValueError(f"k-mer length {k} out of range [1, {MAX_WORD_LEN}]")
    if k == MAX_WORD_LEN:
        return 0xFFFFFFFFFFFFFFFF
    return (1 << (BITS_PER_BASE * k)) - 1


def encode_bases(seq: str | bytes) -> np.ndarray:
    """Encode a DNA sequence into uint8 codes; non-ACGT -> 255."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[raw]


def word_to_string(word: int, k: int) -> str:
    """Decode a 2-bit packed word back to an ACGT string (word.cpp:25-56)."""
    out = []
    for i in range(k):
        out.append(_BASES[(int(word) >> (BITS_PER_BASE * (k - 1 - i))) & 3])
    return "".join(out)


def string_to_word(kmer: str) -> int:
    """Pack an ACGT string into a 2-bit word (first base in the high bits)."""
    w = 0
    for ch in kmer:
        code = int(_CODE_LUT[ord(ch)])
        if code == 255:
            raise ValueError(f"invalid base {ch!r} in k-mer")
        w = (w << BITS_PER_BASE) | code
    return w


def sense_antisense_words(
    seq: str | bytes | np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized duplex digest of a sequence.

    Returns ``(sense, antisense, valid)`` arrays of length ``len(seq)-k+1``
    (empty when the sequence is shorter than k). ``valid[p]`` is True iff
    all k bases of the window starting at p are ACGT, reproducing the
    window-reset semantics of the ForEachDuplexWord macro (word.h:73-104).
    """
    codes = seq if isinstance(seq, np.ndarray) else encode_bases(seq)
    n = codes.shape[0]
    if n < k:
        e = np.empty(0, dtype=np.uint64)
        return e, e.copy(), np.empty(0, dtype=bool)

    nwin = n - k + 1
    invalid = codes == 255
    # valid window <=> zero invalid bases among codes[p:p+k]
    cs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(invalid, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0

    c = np.where(invalid, 0, codes).astype(np.uint64)
    comp = np.uint64(3) - c

    sense = np.zeros(nwin, dtype=np.uint64)
    anti = np.zeros(nwin, dtype=np.uint64)
    two = np.uint64(2)
    for j in range(k):
        sense = (sense << two) | c[j : j + nwin]
        anti |= comp[j : j + nwin] << np.uint64(BITS_PER_BASE * j)
    return sense, anti, valid


def canonical_kmers(seq: str | bytes | np.ndarray, k: int) -> np.ndarray:
    """All valid canonical k-mer words of ``seq`` in sequence order.

    Equivalent to collecting ``CanonicalWord`` for every ``ValidWord``
    position of the ForEachDuplexWord macro (word.h:73-168).
    """
    sense, anti, valid = sense_antisense_words(seq, k)
    return np.minimum(sense, anti)[valid]


def unique_canonical_kmers(seq: str | bytes | np.ndarray, k: int) -> np.ndarray:
    """Sorted unique canonical k-mers of a query (kwage.cpp:352-366)."""
    return np.unique(canonical_kmers(seq, k))


def thresholded_unique(sorted_words: np.ndarray, threshold: int) -> np.ndarray:
    """Unique elements occurring at least ``threshold`` times (word.h:46-70).

    Input must be sorted.
    """
    if sorted_words.size == 0:
        return sorted_words
    vals, counts = np.unique(sorted_words, return_counts=True)
    return vals[counts >= threshold]
