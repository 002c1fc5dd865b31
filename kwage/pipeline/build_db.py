"""Filter -> bit-slice transposition (the reference's build_db).

The BIGSI core move: N same-shape Bloom filters (rows = filters, columns =
filter bits) become 2**L bit slices (rows = bit positions, columns =
filters), so a query probes num_hash slice rows instead of N filters.

The host path streams the inputs in row chunks and transposes with
vectorized numpy bit unpack/pack (equivalent to the byte-scatter loop in
build_db.cpp:259-315, but O(bits) with no per-bit branches). The device
path lives in kwage.ops.transpose.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..core.params import BloomParam
from ..io.bloom_file import (
    BLOOM_MAGIC_COMPLETE,
    read_bloom_file,
)
from ..io.binary import BinaryReader
from ..io.db_file import DBFileHeader, write_db_file_streaming

# 1 GiB destination buffer in the reference (build_db.cpp:243); the numpy
# path is not seek-bound so a smaller default keeps memory modest.
# 2^21 bits (256 KB per filter per chunk), not 2^22: past ~256 KB row
# stride the native transpose's per-j-sweep source working set outgrows
# the (huge-page) TLB and throughput drops 2.6x (measured warm on this
# box: 609/517/514/198 MB/s at 2^18/20/21/22) -- and the block buffer at
# quota width (2048 filters) stays 512 MB instead of 1 GiB. Production-L
# filters (L >= 22) stream in multiple chunks; L <= 21 is one chunk
# either way.
DEFAULT_CHUNK_BITS = 1 << 21


def transpose_filters(filter_bytes: np.ndarray, num_filter: int | None = None) -> np.ndarray:
    """Transpose packed filters [F, L/8] -> packed slices [L, ceil(F/8)].

    Bits are LSB-first within each byte on both sides (bloom.h:140-171).
    Native 64x64-bit-block path when the library is present (~50x the
    numpy unpack/transpose/pack below, which was the dominant cost of
    every 2048-filter .db pack); the numpy path is the fallback twin.
    """
    F, nbytes = filter_bytes.shape
    if num_filter is None:
        num_filter = F
    if num_filter < F:
        raise ValueError(f"num_filter ({num_filter}) < source rows ({F})")
    from ..native import transpose_bits_native

    out = transpose_bits_native(filter_bytes, num_filter)
    if out is not None:
        return out
    # [F, L] bits; unpackbits is MSB-first, so request little-endian order.
    bits = np.unpackbits(filter_bytes, axis=1, bitorder="little")
    slices = np.packbits(bits.T, axis=1, bitorder="little")
    want = (num_filter + 7) // 8
    if slices.shape[1] < want:
        slices = np.pad(slices, ((0, 0), (0, want - slices.shape[1])))
    return slices


def _iter_transposed_chunks(
    paths: list[str], param: BloomParam, chunk_bits: int, device: bool = False
):
    """Yield transposed slice chunks while streaming all inputs in lockstep,
    validating per-filter crc32 like build_db.cpp:280-286, 343-362.

    ``device=True`` runs each chunk through the Pallas packed bit-transpose
    (4x the host/unpack path on-chip; only worthwhile where host<->device
    bandwidth is PCIe-class)."""
    num_filter = len(paths)
    filter_len = param.filter_len
    chunk_bytes = chunk_bits // 8

    handles = []
    expected_crc = []
    running_crc = []
    try:
        for p in paths:
            f = open(p, "rb")
            r = BinaryReader(f)
            magic = r.u8()
            if magic != BLOOM_MAGIC_COMPLETE:
                raise ValueError(f"{p}: incomplete Bloom filter")
            local = r.bloom_param()
            if local != param:
                raise ValueError(f"{p}: inconsistent Bloom parameters {local} != {param}")
            expected_crc.append(r.u32())
            r.filter_info()  # skip; re-read separately for the metadata block
            handles.append(f)
            running_crc.append(zlib.crc32(b""))

        for start in range(0, filter_len, chunk_bits):
            nbits = min(chunk_bits, filter_len - start)
            nbytes = nbits // 8
            block = np.empty((num_filter, nbytes), dtype=np.uint8)
            for j, f in enumerate(handles):
                data = f.read(nbytes)
                if len(data) != nbytes:
                    raise ValueError(f"{paths[j]}: truncated filter data")
                running_crc[j] = zlib.crc32(data, running_crc[j])
                block[j] = np.frombuffer(data, dtype=np.uint8)
            if device:
                from ..ops.transpose import transpose_chunks_device

                yield transpose_chunks_device(block, chunk_bits=nbits)[
                    :, : (num_filter + 7) // 8
                ]
            else:
                yield transpose_filters(block, num_filter)

        for j in range(num_filter):
            if (running_crc[j] & 0xFFFFFFFF) != expected_crc[j]:
                raise ValueError(f"{paths[j]}: invalid Bloom filter crc32")
    finally:
        for f in handles:
            f.close()


def build_db_from_bloom_files(
    out_path: str,
    param: BloomParam,
    bloom_files: list[str],
    chunk_bits: int = DEFAULT_CHUNK_BITS,
    device: bool = False,
) -> DBFileHeader:
    """Transpose .bloom files into a .db database file (build_db.cpp:24-456).

    Byte-identical output to the reference for the same inputs; streaming
    with bounded memory ~ num_filter * chunk_bits bits.
    """
    if not bloom_files:
        raise ValueError("empty Bloom filter inventory")
    if chunk_bits % 8:
        raise ValueError("chunk_bits must be byte aligned")

    infos = [read_bloom_file(p, with_bits=False).info for p in bloom_files]

    return write_db_file_streaming(
        out_path,
        param,
        _iter_transposed_chunks(bloom_files, param, chunk_bits, device=device),
        infos,
        num_filter=len(bloom_files),
    )


def build_dbz_from_bloom_files(
    out_path: str,
    param: BloomParam,
    bloom_files: list[str],
    chunk_bits: int = DEFAULT_CHUNK_BITS,
    level: int = 6,
) -> DBFileHeader:
    """Transpose .bloom files into a compressed .dbz database file.

    Engine extension (the reference reserves the header field and the
    .dbz name but never implements compression; see io/dbz_file.py).
    Searching a .dbz yields hit lists identical to the equivalent .db.
    """
    from ..io.dbz_file import write_dbz_file_streaming

    if not bloom_files:
        raise ValueError("empty Bloom filter inventory")
    if chunk_bits % 8:
        raise ValueError("chunk_bits must be byte aligned")

    infos = [read_bloom_file(p, with_bits=False).info for p in bloom_files]
    return write_dbz_file_streaming(
        out_path,
        param,
        _iter_transposed_chunks(bloom_files, param, chunk_bits),
        infos,
        num_filter=len(bloom_files),
        level=level,
    )
