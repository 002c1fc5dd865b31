"""Corrupt/truncated on-disk inputs must fail with clean errors, matching
the reference's runtime self-checks (crc validation, magic bytes,
incomplete-filter detection)."""

import struct
import zlib

import numpy as np
import pytest

from kwage.core import FilterInfo, str_to_accession
from kwage.core.params import BloomParam
from kwage.io.bloom_file import BloomFilterRecord, read_bloom_file, write_bloom_file
from kwage.io.db_file import DBFileReader, write_db_file
from kwage.io.dbz_file import DBZFileReader, open_database
from kwage.pipeline.build_db import build_db_from_bloom_files, transpose_filters


@pytest.fixture()
def artifacts(tmp_path):
    rng = np.random.default_rng(4)
    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    nb = param.filter_len // 8
    blooms = []
    for i in range(3):
        bits = rng.integers(0, 256, size=nb, dtype=np.uint8)
        rec = BloomFilterRecord(
            param=param,
            crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
            info=FilterInfo(run_accession=str_to_accession(f"SRR{i+1}")),
            bits=bits,
        )
        p = tmp_path / f"f{i}.bloom"
        write_bloom_file(str(p), rec)
        blooms.append(str(p))
    db = tmp_path / "x.db"
    build_db_from_bloom_files(str(db), param, blooms)
    return tmp_path, param, blooms, str(db)


def test_incomplete_bloom_rejected(artifacts):
    tmp_path, param, blooms, db = artifacts
    data = bytearray(open(blooms[0], "rb").read())
    data[0] = 0x00  # in-progress magic
    open(blooms[0], "wb").write(bytes(data))
    with pytest.raises(ValueError):
        read_bloom_file(blooms[0])
    # build_db validates completion too (build_db.cpp:80-94)
    with pytest.raises(ValueError):
        build_db_from_bloom_files(str(tmp_path / "y.db"), param, blooms)


def test_bloom_bit_corruption_fails_crc_during_transpose(artifacts):
    tmp_path, param, blooms, db = artifacts
    data = bytearray(open(blooms[1], "rb").read())
    data[-1] ^= 0xFF  # flip filter bits; crc32 now stale
    open(blooms[1], "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc32"):
        build_db_from_bloom_files(str(tmp_path / "y.db"), param, blooms)


def test_db_bad_magic_rejected(artifacts):
    tmp_path, param, blooms, db = artifacts
    data = bytearray(open(db, "rb").read())
    data[0] ^= 0xFF
    bad = tmp_path / "bad.db"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        DBFileReader(str(bad))
    with pytest.raises(ValueError):
        open_database(str(bad))


def test_db_slice_corruption_detected_by_crc(artifacts):
    tmp_path, param, blooms, db = artifacts
    data = bytearray(open(db, "rb").read())
    data[100] ^= 0x01  # inside the slice region
    bad = tmp_path / "bad.db"
    bad.write_bytes(bytes(data))
    assert DBFileReader(str(db)).verify_crc32()
    assert not DBFileReader(str(bad)).verify_crc32()


def test_dbz_corrupt_chunk_raises(artifacts, tmp_path):
    from kwage.pipeline.build_db import build_dbz_from_bloom_files

    _, param, blooms, _ = artifacts
    dbz = tmp_path / "x.dbz"
    build_dbz_from_bloom_files(str(dbz), param, blooms, chunk_bits=1 << 12)
    data = bytearray(dbz.read_bytes())
    # Clobber compressed bytes past the chunk index.
    hdr_end = 44 + 4 + 8 + 8 * DBZFileReader(str(dbz)).num_chunks
    data[hdr_end + 4] ^= 0xFF
    bad = tmp_path / "bad.dbz"
    bad.write_bytes(bytes(data))
    with pytest.raises((zlib.error, ValueError)):
        DBZFileReader(str(bad)).read_slices()


def test_truncated_db_read_raises(artifacts, tmp_path):
    _, param, blooms, db = artifacts
    data = open(db, "rb").read()
    bad = tmp_path / "trunc.db"
    bad.write_bytes(data[: len(data) // 4])
    reader = DBFileReader(str(bad))  # header parses
    with pytest.raises(Exception):
        reader.read_all_filter_info()
