"""Device (JAX) kernels vs the host/native reference implementations."""

import numpy as np
import pytest

import jax.numpy as jnp

from kwage.core.hash import murmur32_words
from kwage.core.words import canonical_kmers, sense_antisense_words
from kwage.ops.kmers import canonical_kmers_device, words_to_u64, u64_to_words
from kwage.ops.hashing import murmur32_device, slice_indices_device
from kwage.ops.transpose import transpose_chunks_device, transpose_bits_device
from kwage.ops.search import (
    DeviceSearcher,
    db_bytes_to_words,
    make_query_batch,
    search_complete,
    search_counts,
    unpack_mask,
)
from kwage.pipeline.build_db import transpose_filters

rng = np.random.default_rng(7)


def rand_seq(n, with_junk=False):
    alphabet = "ACGTacgtN" if with_junk else "ACGT"
    return "".join(rng.choice(list(alphabet)) for _ in range(n))


@pytest.mark.parametrize("k", [5, 11, 16, 17, 31, 32])
def test_device_kmers_match_host(k):
    seq = rand_seq(300, with_junk=True)
    ascii_u8 = jnp.asarray(np.frombuffer(seq.encode(), dtype=np.uint8))
    hi, lo, valid = canonical_kmers_device(ascii_u8, k)
    got = words_to_u64(hi, lo)[np.asarray(valid)]
    want = canonical_kmers(seq, k)
    np.testing.assert_array_equal(got, want)
    _, _, want_valid = sense_antisense_words(seq, k)
    np.testing.assert_array_equal(np.asarray(valid), want_valid)


@pytest.mark.parametrize("k", [4, 5, 16, 17, 31, 32])
def test_device_hash_matches_host(k):
    words = rng.integers(0, 1 << min(2 * k, 63), size=64, dtype=np.uint64)
    hi, lo = u64_to_words(words)
    got = np.asarray(murmur32_device(jnp.asarray(hi), jnp.asarray(lo), k, 5))
    want = murmur32_words(words, k, 5)
    np.testing.assert_array_equal(got, want)


def test_device_transpose_matches_host():
    F, L = 37, 4096  # deliberately non-multiple-of-8 filter count
    filters = rng.integers(0, 256, size=(F, L // 8), dtype=np.uint8)
    want = transpose_filters(filters)
    got = transpose_chunks_device(filters, chunk_bits=1024)
    np.testing.assert_array_equal(got, want)
    # single-shot path
    got2 = np.asarray(transpose_bits_device(jnp.asarray(filters), (F + 7) // 8 * 8))
    np.testing.assert_array_equal(got2, want)


def _make_db(num_filter=70, L=2048, k=31, num_hash=3):
    """Synthetic packed filters + transposed db + matching header."""
    from kwage.io.db_file import DBFileHeader

    filters = rng.integers(0, 256, size=(num_filter, L // 8), dtype=np.uint8)
    slices = transpose_filters(filters)
    hdr = DBFileHeader(
        kmer_len=k,
        num_hash=num_hash,
        log_2_filter_len=int(np.log2(L)),
        num_filter=num_filter,
        hash_func=0,
    )
    return filters, slices, hdr


def _host_counts(filters, idx, num_filter):
    """Reference host reduction from raw filters."""
    bits = np.unpackbits(filters, axis=1, bitorder="little")  # [F, L]
    n_kmer, n_hash = idx.shape
    counts = np.zeros(num_filter, dtype=np.int64)
    matched_all = np.ones(num_filter, dtype=bool)
    for i in range(n_kmer):
        km = np.ones(num_filter, dtype=bool)
        for h in range(n_hash):
            km &= bits[:, idx[i, h]].astype(bool)
        counts += km
        matched_all &= km
    return counts, matched_all


def test_device_search_matches_bruteforce():
    filters, slices, hdr = _make_db()
    db = jnp.asarray(db_bytes_to_words(slices))

    queries = [rand_seq(150), rand_seq(90), rand_seq(500)]
    idx, valid, nk = make_query_batch(queries, hdr.kmer_len, hdr.num_hash, hdr.log_2_filter_len)

    counts = np.asarray(search_counts(db, jnp.asarray(idx), jnp.asarray(valid)))[:, : hdr.num_filter]
    mask = unpack_mask(np.asarray(search_complete(db, jnp.asarray(idx), jnp.asarray(valid))), hdr.num_filter)

    for qi in range(len(queries)):
        want_counts, want_all = _host_counts(filters, idx[qi][valid[qi]], hdr.num_filter)
        np.testing.assert_array_equal(counts[qi], want_counts)
        np.testing.assert_array_equal(mask[qi], want_all)


def test_device_searcher_matches_host_engine(tmp_path):
    """DeviceSearcher hit lists == host engine hit lists on a real .db file."""
    from kwage.io.db_file import write_db_file, DBFileReader
    from kwage.core.info import FilterInfo
    from kwage.core.params import BloomParam
    from kwage.search.engine import search_database

    filters, slices, hdr = _make_db(num_filter=12, L=1024, num_hash=2)
    param = BloomParam(kmer_len=31, log_2_filter_len=10, num_hash=2, hash_func=0)
    path = tmp_path / "t.db"
    write_db_file(str(path), param, slices, [FilterInfo() for _ in range(12)])
    reader = DBFileReader(str(path))

    searcher = DeviceSearcher(reader.header, reader.read_slices())
    queries = [rand_seq(120), rand_seq(64)]
    for threshold in (1.0, 0.5, 0.25):
        dev = searcher.search(queries, threshold)
        for qi, q in enumerate(queries):
            host = search_database(reader, q, threshold, slices=slices)
            assert dev[qi] == host, (qi, threshold)


@pytest.mark.parametrize(
    "F,B,chunk_bits",
    [(32, 4, 1 << 20), (64, 16, 64), (256, 128, 256), (96, 20, 48), (37, 9, 24)],
)
def test_packed_bit_transpose_matches_unpack_oracle(F, B, chunk_bits):
    """The chunked device transpose of packed filter bytes equals the
    numpy unpack -> transpose -> pack oracle, for filter counts that are
    and are not multiples of 8 and chunks that do and do not divide B."""
    rng = np.random.default_rng(3)
    filters = rng.integers(0, 256, size=(F, B), dtype=np.uint8)
    got = transpose_chunks_device(filters, chunk_bits=chunk_bits)
    want_bits = np.unpackbits(filters, axis=1, bitorder="little").T  # [L, F]
    want = np.packbits(want_bits, axis=1, bitorder="little")
    assert np.array_equal(got, want), (F, B, chunk_bits)


def test_build_db_device_transpose_bytes_identical(tmp_path):
    """build_db with device=True (Pallas transpose path) produces the
    exact bytes of the host path."""
    import zlib

    from kwage.core import FilterInfo, str_to_accession
    from kwage.core.params import BloomParam
    from kwage.io.bloom_file import BloomFilterRecord, write_bloom_file
    from kwage.pipeline.build_db import build_db_from_bloom_files

    lrng = np.random.default_rng(9)
    param = BloomParam(kmer_len=31, log_2_filter_len=14, num_hash=3, hash_func=0)
    nb = param.filter_len // 8
    blooms = []
    for i in range(5):
        bits = lrng.integers(0, 256, size=nb, dtype=np.uint8)
        rec = BloomFilterRecord(
            param=param, crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
            info=FilterInfo(run_accession=str_to_accession(f"SRR{i+1}")), bits=bits,
        )
        p = tmp_path / f"f{i}.bloom"
        write_bloom_file(str(p), rec)
        blooms.append(str(p))
    host_db = tmp_path / "host.db"
    dev_db = tmp_path / "dev.db"
    build_db_from_bloom_files(str(host_db), param, blooms, chunk_bits=1 << 14)
    build_db_from_bloom_files(str(dev_db), param, blooms, chunk_bits=1 << 14, device=True)
    assert host_db.read_bytes() == dev_db.read_bytes()
