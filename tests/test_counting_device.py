"""Device exact-count thresholding vs the host/native parity path and
exact ground truth (the device reformulation of make_bloom.cpp:506-621)."""

from collections import Counter

import numpy as np
import pytest

from kwage.core import FilterInfo
from kwage.core.words import canonical_kmers
from kwage.native import murmur32_native
from kwage.pipeline import BuildOptions
from kwage.pipeline.make_bloom import (
    build_bloom_device,
    build_bloom_from_sequences,
)


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(5)
    uniq = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(10)]
    # Some reads repeated 3x so min_count=3 has survivors; one with an N.
    noisy = uniq[0][:120] + "N" + uniq[1][:100]
    return uniq + uniq[:5] + uniq[:5] + [noisy]


def _opts(min_count):
    return BuildOptions(
        kmer_len=31,
        min_kmer_count=min_count,
        false_positive_probability=0.25,
        min_log_2_filter_len=14,
        max_log_2_filter_len=20,
        min_log_2_count_len=18,
        max_log_2_count_len=20,
    )


def _exact_filter(reads, k, min_count, num_hash, log2_len):
    counts = Counter()
    for r in reads:
        counts.update(canonical_kmers(r, k).tolist())
    words = np.array(
        sorted(w for w, c in counts.items() if c >= min_count), dtype=np.uint64
    )
    out = np.zeros((1 << log2_len) // 8, dtype=np.uint8)
    if words.size:
        h = murmur32_native(words, k, num_hash)
        idx = (h & np.uint32((1 << log2_len) - 1)).reshape(-1).astype(np.uint64)
        np.bitwise_or.at(
            out, (idx >> 3).astype(np.int64), np.uint8(1) << (idx & 7).astype(np.uint8)
        )
    return words.shape[0], out


@pytest.mark.parametrize("min_count", [1, 3])
def test_device_build_matches_exact_ground_truth(reads, min_count):
    rec = build_bloom_device(iter(reads), _opts(min_count), FilterInfo())
    n_exact, gt = _exact_filter(
        reads, 31, min_count, rec.param.num_hash, rec.param.log_2_filter_len
    )
    assert rec.bits.tobytes() == gt.tobytes()
    assert rec.test_crc32()


def test_device_matches_host_parity_path(reads):
    # Collision-free counting filter => the reference algorithm is exact
    # too and the two paths must agree bit for bit (param included).
    opts = _opts(1)
    dev = build_bloom_device(iter(reads), opts, FilterInfo())
    host = build_bloom_from_sequences(iter(reads), opts, FilterInfo())
    assert dev.param == host.param
    assert dev.bits.tobytes() == host.bits.tobytes()


def test_streaming_chunks_merge_counts_across_batches(reads):
    # Force many tiny device chunks: duplicate reads land in DIFFERENT
    # chunks, so min_count=3 survivors exist only if counts merge globally.
    whole = build_bloom_device(iter(reads), _opts(3), FilterInfo())
    chunked = build_bloom_device(iter(reads), _opts(3), FilterInfo(), chunk_bp=700)
    assert whole.param == chunked.param
    assert whole.bits.tobytes() == chunked.bits.tobytes()


def test_device_min_count_filters_noise(reads):
    # min_count=3: only the 3x-repeated reads' k-mers survive.
    rec = build_bloom_device(iter(reads), _opts(3), FilterInfo())
    n_exact, _ = _exact_filter(reads, 31, 3, rec.param.num_hash, rec.param.log_2_filter_len)
    assert n_exact > 0
    # Every surviving k-mer must be found by a membership probe.
    counts = Counter()
    for r in reads:
        counts.update(canonical_kmers(r, 31).tolist())
    words = np.array([w for w, c in counts.items() if c >= 3], dtype=np.uint64)
    h = murmur32_native(words, 31, rec.param.num_hash)
    idx = h & np.uint32(rec.param.filter_len - 1)
    bits = np.unpackbits(rec.bits, bitorder="little")
    assert bits[idx.reshape(-1)].all()


def test_device_build_large_filter_host_scatter(reads):
    """log2_filter_len >= 31 (reference-legal up to 32) exceeds the device
    scatter's int32 index math; the final bit-set must run on the host and
    still match the host-parity builder bit-for-bit."""
    opts = BuildOptions(
        kmer_len=31,
        min_kmer_count=1,
        false_positive_probability=0.25,
        min_log_2_filter_len=31,
        max_log_2_filter_len=32,
        min_log_2_count_len=18,
        max_log_2_count_len=20,
    )
    dev = build_bloom_device(iter(reads), opts, FilterInfo())
    assert dev.param.log_2_filter_len == 31
    host = build_bloom_from_sequences(iter(reads), opts, FilterInfo())
    assert dev.param == host.param
    assert dev.bits.tobytes() == host.bits.tobytes()
    assert dev.test_crc32()


def test_batched_device_build_matches_single(reads):
    """build_blooms_device_batch == per-accession build_bloom_device for
    every job, including BloomInvalid fault isolation."""
    from kwage.pipeline.make_bloom import (
        BloomInvalid,
        build_bloom_device,
        build_blooms_device_batch,
    )

    rng = np.random.default_rng(7)
    jobs = []
    per_acc = []
    for a in range(5):
        n = int(rng.integers(4, 9))
        seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 200))))
                for _ in range(n)]
        seqs = seqs + seqs[:2]  # duplicates so min_count=2 keeps signal
        jobs.append((seqs, FilterInfo()))
        per_acc.append(seqs)
    # One job with no read >= k: must fail alone without hurting the batch.
    jobs.append((["ACGT"], FilterInfo()))

    opts = _opts(2)
    got = build_blooms_device_batch(jobs, opts)
    for a in range(5):
        want = build_bloom_device(iter(per_acc[a]), opts, FilterInfo())
        assert not isinstance(got[a], Exception), got[a]
        assert got[a].param == want.param, a
        assert got[a].bits.tobytes() == want.bits.tobytes(), a
    assert isinstance(got[5], BloomInvalid)


def test_batched_device_build_mixed_filter_lengths():
    """Accessions whose distinct-k-mer counts land in different L buckets
    split into per-(L, num_hash) scatter groups and still match."""
    from kwage.pipeline.make_bloom import (
        build_bloom_device,
        build_blooms_device_batch,
    )

    rng = np.random.default_rng(11)
    small = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(2)]
    big = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(40)]
    opts = BuildOptions(
        kmer_len=31, min_kmer_count=1, false_positive_probability=0.25,
        min_log_2_filter_len=8, max_log_2_filter_len=20,
        min_log_2_count_len=12, max_log_2_count_len=20,
    )
    jobs = [(small, FilterInfo()), (big, FilterInfo())]
    got = build_blooms_device_batch(jobs, opts)
    for j, seqs in enumerate([small, big]):
        want = build_bloom_device(iter(seqs), opts, FilterInfo())
        assert got[j].param == want.param
        assert got[j].bits.tobytes() == want.bits.tobytes()
    assert got[0].param.log_2_filter_len != got[1].param.log_2_filter_len


def test_device_build_parity_envelope():
    """The documented envelope (README 'Device-build parity envelope'):
    with a collision-free counting filter, device (exact-count) and host
    (counting-Bloom) builds are bit-identical at min_count > 1; when the
    counting filter is forced to alias, they diverge -- and the device
    side equals the exact ground truth, proving the divergence is the
    reference approximation's, not ours."""
    import numpy as np

    from kwage.core.info import FilterInfo
    from kwage.core.words import canonical_kmers
    from kwage.pipeline.make_bloom import (
        BuildOptions,
        build_bloom_device,
        build_bloom_from_sequences,
    )

    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(40)]
    reads += reads[:15]  # repeats so min_count=2 passes some k-mers

    def exact_valid_count(k, min_count):
        from collections import Counter

        c = Counter()
        for s in reads:
            c.update(canonical_kmers(s, k).tolist())
        return sum(1 for v in c.values() if v >= min_count)

    # Collision-free sizing: bit-identical.
    free = BuildOptions(kmer_len=15, min_kmer_count=2,
                        min_log_2_count_len=22, max_log_2_count_len=22,
                        min_log_2_filter_len=10, max_log_2_filter_len=16)
    host = build_bloom_from_sequences(list(reads), free, FilterInfo())
    dev = build_bloom_device(list(reads), free, FilterInfo())
    assert host.bits.tobytes() == dev.bits.tobytes()
    assert host.param == dev.param

    # Forced aliasing: the counting path deviates; the device path stays
    # on the exact ground truth.
    tight = BuildOptions(kmer_len=15, min_kmer_count=2,
                         min_log_2_count_len=7, max_log_2_count_len=7,
                         min_log_2_filter_len=10, max_log_2_filter_len=16)
    host_a = build_bloom_from_sequences(list(reads), tight, FilterInfo())
    dev_a = build_bloom_device(list(reads), tight, FilterInfo())
    assert dev_a.bits.tobytes() != host_a.bits.tobytes()
    from kwage.core.params import optimal_bloom_param

    assert dev_a.param == optimal_bloom_param(
        15, exact_valid_count(15, 2), tight.false_positive_probability,
        tight.hash_func, tight.min_log_2_filter_len,
        tight.max_log_2_filter_len)


def _pack_strided_reference(image):
    """The earlier formulation of _pack_bit_image: 32 strided column
    slices of a [rows, 4096] view, OR-folded with shifts."""
    import jax.numpy as jnp

    n = image.shape[0]
    width = min(4096, n)
    img = image.reshape(-1, width)
    packed = jnp.zeros((img.shape[0], width // 32), jnp.uint32)
    for b in range(32):
        packed = packed | (img[:, b::32].astype(jnp.uint32) << b)
    return packed.reshape(-1)


@pytest.mark.parametrize("log2_len", [5, 6, 9, 12, 13, 15])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_pack_bit_image_matches_strided_formulation(log2_len, density):
    """The packbits formulation equals the strided one it replaced, and
    the little-endian word layout of np.packbits viewed as uint32."""
    import jax.numpy as jnp

    from kwage.ops.counting import _pack_bit_image

    rng = np.random.default_rng(log2_len)
    image = (rng.random(1 << log2_len) < density).astype(np.uint8)
    got = np.asarray(_pack_bit_image(jnp.asarray(image)))
    assert got.dtype == np.uint32 and got.shape == ((1 << log2_len) // 32,)
    np.testing.assert_array_equal(got, np.asarray(_pack_strided_reference(jnp.asarray(image))))
    np.testing.assert_array_equal(got, np.packbits(image, bitorder="little").view("<u4"))
