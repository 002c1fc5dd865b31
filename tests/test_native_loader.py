"""Native file digester vs the Python reader: identical records, counts,
and .bloom bits on FASTA/FASTQ, gzipped or plain, including parser quirks."""

import gzip

import numpy as np
import pytest

from kwage.core import FilterInfo
from kwage.io.sequence import FASTA, FASTQ, iter_sequences
from kwage.native import CountingBuilder, available, scan_file_native
from kwage.pipeline import BuildOptions, build_bloom_from_file, build_bloom_from_sequences

pytestmark = pytest.mark.skipif(not available(), reason="native library unavailable")


def _python_build(path, opts):
    seqs = [s for _, s in iter_sequences(path)]
    info = FilterInfo()
    info.number_of_bases = sum(len(s) for s in seqs)
    info.number_of_spots = len(seqs)
    return build_bloom_from_sequences(iter(seqs), opts, info, num_bp_hint=info.number_of_bases)


OPTS = BuildOptions(
    kmer_len=31, min_kmer_count=1, min_log_2_filter_len=12,
    max_log_2_filter_len=18, min_log_2_count_len=12, max_log_2_count_len=18,
)


@pytest.fixture()
def seqs():
    rng = np.random.default_rng(21)
    return ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(20)]


def test_fasta_plain_and_gz(tmp_path, seqs):
    body = ""
    for i, s in enumerate(seqs):
        # multi-line records with whitespace and lowercase mixed in
        body += f">read {i}\n{s[:80].lower()}\n {s[80:]}\n"
    plain = tmp_path / "x.fasta"
    plain.write_text(body)
    gz = tmp_path / "x.fasta.gz"
    with gzip.open(gz, "wt") as f:
        f.write(body)

    for path in (plain, gz):
        assert scan_file_native(str(path), FASTA) == (20, 200 * 20)
        nat = build_bloom_from_file(str(path), OPTS)
        ref = _python_build(str(path), OPTS)
        assert nat.param == ref.param
        assert nat.bits.tobytes() == ref.bits.tobytes()
        assert nat.info.number_of_spots == 20


def test_fasta_midline_defline_quirk(tmp_path, seqs):
    # The reference treats any line CONTAINING '>' as a defline
    # (parse_sequence.cpp:86); both readers must agree.
    body = f">a\n{seqs[0]}\nxx>weird defline\n{seqs[1]}\n"
    path = tmp_path / "q.fasta"
    path.write_text(body)
    py = [s for _, s in iter_sequences(str(path))]
    assert py == [seqs[0], seqs[1]]
    assert scan_file_native(str(path), FASTA) == (2, len(seqs[0]) + len(seqs[1]))


def test_fastq_plain_and_gz(tmp_path, seqs):
    body = ""
    for i, s in enumerate(seqs):
        body += f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
    plain = tmp_path / "x.fastq"
    plain.write_text(body)
    gz = tmp_path / "x.fastq.gz"
    with gzip.open(gz, "wt") as f:
        f.write(body)
    for path in (plain, gz):
        assert scan_file_native(str(path), FASTQ) == (20, 200 * 20)
        nat = build_bloom_from_file(str(path), OPTS)
        ref = _python_build(str(path), OPTS)
        assert nat.bits.tobytes() == ref.bits.tobytes()


def test_fastq_no_trailing_newline(tmp_path, seqs):
    path = tmp_path / "x.fastq"
    path.write_text(f"@r0\n{seqs[0]}\n+\n{'I' * 200}")  # qual line unterminated
    assert scan_file_native(str(path), FASTQ) == (1, 200)


def test_fastq_truncated_raises(tmp_path, seqs):
    path = tmp_path / "x.fastq"
    path.write_text(f"@r0\n{seqs[0]}\n+\n{'I'*200}\n@r1\n{seqs[1]}\n")
    with pytest.raises(ValueError):
        scan_file_native(str(path), FASTQ)
    with pytest.raises(ValueError):
        list(iter_sequences(str(path)))  # the Python reader agrees


def test_empty_records_skipped(tmp_path, seqs):
    path = tmp_path / "x.fasta"
    path.write_text(f">a\n\n>b\n{seqs[0]}\n>c\n")
    assert [s for _, s in iter_sequences(str(path))] == [seqs[0]]
    assert scan_file_native(str(path), FASTA) == (1, 200)


def test_fastq_missing_quality_line_raises(tmp_path, seqs):
    # EOF right after the '+' line's newline: quality line absent entirely.
    path = tmp_path / "x.fastq"
    path.write_text(f"@r0\n{seqs[0]}\n+\n")
    with pytest.raises(ValueError):
        scan_file_native(str(path), FASTQ)
    with pytest.raises(ValueError):
        list(iter_sequences(str(path)))


def test_native_scan_and_pack_match_python(tmp_path):
    """kn_scan_file/kn_pack_file == the Python parse + pack_reads_host on
    multi-line, lowercase, N-containing, whitespace-laden FASTA."""
    import numpy as np

    from kwage.io.sequence import iter_sequences
    from kwage.native import (
        available,
        pack_file_native,
        scan_file_batch_native,
    )
    from kwage.ops.kmers import pack_reads_host

    if not available():
        import pytest

        pytest.skip("native library unavailable")

    fa = tmp_path / "tricky.fasta"
    fa.write_text(
        ">r1 desc\nACGTacgtNNACGT\nGGTT aa\n"
        ">r2\nAC\n"              # shorter than k: scanned, not packed
        ">r3\n\n"                 # empty: skipped entirely
        ">r4\ntTtTgGgGcCcCaAaA\n"
    )
    k = 5
    spots, bp, rows, max_len = scan_file_batch_native(str(fa), 0, k)
    seqs = [s for _, s in iter_sequences(str(fa))]
    longs = [s for s in seqs if len(s) >= k]
    assert spots == len(seqs)
    assert bp == sum(len(s) for s in seqs)
    assert rows == len(longs)
    assert max_len == max(len(s) for s in longs)

    blen = 128
    packed = np.zeros((4, blen // 16), np.uint32)
    valid = np.zeros((4, blen // 32), np.uint32)
    n = pack_file_native(str(fa), 0, k, 1, rows, packed, valid)  # row_off=1
    assert n == rows
    block = np.zeros((len(longs), blen), np.uint8)
    for i, s in enumerate(longs):
        block[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    p_want, v_want = pack_reads_host(block)
    assert np.array_equal(packed[1 : 1 + n], p_want)
    assert np.array_equal(valid[1 : 1 + n], v_want)
    assert not packed[0].any() and not valid[0].any()


def test_vector_mode_and_spill_fold_parity(monkeypatch):
    """The native builder's valid-k-mer hash vector (and its spill to the
    reference-shaped bit planes past KWAGE_VEC_MAX_KMERS) folds to bytes
    identical to the Python oracle at the production default maxL=32 --
    where the reference allocates 5 x 512 MB planes per accession
    (make_bloom.cpp:103,163) and the vector path allocates ~20 B per
    valid k-mer instead."""
    import numpy as np

    from kwage.core import FilterInfo
    from kwage.native import available
    from kwage.native.fallback import PyCountingBuilder
    from kwage.pipeline.make_bloom import BuildOptions, build_bloom_from_sequences

    if not available():
        import pytest

        pytest.skip("native library unavailable")

    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    seqs = [genome[p : p + 150] for p in rng.integers(0, 20000 - 150, size=500)]
    opt = BuildOptions(kmer_len=31, min_kmer_count=2)  # default maxL=32

    pb = PyCountingBuilder(31, 2, 20, 32)
    for s in seqs:
        pb.add_sequence(s)

    for vec_max in (None, "500"):  # vector-only, then forced mid-stream spill
        if vec_max is None:
            monkeypatch.delenv("KWAGE_VEC_MAX_KMERS", raising=False)
        else:
            monkeypatch.setenv("KWAGE_VEC_MAX_KMERS", vec_max)
        rec = build_bloom_from_sequences(
            iter(seqs), opt, FilterInfo(), num_bp_hint=75000
        )
        want = pb.fold(rec.param.log_2_filter_len, rec.param.num_hash)
        assert want.tobytes() == rec.bits.tobytes(), f"vec_max={vec_max}"
    assert pb.num_valid_kmer > 500  # the spill really triggered


def test_kn_search_matches_numpy_reduction():
    """Native bit-sliced search == the numpy full reduction on random
    matrices across seed counts, tail bytes, and threshold modes
    (kwage.cpp:340-541 semantics; early exit never changes results)."""
    import numpy as np

    from kwage.native import search_native
    from kwage.search.engine import _match_filters, query_threshold_count

    rng = np.random.default_rng(7)
    for trial in range(60):
        num_hash = int(rng.integers(1, 6))
        num_filter = int(rng.integers(1, 300))
        slice_size = (num_filter + 7) // 8 + int(rng.integers(0, 3))
        n_rows = int(rng.integers(1, 200))
        n_kmer = int(rng.integers(1, 400))
        threshold = float(rng.choice([1.0, 0.8, 0.5, 0.05, 0.0001]))
        slices = rng.integers(0, 256, size=(n_rows, slice_size), dtype=np.uint8)
        if trial % 3 == 0:  # dense bits so complete matches can survive
            slices |= 0xF0
        flat = rng.integers(0, n_rows, size=n_kmer * num_hash, dtype=np.uint64)
        qt = 0 if threshold == 1.0 else query_threshold_count(threshold, n_kmer)
        hits = search_native(slices, flat, num_hash, num_filter, threshold, qt)
        if hits is None:  # toolchain absent: fallback path is the only path
            return
        rows = slices[flat]
        matched, counts = _match_filters(rows, num_hash, num_filter, threshold)
        ref = [
            (int(i), n_kmer if threshold == 1.0 else int(counts[i]))
            for i in np.nonzero(matched)[0]
        ]
        assert hits == ref, (trial, threshold)


def test_search_all_native_matches_per_query_twin():
    """kn_search_all (whole batch in one native call: extraction + murmur
    + reduction) == the per-query search_database twin, across thresholds,
    empty/N-only queries, and the chunked buffer path."""
    import random

    import numpy as np

    from kwage.native import available, search_all_native
    from kwage.search.engine import query_slice_indices, search_database

    if not available():
        import pytest
        pytest.skip("native library unavailable")

    class Hdr:
        kmer_len = 21
        num_hash = 4
        log_2_filter_len = 12
        num_filter = 77

    class FakeReader:
        def __init__(self, slices):
            self.header = Hdr()
            self._s = slices

    rng = np.random.default_rng(12)
    random.seed(12)
    slices = (rng.random((1 << 12, (77 + 7) // 8)) * 256).astype(np.uint8)
    queries = []
    for i in range(40):
        r = random.random()
        if r < 0.1:
            queries.append("")                       # no k-mers
        elif r < 0.2:
            queries.append("N" * 50)                 # no valid k-mers
        elif r < 0.3:
            queries.append("ACGT" * 3)               # shorter than k
        else:
            queries.append("".join(
                random.choice("ACGTN") for _ in range(random.randint(21, 300))))
    for thr in (0.2, 0.8, 1.0):
        for chunk in (None, 7):
            got = search_all_native(
                slices, queries, Hdr.kmer_len, Hdr.num_hash,
                Hdr.log_2_filter_len, Hdr.num_filter, thr, chunk=chunk)
            assert got is not None
            reader = FakeReader(slices)
            for q, seq in enumerate(queries):
                want = search_database(reader, seq, thr, slices=slices)
                assert got[q] == want, (q, thr, chunk)


def test_native_wrappers_match_twins_on_non_ascii():
    """Non-ASCII codepoints in sequence text must behave like any other
    invalid base (window reset), not crash the native wrappers: each
    codepoint encodes to one replacement byte, mirroring the numpy twins
    character-for-character."""
    import numpy as np

    from kwage.core.words import canonical_kmers
    from kwage.native import (
        available,
        canonical_kmers_native,
        read_profile_native,
        search_all_native,
    )
    from kwage.search.engine import search_database

    if not available():
        import pytest
        pytest.skip("native library unavailable")
    s = "ACGTéACGTACGTACGT€ACGT"  # é and € mid-sequence
    km = canonical_kmers(s, 11)
    total, uniq = read_profile_native(s, 11)
    assert total == km.size
    assert np.array_equal(uniq, np.unique(km))
    assert np.array_equal(canonical_kmers_native(s, 11), km)

    class Hdr:
        kmer_len = 11
        num_hash = 3
        log_2_filter_len = 12
        num_filter = 40

    class R:
        header = Hdr()

    rng = np.random.default_rng(5)
    slices = (rng.random((1 << 12, 5)) * 256).astype(np.uint8)
    qs = ["ACGTACGTACGTACGTACGT", s, "acgtacgtacgtACGTACGT"]
    got = search_all_native(slices, qs, 11, 3, 12, 40, 0.5)
    for q, seq in enumerate(qs):
        assert got[q] == search_database(R(), seq, 0.5, slices=slices), q


def test_transpose_bits_native_matches_numpy_twin():
    """kn_transpose_bits (64x64 delta-swap blocks) == the numpy
    unpack/transpose/pack fallback across shapes incl. block edges and
    padded output columns."""
    import numpy as np

    from kwage.native import transpose_bits_native

    rng = np.random.default_rng(42)
    for F, nb in [(1, 1), (7, 3), (8, 8), (63, 9), (64, 8), (65, 17),
                  (129, 100), (400, 513), (2048, 64)]:
        m = rng.integers(0, 256, size=(F, nb), dtype=np.uint8)
        got = transpose_bits_native(m, F)
        if got is None:  # toolchain absent
            import pytest

            pytest.skip("native library unavailable")
        bits = np.unpackbits(m, axis=1, bitorder="little")
        ref = np.packbits(bits.T, axis=1, bitorder="little")
        want = (F + 7) // 8
        if ref.shape[1] < want:
            ref = np.pad(ref, ((0, 0), (0, want - ref.shape[1])))
        assert got.shape == ref.shape and np.array_equal(got, ref), (F, nb)
        # num_filter > F pads zero columns on the right.
        wide = transpose_bits_native(m, F + 16)
        assert wide.shape[1] == (F + 16 + 7) // 8
        assert np.array_equal(wide[:, :ref.shape[1]], ref)
        assert not wide[:, ref.shape[1]:].any()


def test_transpose_bits_rejects_truncating_num_filter():
    """num_filter only ever PADS the output width; narrower than the
    source row count would overrun the C kernel's dst rows -- both the
    native wrapper and the transpose_filters twin raise instead."""
    import numpy as np
    import pytest

    from kwage.native import transpose_bits_native
    from kwage.pipeline.build_db import transpose_filters

    m = np.zeros((10, 4), dtype=np.uint8)
    with pytest.raises(ValueError):
        transpose_bits_native(m, 2)
    with pytest.raises(ValueError):
        transpose_filters(m, 2)


def test_library_cached_per_source_and_machine():
    """The cached library lives in the ignored build/ directory, named by
    the source's hash and by what -march=native means on this host."""
    import os
    import platform

    from kwage import native

    path = native._build()
    assert os.path.dirname(path) == native._BUILD_DIR
    name = os.path.basename(path)
    assert native._source_tag() in name
    assert native._machine_tag() in name
    assert native._machine_tag().startswith(platform.machine() + "-")
    assert native._machine_tag() == native._machine_tag()  # deterministic
