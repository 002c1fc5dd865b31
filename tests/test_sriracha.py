"""SriRachA per-read search: host + device engines vs reference oracle TSV."""

import io
import sys

import pytest

from kwage.cli.sriracha import main as sriracha_main

CASES = [
    "11_0.4_1_0.5_0_100_0_1",
    "11_0.8_1_0.75_0_100_0_1",
    "7_0.6_3_0.6_50_5_0_1",
    "11_0.4_1_0.5_0_100_1_3",
    "11_0.4_1_0.5_0_100_2_3",
    "15_0.3_1_0.5_0_100_0_1",
]


def _args(case, data_dir, device=False):
    k, t, n, c, minlen, maxm, sl, of = case.split("_")
    args = [
        "-k", k, "-t", t, "-n", n,
        "--read.complexity.min", c,
        "--read.len.min", minlen,
        "--max-results", maxm,
        "-i", str(data_dir / "sriracha_queries.fasta"),
    ]
    if of != "1":
        args += ["--slice", sl, "--of", of]
    if device:
        args += ["--device"]
    args += [str(data_dir / "sriracha_reads.fasta")]
    return args


def _run(args, tmp_path):
    out = tmp_path / "out.tsv"
    rc = sriracha_main(args + ["-o", str(out)])
    assert rc == 0
    return out.read_text()


@pytest.mark.parametrize("case", CASES)
def test_host_engine_matches_oracle(case, data_dir, golden_dir, tmp_path):
    got = _run(_args(case, data_dir), tmp_path)
    want = (golden_dir / "sriracha" / f"{case}.tsv").read_text()
    # The oracle prints file-stem accessions differently; normalize col 0.
    def norm(text):
        return [
            "\t".join(["ACC"] + line.split("\t")[1:]) if "\t" in line else line
            for line in text.splitlines()
        ]
    assert norm(got) == norm(want), case


@pytest.mark.parametrize("case", CASES)
def test_device_engine_matches_oracle(case, data_dir, golden_dir, tmp_path):
    got = _run(_args(case, data_dir, device=True), tmp_path)
    want = (golden_dir / "sriracha" / f"{case}.tsv").read_text()
    def norm(text):
        return [
            "\t".join(["ACC"] + line.split("\t")[1:]) if "\t" in line else line
            for line in text.splitlines()
        ]
    assert norm(got) == norm(want), case


@pytest.mark.parametrize("k", [11, 15, 16, 21, 31])
def test_device_engine_matches_host_all_k(k, data_dir, tmp_path):
    """Device/host equality across the full reference-legal k range
    (SriRachA/search_by_kmer.cpp:94-98): k <= 13 takes the dense LUT,
    larger k the bucketed 64-bit hash table -- never the host fallback."""
    case = f"{k}_0.3_1_0.5_0_100_0_1"
    host = _run(_args(case, data_dir), tmp_path)
    dev = _run(_args(case, data_dir, device=True), tmp_path)
    assert dev == host, k
    # Sanity: the search produced real matches for at least the small ks.
    if k <= 21:
        assert any("\t" in line for line in dev.splitlines()), dev


def test_slices_cover_full_range(data_dir, golden_dir, tmp_path):
    """Union of 3 slices == full-range result set (order within slices)."""
    full = _run(_args("11_0.4_1_0.5_0_100_0_1", data_dir), tmp_path)
    parts = []
    for sl in range(3):
        case = f"11_0.4_1_0.5_0_100_{sl}_3"
        parts.append(_run(_args(case, data_dir), tmp_path))
    full_lines = set(l for l in full.splitlines() if l != "//")
    part_lines = set()
    for p in parts:
        part_lines |= set(l for l in p.splitlines() if l != "//")
    assert part_lines == full_lines


def test_sra_source_status_vocabulary():
    from kwage.sriracha import sra_source as ss

    # Success must be the smallest value (rank reconciliation via MAX).
    assert ss.SRA_DOWNLOAD_SUCCESS == 0
    assert ss.SRA_DOWNLOAD_FILE_READ_ERROR == 14
    assert ss.is_retryable(ss.SRA_DOWNLOAD_NETWORK_FAILURE)
    assert not ss.is_retryable(ss.SRA_DOWNLOAD_CONTROLLED_ACCESS)


def test_sriracha_cli_download_failure_line(tmp_path, capsys):
    """A non-local accession without the SRA toolkit produces the
    reference's failure line and suppresses the // terminator."""
    from kwage.cli.sriracha import main as sriracha_main

    q = tmp_path / "q.fasta"
    q.write_text(">q\nACGTACGTACGTACGTACGT\n")
    out_file = tmp_path / "out.tsv"
    rc = sriracha_main(["-i", str(q), "-o", str(out_file), "SRR99999999"])
    assert rc == 0
    text = out_file.read_text()
    assert "SRR99999999\tNA\t0\tDownload failed" in text
    assert "//" not in text


def test_device_empty_subjects(tmp_path):
    from kwage.sriracha.device import search_reads_device
    from kwage.sriracha.engine import SrirachaOptions

    assert search_reads_device(iter([]), [], SrirachaOptions()) == []
    assert (
        search_reads_device(iter([("ACGTACGTACGTACGT", 1, 0)]), [], SrirachaOptions())
        == []
    )


def test_device_many_subject_groups():
    """> 32 subjects exercises the multi-table path; the dense-LUT and
    bucketed-hash kernels are independent implementations and must agree
    exactly on the same subject sets."""
    import numpy as np
    import jax.numpy as jnp

    from kwage.sriracha.device import (
        _build_hash_group,
        _read_batch_kernel_hash,
        _read_batch_kernel_tables,
        build_subject_table,
    )

    rng = np.random.default_rng(3)
    k = 9
    ns, smax = 40, 64
    subjects = np.full((ns, smax), 0xFFFFFFFF, dtype=np.uint32)
    kmer_sets = []
    for s in range(ns):
        n = int(rng.integers(5, smax))
        kms = np.sort(rng.choice(1 << (2 * k), size=n, replace=False))
        subjects[s, :n] = kms.astype(np.uint32)
        kmer_sets.append(kms.astype(np.uint64))
    reads = jnp.asarray(
        rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(16, 64))
    )
    lengths = jnp.asarray(rng.integers(k, 64, size=16, dtype=np.int32))

    ns_groups = tuple(min(32, ns - g) for g in range(0, ns, 32))
    tables = tuple(
        build_subject_table(jnp.asarray(subjects[g : g + 32]), k)
        for g in range(0, ns, 32)
    )
    want = _read_batch_kernel_tables(reads, lengths, tables, k, ns_groups)
    htables = tuple(
        tuple(jnp.asarray(a) for a in _build_hash_group(kmer_sets[g : g + 32]))
        for g in range(0, ns, 32)
    )
    got = _read_batch_kernel_hash(reads, lengths, htables, k, ns_groups)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("threads", [2, 5])
def test_threaded_host_search_matches_sequential(threads, data_dir, tmp_path):
    """--threads N: thread-local sub-range search + rank-0-style merge
    (sra_stream.cpp:634-699) produces the same TSV as one thread when the
    result cap is not in play."""
    case_args = [
        "-k", "11", "-t", "0.4", "-n", "1",
        "--max-results", "1000",
        "-i", str(data_dir / "sriracha_queries.fasta"),
        str(data_dir / "sriracha_reads.fasta"),
    ]
    out1 = tmp_path / "one.tsv"
    outN = tmp_path / "n.tsv"
    assert sriracha_main(case_args + ["-o", str(out1)]) == 0
    assert sriracha_main(case_args + ["--threads", str(threads), "-o", str(outN)]) == 0
    assert outN.read_text() == out1.read_text()


def test_device_search_spans_stream_bounded(data_dir, monkeypatch):
    """search_reads_device consumes its read iterator in bounded spans:
    results stay bit-identical to the host engine across span boundaries
    (perfect-match/cull state carries over), and the first device batch
    runs BEFORE the iterator is exhausted (no full materialization)."""
    import kwage.sriracha.device as dev_mod
    from kwage.io.sequence import iter_sequences
    from kwage.sriracha.device import search_reads_device
    from kwage.sriracha.engine import (
        SrirachaOptions,
        load_subject_kmers,
        search_reads,
    )

    reads = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    reads = (reads * 4)[:50]  # > several spans at span_reads=8
    tuples = [(s, i + 1, 1) for i, s in enumerate(reads)]
    subjects = load_subject_kmers([str(data_dir / "sriracha_queries.fasta")], 11)
    opt = SrirachaOptions(kmer_len=11, kmer_match_threshold=0.4,
                          min_valid_kmer=1, max_num_match=5)

    state = {"exhausted": False, "exhausted_at_first_kernel": None}

    def gen():
        for t in tuples:
            yield t
        state["exhausted"] = True

    # Spy on BOTH kernel formulations: the size-based router picks the
    # bucketed hash table for this small subject set.
    for kname in ("_read_batch_kernel_tables", "_read_batch_kernel_hash"):
        real_kernel = getattr(dev_mod, kname)

        def spy_kernel(*a, _real=real_kernel, **kw):
            if state["exhausted_at_first_kernel"] is None:
                state["exhausted_at_first_kernel"] = state["exhausted"]
            return _real(*a, **kw)

        monkeypatch.setattr(dev_mod, kname, spy_kernel)
    got = search_reads_device(gen(), subjects, opt, batch_size=4, span_reads=8)
    want = search_reads(iter(tuples), subjects, opt)
    assert [[(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b]
            for b in got] == \
           [[(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b]
            for b in want]
    assert state["exhausted_at_first_kernel"] is False, \
        "device search materialized the whole stream before dispatching"


def test_native_read_profile_and_intersect_match_numpy():
    """kn_unique_kmers / kn_sorted_intersect_count == the numpy
    formulation (search_by_kmer.cpp:44-98 semantics) across k values,
    N-window resets, and lowercase input."""
    import random

    import numpy as np

    from kwage.core.words import canonical_kmers
    from kwage.native import read_profile_native, sorted_intersect_count_native

    if read_profile_native("ACGT", 2) is None:
        return  # toolchain absent: numpy path is the only path
    random.seed(11)

    def rseq(n, alpha="ACGT"):
        return "".join(random.choice(alpha) for _ in range(n))

    for trial in range(80):
        k = random.choice([5, 11, 21, 31, 32])
        alpha = "ACGT" if trial % 3 else "ACGTN"
        seq = rseq(random.randint(0, 400), alpha)
        if trial % 5 == 0:
            seq = seq.lower()
        kmers = canonical_kmers(seq, k)
        total_c, uniq_c = read_profile_native(seq, k)
        assert total_c == kmers.size
        assert np.array_equal(uniq_c, np.unique(kmers))
        subject = np.unique(canonical_kmers(rseq(2000), k))
        if subject.size and uniq_c.size:
            pos = np.minimum(np.searchsorted(subject, uniq_c), subject.size - 1)
            ref = int((subject[pos] == uniq_c).sum())
            assert sorted_intersect_count_native(uniq_c, subject) == ref


def test_native_read_search_loop_differential():
    """search_reads' one-call-per-read native loop produces exactly the
    per-read twin's matches (scores, order, perfect-culling) on a mixed
    workload of hits, noisy hits, low-complexity and short reads."""
    import random

    import numpy as np

    import kwage.sriracha.engine as eng
    from kwage.core.words import canonical_kmers
    from kwage.sriracha.engine import SrirachaOptions, search_reads

    random.seed(17)

    def rseq(n, alpha="ACGT"):
        return "".join(random.choice(alpha) for _ in range(n))

    for trial in range(6):
        k = random.choice([11, 21, 31])
        targets = [rseq(random.randint(300, 3000))
                   for _ in range(random.randint(1, 4))]
        subj = [(f"s{i}", np.unique(canonical_kmers(s, k)))
                for i, s in enumerate(targets)]
        reads = []
        for ridx in range(1, 400):
            r = random.random()
            if r < 0.3:
                t = random.choice(targets)
                a = random.randint(0, max(0, len(t) - 150))
                reads.append((t[a:a + 150], ridx, random.randint(1, 2)))
            elif r < 0.4:
                t = random.choice(targets)
                a = random.randint(0, max(0, len(t) - 150))
                s = list(t[a:a + 150])
                for _ in range(10):
                    s[random.randrange(len(s))] = random.choice("ACGTN")
                reads.append(("".join(s), ridx, 1))
            elif r < 0.5:
                reads.append(("AC" * 75, ridx, 1))
            elif r < 0.55:
                reads.append((rseq(random.randint(0, 40)), ridx, 1))
            else:
                reads.append((rseq(150), ridx, 1))
        opt = SrirachaOptions(
            kmer_len=k,
            kmer_match_threshold=random.choice([0.2, 0.5, 1.0]),
            max_num_match=random.choice([1, 3, 50]),
        )
        r_native = search_reads(iter(reads), subj, opt)
        # The pure-python leg must not touch the native library at all:
        # search_one_read itself calls read_profile_native /
        # sorted_intersect_count_native, so stub those too, or this only
        # tests loop plumbing while both legs compute in C.
        orig = (eng.native_available, eng.read_profile_native,
                eng.sorted_intersect_count_native)
        eng.native_available = lambda: False
        eng.read_profile_native = lambda seq, k: None
        eng.sorted_intersect_count_native = lambda uniq, subject: None
        try:
            r_py = search_reads(iter(reads), subj, opt)
        finally:
            (eng.native_available, eng.read_profile_native,
             eng.sorted_intersect_count_native) = orig
        for a, b in zip(r_native, r_py):
            la = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in a]
            lb = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b]
            assert la == lb


def test_device_gate_semantics_differential():
    """Device path == host engine on workloads that stress the vectorized
    gate/accumulation rewrite: perfect-match caps crossing span
    boundaries (tiny span_reads forces the 1-deep span pipeline and
    cross-span num_perfect carry), max_num_match in {1,3,50}, threshold
    1.0, low-complexity / short / empty reads."""
    import random

    import numpy as np

    from kwage.core.words import canonical_kmers
    from kwage.sriracha.device import search_reads_device
    from kwage.sriracha.engine import SrirachaOptions, search_reads

    random.seed(23)

    def rseq(n, alpha="ACGT"):
        return "".join(random.choice(alpha) for _ in range(n))

    for trial in range(4):
        k = random.choice([9, 15, 21])
        targets = [rseq(random.randint(200, 1200))
                   for _ in range(random.randint(1, 3))]
        subj = [(f"s{i}", np.unique(canonical_kmers(s, k)))
                for i, s in enumerate(targets)]
        reads = []
        for ridx in range(1, 300):
            r = random.random()
            if r < 0.35:  # exact substring: a perfect (score 1.0) match
                t = random.choice(targets)
                a = random.randint(0, max(0, len(t) - 120))
                reads.append((t[a:a + 120], ridx, 1))
            elif r < 0.45:
                reads.append(("AC" * 60, ridx, 1))
            elif r < 0.5:
                reads.append((rseq(random.randint(0, 30)), ridx, 1))
            else:
                reads.append((rseq(120), ridx, 1))
        opt = SrirachaOptions(
            kmer_len=k,
            kmer_match_threshold=random.choice([0.2, 1.0]),
            max_num_match=random.choice([1, 3, 50]),
        )
        r_host = search_reads(iter(reads), subj, opt)
        r_dev = search_reads_device(iter(reads), subj, opt,
                                    batch_size=32, span_reads=64)
        for a, b in zip(r_host, r_dev):
            la = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in a]
            lb = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b]
            assert la == lb


def test_device_lut_and_hash_routes_agree(monkeypatch):
    """The size-based table router (hash below ~64k subject k-mers per
    group, dense LUT above -- measured crossover, SRIRACHA_DEVICE_r04)
    must be output-invariant: force each formulation over the same
    corpus and compare with the host engine."""
    import random

    import numpy as np

    from kwage.core.words import canonical_kmers
    from kwage.sriracha.device import search_reads_device
    from kwage.sriracha.engine import SrirachaOptions, search_reads

    random.seed(31)
    k = 11

    def rseq(n):
        return "".join(random.choice("ACGT") for _ in range(n))

    targets = [rseq(900), rseq(500)]
    subj = [(f"s{i}", np.unique(canonical_kmers(s, k)))
            for i, s in enumerate(targets)]
    reads = []
    for ridx in range(1, 200):
        if random.random() < 0.4:
            t = random.choice(targets)
            a = random.randint(0, len(t) - 120)
            reads.append((t[a:a + 120], ridx, 1))
        else:
            reads.append((rseq(120), ridx, 1))
    opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=0.5)

    host = search_reads(iter(reads), subj, opt)
    outs = {}
    for name, knob in (("hash", "1000000000"), ("lut", "0")):
        monkeypatch.setenv("KWAGE_SRIRACHA_HASH_MAX", knob)
        outs[name] = search_reads_device(iter(reads), subj, opt,
                                         batch_size=32, span_reads=64)
    for dev in outs.values():
        for a, b in zip(host, dev):
            la = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in a]
            lb = [(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b]
            assert la == lb


def test_native_file_scan_stops_at_range_end(tmp_path):
    """A sliced native scan must stop parsing at its range end (the
    Python twin breaks at `i >= hi`): a FASTQ whose TAIL is truncated
    parses cleanly for a slice that ends before the damage, and raises
    for the whole file -- in both engines."""
    import numpy as np

    import kwage.sriracha.engine as eng
    from kwage.core.words import canonical_kmers
    from kwage.native import available
    from kwage.sriracha.engine import SrirachaOptions, StreamStats

    if not available():
        pytest.skip("native library unavailable")
    import random

    random.seed(5)
    target = "".join(random.choice("ACGT") for _ in range(200))
    recs = [target[:100], target[40:140], "GGGTTTAAACCC" * 10]
    fq = tmp_path / "trunc.fastq"
    body = "".join(
        f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(recs, 1))
    fq.write_text(body + "@r4\nACGTACGT\n")  # truncated final record
    subj = [("t", np.unique(canonical_kmers(target, 21)))]
    opt = SrirachaOptions(kmer_len=21, kmer_match_threshold=0.5)

    stats = StreamStats()
    res = eng._search_file_range_native(str(fq), 1, 3, subj, opt, stats)
    assert res is not None, "native scan unavailable despite toolchain"
    assert stats.num_reads == 2
    assert [m.read_index for m in res[0]] == [1, 2]

    with pytest.raises(ValueError):
        eng._search_file_range_native(str(fq), 1, 1 << 62, subj, opt, None)


def test_native_scan_callback_exception_propagates(tmp_path):
    """An exception raised in the per-match callback must surface, not be
    swallowed inside the ctypes callback (which would silently drop
    matches): a matching read containing a non-ASCII byte makes the echo
    decode fail, and the scan must raise like the text-mode twin does."""
    import numpy as np

    import kwage.sriracha.engine as eng
    from kwage.core.words import canonical_kmers
    from kwage.native import available
    from kwage.sriracha.engine import SrirachaOptions

    if not available():
        pytest.skip("native library unavailable")
    import random

    random.seed(6)
    target = "".join(random.choice("ACGT") for _ in range(200))
    fa = tmp_path / "bad.fasta"
    fa.write_bytes(b">r1\n" + target[:100].encode() + b"\x80\n")
    subj = [("t", np.unique(canonical_kmers(target, 21)))]
    opt = SrirachaOptions(kmer_len=21, kmer_match_threshold=0.2)
    with pytest.raises(UnicodeDecodeError):
        eng._search_file_range_native(str(fa), 1, 1 << 62, subj, opt, None)


@pytest.mark.parametrize("with_failure", [False, True])
def test_merge_slices_reproduces_single_process(data_dir, tmp_path,
                                                with_failure):
    """--merge-slices over N independent --slice/--of TSVs reproduces the
    single-process TSV byte-for-byte: gather + re-sort + re-cull to
    --max-results + the all-slices-agree // terminator
    (SriRachA/main.cpp:462-578). A failed accession (any slice) collapses
    to one NA line and suppresses the terminator everywhere."""
    from kwage.cli.sriracha import main

    args = ["-k", "11", "-t", "0.4", "--max-results", "3",
            "-i", str(data_dir / "sriracha_queries.fasta")]
    accs = [str(data_dir / "sriracha_reads.fasta")]
    if with_failure:
        accs.append("SRRNOPE00")

    single = tmp_path / "single.tsv"
    assert main(args + ["-o", str(single)] + accs) == 0

    margs = args + []
    for sl in range(3):
        p = tmp_path / f"s{sl}.tsv"
        assert main(args + ["-o", str(p), "--slice", str(sl), "--of", "3"]
                    + accs) == 0
        margs += ["--merge-slices", str(p)]

    merged = tmp_path / "merged.tsv"
    assert main(margs + ["-o", str(merged)] + accs) == 0
    assert merged.read_bytes() == single.read_bytes()

    text = single.read_text()
    rows = [l for l in text.splitlines() if "\t" in l and "\tNA\t" not in l]
    assert len(rows) >= 3  # the re-cull boundary is actually exercised
    if with_failure:
        assert "\tNA\t0\t" in text and not text.strip().endswith("//")
    else:
        assert text.strip().endswith("//")


def test_merge_slices_rejects_unknown_rows(data_dir, tmp_path):
    """Slice rows for accessions missing from the merge arguments are an
    error, not silent drops."""
    from kwage.cli.sriracha import main

    p = tmp_path / "s0.tsv"
    p.write_text("GHOST\t1\t0.5\tACGT\tq1\n//\n")
    rc = main(["-k", "11", "-i", str(data_dir / "sriracha_queries.fasta"),
               "--merge-slices", str(p), "-o", str(tmp_path / "m.tsv"),
               str(data_dir / "sriracha_reads.fasta")])
    assert rc == 1


def test_merge_slices_rejects_duplicate_slice_inputs(data_dir, tmp_path):
    """Feeding the same slice TSV twice (or slices from inconsistent
    --of values) is a hard error, not silent double-counted matches:
    disjoint shards never share a (read, query) pair."""
    from kwage.cli.sriracha import main

    args = ["-k", "11", "-t", "0.4",
            "-i", str(data_dir / "sriracha_queries.fasta")]
    accs = [str(data_dir / "sriracha_reads.fasta")]
    p = tmp_path / "s0.tsv"
    assert main(args + ["-o", str(p), "--slice", "0", "--of", "1"]
                + accs) == 0
    rc = main(args + ["--merge-slices", str(p), "--merge-slices", str(p),
                      "-o", str(tmp_path / "m.tsv")] + accs)
    assert rc == 1


def test_merge_slices_accepts_repeated_accession_arg(data_dir, tmp_path):
    """A sliced run given the same accession argument twice writes each
    (read, query) row twice into its own slice TSV; the merge treats those
    byte-identical within-slice repeats as idempotent (its output loop
    dedupes accession args the same way) rather than erroring. Cross-file
    repeats (same slice fed twice) must still be rejected -- covered by
    test_merge_slices_rejects_duplicate_slice_inputs."""
    from kwage.cli.sriracha import main

    args = ["-k", "11", "-t", "0.4",
            "-i", str(data_dir / "sriracha_queries.fasta")]
    acc = str(data_dir / "sriracha_reads.fasta")

    for sl in range(2):
        p = tmp_path / f"dup{sl}.tsv"
        assert main(args + ["-o", str(p), "--slice", str(sl), "--of", "2",
                            acc, acc]) == 0
    # The slice TSVs really do carry duplicated rows.
    dup_rows = [l for sl in range(2)
                for l in (tmp_path / f"dup{sl}.tsv").read_text().splitlines()
                if "\t" in l]
    assert len(dup_rows) == 2 * len(set(dup_rows)) and dup_rows

    merged = tmp_path / "m.tsv"
    assert main(args + ["--merge-slices", str(tmp_path / "dup0.tsv"),
                        "--merge-slices", str(tmp_path / "dup1.tsv"),
                        "-o", str(merged), acc, acc]) == 0

    # Byte-identical to the merge of non-duplicated sliced runs.
    for sl in range(2):
        p = tmp_path / f"one{sl}.tsv"
        assert main(args + ["-o", str(p), "--slice", str(sl), "--of", "2",
                            acc]) == 0
    ref = tmp_path / "mref.tsv"
    assert main(args + ["--merge-slices", str(tmp_path / "one0.tsv"),
                        "--merge-slices", str(tmp_path / "one1.tsv"),
                        "-o", str(ref), acc]) == 0
    assert merged.read_bytes() == ref.read_bytes()


def test_device_span_pipeline_overlap_order(data_dir):
    """The 1-deep span pipeline's load-bearing property, asserted
    structurally via the profile hook: span i+1 is packed and DISPATCHED
    before span i's readback sync (host packing and, on high-latency
    links, uploads overlap device compute). Also checks the profile
    accumulators are filled and the results stay bit-identical to the
    unprofiled run."""
    from kwage.io.sequence import iter_sequences
    from kwage.sriracha.device import search_reads_device
    from kwage.sriracha.engine import SrirachaOptions, load_subject_kmers

    reads = [s for _, s in
             iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    reads = (reads * 4)[:50]
    tuples = [(s, i + 1, 1) for i, s in enumerate(reads)]
    subjects = load_subject_kmers(
        [str(data_dir / "sriracha_queries.fasta")], 11)
    opt = SrirachaOptions(kmer_len=11, kmer_match_threshold=0.4,
                          min_valid_kmer=1, max_num_match=5)

    prof: dict = {}
    got = search_reads_device(iter(tuples), subjects, opt, batch_size=4,
                              span_reads=8, profile=prof)
    plain = search_reads_device(iter(tuples), subjects, opt, batch_size=4,
                                span_reads=8)
    assert [[m.sort_key() for m in b] for b in got] == \
           [[m.sort_key() for m in b] for b in plain]

    ev = prof["events"]
    n_spans = prof["spans"]
    assert n_spans >= 3  # several spans actually streamed
    assert [e for e in ev if e[0] == "dispatch"] == [
        ("dispatch", i) for i in range(n_spans)]
    assert [e for e in ev if e[0] == "sync"] == [
        ("sync", i) for i in range(n_spans)]
    for i in range(1, n_spans):
        # dispatch(i) strictly precedes sync(i-1): the overlap invariant.
        assert ev.index(("dispatch", i)) < ev.index(("sync", i - 1)), ev
    assert prof["bp"] == sum(len(s) for s in reads)
    assert prof["pack_dispatch_s"] > 0 and prof["sync_s"] > 0


@pytest.mark.parametrize("budget,tables,want", [
    (64 << 30, 1, 14), (4 << 30, 1, 14), (1 << 30, 1, 13), (1 << 30, 2, 13),
    (1 << 30, 3, 12), (1 << 20, 1, 8),
])
def test_dense_table_k_limit_follows_device_budget(monkeypatch, budget, tables, want):
    """The dense LUT's k ceiling comes from the device budget (half of it
    for the tables), not from the platform's name."""
    from kwage.sriracha.device import _table_k_limit

    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(budget))
    assert _table_k_limit(tables) == want
