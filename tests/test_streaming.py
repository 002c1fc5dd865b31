"""Streamed SRA ingestion: reads flow straight off the toolkit pipe into
the builders/search -- no .sra staging, no FASTQ materialization, peak
scratch independent of accession size (the shape of the reference's VDB
cursor streaming, SriRachA/sra_stream.cpp:90-211, make_bloom.cpp:170-300).

The SRA toolkit is not installed here, so a fake ``fasterq-dump`` on PATH
serves canned FASTQ -- the subprocess plumbing, incremental parsing, and
failure classification are all real.
"""

import os
import stat

import numpy as np
import pytest

FAKE_TOOL = """#!/usr/bin/env python3
import os, shutil, sys

args = sys.argv[1:]
acc = args[-1]
d = os.environ["FAKE_SRA_DIR"]
src = os.path.join(d, acc + ".fastq")
if not os.path.isfile(src):
    sys.stderr.write(f"err: invalid accession '{acc}'\\n")
    sys.exit(3)
fail = os.path.isfile(os.path.join(d, acc + ".fail"))
chatty = os.path.isfile(os.path.join(d, acc + ".chatty"))
if "--stdout" in args or "-Z" in args:
    with open(src) as f:
        lines = f.readlines()
    n = len(lines) // 2 if fail else len(lines)
    n -= n % 4
    half = (n // 2) - (n // 2) % 4
    sys.stdout.write("".join(lines[:half]))
    sys.stdout.flush()
    if chatty:
        # >64 KiB of mid-stream progress chatter: the parent must drain
        # stderr concurrently or this blocks before the second half.
        sys.stderr.write("spots read      : 1,234,567\\n" * 20000)
        sys.stderr.flush()
    sys.stdout.write("".join(lines[half:n]))
    sys.stdout.flush()
    if fail:
        sys.stderr.write("timeout: connection reset by peer\\n")
        sys.exit(1)
else:
    if fail:
        sys.stderr.write("timeout: connection reset by peer\\n")
        sys.exit(1)
    out = args[args.index("-O") + 1]
    os.makedirs(out, exist_ok=True)
    shutil.copy(src, os.path.join(out, acc + ".fastq"))
sys.exit(0)
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    sradir = tmp_path / "sra"
    bindir.mkdir()
    sradir.mkdir()
    tool = bindir / "fasterq-dump"
    tool.write_text(FAKE_TOOL)
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ.get("PATH", ""))
    monkeypatch.setenv("FAKE_SRA_DIR", str(sradir))
    return sradir


def _write_fastq(sradir, acc, seqs):
    with open(sradir / f"{acc}.fastq", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@{acc}.{i + 1}\n{s}\n+\n{'I' * len(s)}\n")


def _write_fastq_spots(sradir, acc, spots):
    """Split-spot store: one record per FRAGMENT, consecutive fragments of
    a spot share the ``<acc>.<spot>`` id token (what the real
    fasterq-dump --split-spot emits)."""
    with open(sradir / f"{acc}.fastq", "w") as f:
        for i, frags in enumerate(spots):
            for s in frags:
                f.write(f"@{acc}.{i + 1} {i + 1} length={len(s)}\n"
                        f"{s}\n+\n{'I' * len(s)}\n")


def _rand_seqs(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]


def test_stream_accession_yields_indexed_reads(fake_toolkit):
    from kwage.sriracha.sra_source import stream_accession

    seqs = _rand_seqs(5, 80)
    _write_fastq(fake_toolkit, "SRR5550001", seqs)
    got = list(stream_accession("SRR5550001"))
    assert got == [(i + 1, 1, s) for i, s in enumerate(seqs)]


def test_stream_accession_paired_end_fragments(fake_toolkit):
    """Paired-end spots stream as separate fragments with the reference's
    (1-based spot, 1-based subindex) numbering
    (SriRachA/sra_stream.cpp:358-377)."""
    from kwage.sriracha.sra_source import stream_accession

    seqs = _rand_seqs(6, 70, seed=7)
    spots = [[seqs[0], seqs[1]], [seqs[2]], [seqs[3], seqs[4], seqs[5]]]
    _write_fastq_spots(fake_toolkit, "SRR5550040", spots)
    got = list(stream_accession("SRR5550040"))
    want = [
        (i + 1, j + 1, s)
        for i, frags in enumerate(spots)
        for j, s in enumerate(frags)
    ]
    assert got == want


def test_stream_chatty_stderr_does_not_deadlock(fake_toolkit):
    """A toolkit emitting >64 KiB of stderr chatter mid-stream must not
    deadlock the read loop (stderr drains in a background thread)."""
    from kwage.sriracha.sra_source import stream_accession

    seqs = _rand_seqs(16, 60, seed=9)
    _write_fastq(fake_toolkit, "SRR5550041", seqs)
    (fake_toolkit / "SRR5550041.chatty").touch()
    got = [s for _, _, s in stream_accession("SRR5550041")]
    assert got == seqs


def test_stream_failure_classified_network(fake_toolkit):
    """A mid-stream failure surfaces as a network-classed DownloadError
    after the partial reads, engaging the caller's retry loop."""
    from kwage.sriracha.sra_source import (
        DownloadError,
        SRA_DOWNLOAD_NETWORK_FAILURE,
        is_retryable,
        stream_accession,
    )

    seqs = _rand_seqs(8, 60, seed=1)
    _write_fastq(fake_toolkit, "SRR5550002", seqs)
    (fake_toolkit / "SRR5550002.fail").touch()
    got = []
    with pytest.raises(DownloadError) as ei:
        for _, _, s in stream_accession("SRR5550002"):
            got.append(s)
    assert ei.value.status == SRA_DOWNLOAD_NETWORK_FAILURE
    assert is_retryable(ei.value.status)
    assert 0 < len(got) < len(seqs)  # partial yield before the failure


def test_stream_unknown_accession_not_retryable(fake_toolkit):
    from kwage.sriracha.sra_source import (
        DownloadError,
        SRA_DOWNLOAD_VDB_ERROR,
        stream_accession,
    )

    with pytest.raises(DownloadError) as ei:
        list(stream_accession("SRR9999998"))
    assert ei.value.status == SRA_DOWNLOAD_VDB_ERROR


def test_maestro_stream_mode_zero_scratch(fake_toolkit, tmp_path):
    """--stream maestro: blooms stream straight off the pipe, byte-identical
    to a local-file build, with the download scratch left empty."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        Maestro,
        MaestroOptions,
        STATUS_DATABASE_SUCCESS,
        StreamingResolver,
    )
    from kwage.pipeline.make_bloom import BuildOptions, build_bloom_from_sequences

    accs = ["SRR5550010", "SRR5550011"]
    all_seqs = {}
    infos = []
    for j, acc in enumerate(accs):
        seqs = _rand_seqs(6, 120, seed=10 + j)
        all_seqs[acc] = seqs
        _write_fastq(fake_toolkit, acc, seqs)
        # The inventory's BASE_COUNT pre-sizes the counting filter like the
        # reference's sra_meta probe.
        infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                number_of_bases=sum(len(s) for s in seqs)))
    write_inventory(str(tmp_path / "inv.bin"), infos)

    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inv.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=12, max_log_2_filter_len=16,
        min_log_2_count_len=12, max_log_2_count_len=16,
        num_workers=1, stream_sra=True, save_bloom=True,
    )
    scratch = tmp_path / "stream_scratch"
    m = Maestro(opt, StreamingResolver(str(scratch)))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    # Nothing was ever materialized.
    assert not scratch.exists() or not any(scratch.iterdir())

    bopts = BuildOptions(kmer_len=31, min_kmer_count=1,
                         min_log_2_filter_len=12, max_log_2_filter_len=16,
                         min_log_2_count_len=12, max_log_2_count_len=16)
    for j, acc in enumerate(accs):
        want = build_bloom_from_sequences(iter(all_seqs[acc]), bopts, infos[j])
        got = open(tmp_path / "bloom" / f"{acc}.bloom", "rb").read()
        from kwage.io.bloom_file import read_bloom_file

        rec = read_bloom_file(str(tmp_path / "bloom" / f"{acc}.bloom"))
        assert rec.param == want.param
        assert rec.bits.tobytes() == want.bits.tobytes(), acc
        assert got[0] != 0  # completion magic patched


def test_maestro_stream_failure_is_bloom_classed(fake_toolkit, tmp_path):
    """Streaming-mode failures persist BLOOM_FAIL codes (the reference
    streaming worker replies STATUS_BLOOM_FAIL even for download errors)."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        Maestro,
        MaestroOptions,
        STATUS_BLOOM_FAIL,
        StreamingResolver,
    )

    acc = "SRR5550020"
    _write_fastq(fake_toolkit, acc, _rand_seqs(6, 120, seed=3))
    (fake_toolkit / f"{acc}.fail").touch()
    write_inventory(str(tmp_path / "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(acc))])
    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inv.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=12, max_log_2_filter_len=16,
        min_log_2_count_len=12, max_log_2_count_len=16,
        num_workers=1, stream_sra=True, num_download_attempt=2,
    )
    m = Maestro(opt, StreamingResolver(str(tmp_path / "ss")))
    m.restore()
    m.run()
    assert int(m.status[0]) == STATUS_BLOOM_FAIL, m.summary()


def test_maestro_stream_paired_end_fragment_parity(fake_toolkit, tmp_path):
    """Streamed maestro on a paired-end accession builds a .bloom
    byte-identical to the materialized PER-FRAGMENT build: mates digest as
    separate reads, so no chimeric k-mer spanning a mate junction exists
    (the reference's READ_LEN split, SriRachA/sra_stream.cpp:358-377)."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.bloom_file import read_bloom_file
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        Maestro,
        MaestroOptions,
        STATUS_DATABASE_SUCCESS,
        StreamingResolver,
    )
    from kwage.pipeline.make_bloom import BuildOptions, build_bloom_from_sequences

    acc = "SRR5550042"
    frags = _rand_seqs(10, 90, seed=21)
    spots = [frags[i : i + 2] for i in range(0, 10, 2)]  # 5 paired-end spots
    _write_fastq_spots(fake_toolkit, acc, spots)
    info = FilterInfo(run_accession=str_to_accession(acc),
                      number_of_bases=sum(len(s) for s in frags))
    write_inventory(str(tmp_path / "inv.bin"), [info])

    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inv.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=12, max_log_2_filter_len=16,
        min_log_2_count_len=12, max_log_2_count_len=16,
        num_workers=1, stream_sra=True, save_bloom=True,
    )
    m = Maestro(opt, StreamingResolver(str(tmp_path / "ss")))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()

    bopts = BuildOptions(kmer_len=31, min_kmer_count=1,
                         min_log_2_filter_len=12, max_log_2_filter_len=16,
                         min_log_2_count_len=12, max_log_2_count_len=16)
    # Ground truth: every FRAGMENT as its own read. A concatenated-mate
    # build (the round-2 behavior) would admit chimeric junction k-mers
    # and differ.
    want = build_bloom_from_sequences(iter(frags), bopts, FilterInfo(
        run_accession=str_to_accession(acc),
        number_of_bases=sum(len(s) for s in frags)))
    rec = read_bloom_file(str(tmp_path / "bloom" / f"{acc}.bloom"))
    assert rec.param == want.param
    assert rec.bits.tobytes() == want.bits.tobytes()
    chimeric = build_bloom_from_sequences(
        iter(["".join(p) for p in spots]), bopts, FilterInfo(
            run_accession=str_to_accession(acc),
            number_of_bases=sum(len(s) for s in frags)))
    assert rec.bits.tobytes() != chimeric.bits.tobytes()


def test_sriracha_stream_paired_end_tsv_subindices(fake_toolkit, data_dir, tmp_path):
    """Streamed sriracha on a paired-end accession emits idx.sub rows
    matching the per-fragment ground truth (TSV format
    SriRachA/main.cpp:560-578)."""
    from kwage.cli.sriracha import main as sriracha_main
    from kwage.io.sequence import iter_sequences
    from kwage.sriracha.engine import (
        SrirachaOptions,
        format_results,
        load_subject_kmers,
        search_reads,
    )

    reads = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    spots = [reads[i : i + 2] for i in range(0, len(reads) - len(reads) % 2, 2)]
    acc = "SRR5550043"
    _write_fastq_spots(fake_toolkit, acc, spots)

    out = tmp_path / "out.tsv"
    rc = sriracha_main([
        "-k", "11", "-t", "0.4", "-n", "1",
        "-i", str(data_dir / "sriracha_queries.fasta"),
        "-o", str(out), acc,
    ])
    assert rc == 0
    got = out.read_text()

    opt = SrirachaOptions(kmer_len=11, kmer_match_threshold=0.4, min_valid_kmer=1)
    subjects = load_subject_kmers([str(data_dir / "sriracha_queries.fasta")], 11)
    frag_iter = [
        (s, i + 1, j + 1)
        for i, fr in enumerate(spots)
        for j, s in enumerate(fr)
    ]
    results = search_reads(iter(frag_iter), subjects, opt)
    want = format_results(acc, subjects, results) + "//\n"
    assert got == want
    # Second fragments really render as idx.2 rows.
    assert any("\t" in line and line.split("\t")[1].endswith(".2")
               for line in got.splitlines())


def test_bloom_batch_streams_big_accessions_unbuffered(tmp_path, monkeypatch):
    """execute_bloom_batch never materializes a streamed accession bigger
    than the batch buffer: the chunked device builder starts consuming
    the live pipe BEFORE the stream is exhausted, and the result is
    byte-identical to the host build (bounded-RAM streaming, the
    reference's sra_stream.cpp:90-211 shape)."""
    import kwage.parallel.maestro as maestro_mod
    import kwage.pipeline.make_bloom as mb_mod
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.bloom_file import read_bloom_file
    from kwage.parallel.maestro import (
        MaestroOptions,
        STATUS_BLOOM_SUCCESS,
        SourceResolver,
        execute_bloom_batch,
    )
    from kwage.pipeline.make_bloom import BuildOptions, build_bloom_from_sequences

    seqs = _rand_seqs(40, 150, seed=33)  # 6000 bp total

    class SpyResolver(SourceResolver):
        exhausted = False

        def open_stream(self, accession):
            def gen():
                for s in seqs:
                    yield s
                SpyResolver.exhausted = True
            return gen()

    state = {"exhausted_at_build": None}
    real_build = mb_mod.build_bloom_device

    def spy_build(stream, opts, info, chunk_bp=8_000_000):
        if state["exhausted_at_build"] is None:
            state["exhausted_at_build"] = SpyResolver.exhausted
        return real_build(stream, opts, info, chunk_bp)

    monkeypatch.setenv("KWAGE_STREAM_BUFFER_BP", "2000")
    monkeypatch.setattr(mb_mod, "build_bloom_device", spy_build)

    opt = MaestroOptions(
        scratch_bloom_dir=str(tmp_path / "bloom"),
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=12, max_log_2_filter_len=16,
        min_log_2_count_len=12, max_log_2_count_len=16,
        stream_sra=True, device_build=True,
    )
    import os

    os.makedirs(opt.scratch_bloom_dir, exist_ok=True)
    acc = "SRR5550050"
    info = FilterInfo(run_accession=str_to_accession(acc),
                      number_of_bases=sum(len(s) for s in seqs))
    path = str(tmp_path / "bloom" / f"{acc}.bloom")
    out = execute_bloom_batch(
        [(0, acc, info, "full")], SpyResolver(), opt, lambda key: path
    )
    assert out[0][1] == STATUS_BLOOM_SUCCESS, out
    assert state["exhausted_at_build"] is False, \
        "batch path materialized the whole stream before building"

    bopts = BuildOptions(kmer_len=31, min_kmer_count=1,
                         min_log_2_filter_len=12, max_log_2_filter_len=16,
                         min_log_2_count_len=12, max_log_2_count_len=16)
    want = build_bloom_from_sequences(iter(seqs), bopts, FilterInfo(
        run_accession=str_to_accession(acc),
        number_of_bases=sum(len(s) for s in seqs)))
    rec = read_bloom_file(path)
    assert rec.param == want.param
    assert rec.bits.tobytes() == want.bits.tobytes()


def test_sriracha_cli_streams_remote_accession(fake_toolkit, data_dir, tmp_path):
    """A non-local accession streams through the pipe and produces the
    same TSV as searching the equivalent local file."""
    from kwage.cli.sriracha import main as sriracha_main
    from kwage.io.sequence import iter_sequences

    reads = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    _write_fastq(fake_toolkit, "SRR5550030", reads)

    def run(target):
        out = tmp_path / "out.tsv"
        rc = sriracha_main([
            "-k", "11", "-t", "0.4", "-n", "1",
            "-i", str(data_dir / "sriracha_queries.fasta"),
            "-o", str(out), target,
        ])
        assert rc == 0
        return [
            "\t".join(["ACC"] + l.split("\t")[1:]) if "\t" in l else l
            for l in out.read_text().splitlines()
        ]

    got = run("SRR5550030")
    want = run(str(data_dir / "sriracha_reads.fasta"))
    assert got == want


def test_sliced_materialize_fallback_matches_streamed_numbering(
    fake_toolkit, data_dir, tmp_path
):
    """Without libncbi-vdb, sliced runs (--slice/--of) materialize the
    accession -- but the TSV idx.sub numbering and spot-based sharding
    must match the streamed pipe path exactly (same (spot, subindex)
    synthesis from the --split-spot headers), so results never depend on
    which access path served the accession."""
    from kwage.cli.sriracha import main as sriracha_main
    from kwage.io.sequence import iter_sequences

    reads = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    spots = [reads[i : i + 2] for i in range(0, len(reads) - len(reads) % 2, 2)]
    acc = "SRR5550060"
    _write_fastq_spots(fake_toolkit, acc, spots)

    def run(extra, name):
        out = tmp_path / name
        rc = sriracha_main([
            "-k", "11", "-t", "0.4", "-n", "1",
            "-i", str(data_dir / "sriracha_queries.fasta"),
            "-o", str(out), acc,
        ] + extra)
        assert rc == 0
        return [l for l in out.read_text().splitlines() if "\t" in l]

    full = run([], "full.tsv")  # streamed (pipe) path
    parts = []
    for sl in range(3):  # sliced -> materialize fallback
        parts += run(["--slice", str(sl), "--of", "3"], f"s{sl}.tsv")
    assert full and sorted(parts) == sorted(full)
    # Paired-end subindices really survive the fallback.
    assert any(l.split("\t")[1].endswith(".2") for l in parts)
