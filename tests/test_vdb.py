"""Direct NCBI VDB cursor streaming (sriracha/vdb.py) driven against a
mock libncbi-vdb compiled from tests/data/mock_vdb.cpp. The ctypes call
sequence, per-fragment numbering, retry loops and status classification
are all real; only the library under them is canned."""

import json
import os
import subprocess
import sys

import pytest

MOCK_SRC = os.path.join(os.path.dirname(__file__), "data", "mock_vdb.cpp")


@pytest.fixture(scope="module")
def mock_vdb_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("vdb")
    so = d / "libmock_vdb.so"
    proc = subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", "-o", str(so), MOCK_SRC],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"mock vdb build failed: {proc.stderr[:200]}")
    return so


@pytest.fixture
def vdb_env(mock_vdb_lib, tmp_path, monkeypatch):
    import kwage.sriracha.vdb as vdb_mod

    monkeypatch.setenv("KWAGE_VDB_LIB", str(mock_vdb_lib))
    monkeypatch.setenv("FAKE_VDB_DIR", str(tmp_path))
    monkeypatch.setenv("KWAGE_VDB_RETRY_SLEEP", "0.01")
    monkeypatch.setattr(vdb_mod, "_LIB", None)  # re-probe with the env set
    yield tmp_path
    monkeypatch.setattr(vdb_mod, "_LIB", None)


def _write_spots(d, acc, spots, flat=False):
    with open(d / f"{acc}.vdb", "w") as f:
        for frags in spots:
            f.write("|".join(frags) + "\n")
    if flat:
        (d / f"{acc}.flat").touch()


def test_available_gating(tmp_path, monkeypatch):
    import kwage.sriracha.vdb as vdb_mod

    monkeypatch.setenv("KWAGE_VDB_LIB", str(tmp_path / "nope.so"))
    monkeypatch.setattr(vdb_mod, "_LIB", None)
    assert not vdb_mod.available()
    monkeypatch.setattr(vdb_mod, "_LIB", None)


def test_database_path_per_fragment_stream(vdb_env):
    from kwage.sriracha.vdb import stream_accession_vdb

    spots = [["ACGTACGT", "TTGGCCAA"], ["GGGGCCCC"], ["AAAA", "CCCC", "GGGG"]]
    _write_spots(vdb_env, "SRRV000001", spots)
    got = list(stream_accession_vdb("SRRV000001"))
    want = [
        (i + 1, j + 1, s)
        for i, frags in enumerate(spots)
        for j, s in enumerate(frags)
    ]
    assert got == want


def test_flat_table_path_subindex_zero(vdb_env):
    """Flat tables stream the READ column only with subindex 0 (no .sub
    suffix in TSV), per stream_flat_seq (sra_stream.cpp:415-523)."""
    from kwage.sriracha.vdb import stream_accession_vdb

    _write_spots(vdb_env, "SRRV000002", [["ACACACAC"], ["GTGTGTGT"]], flat=True)
    got = list(stream_accession_vdb("SRRV000002"))
    assert got == [(1, 0, "ACACACAC"), (2, 0, "GTGTGTGT")]


def test_rank_slicing_matches_assign_read_range(vdb_env):
    from kwage.sriracha.engine import assign_read_range
    from kwage.sriracha.vdb import stream_accession_vdb

    spots = [[f"ACGT{'A' * i}"] for i in range(10)]
    _write_spots(vdb_env, "SRRV000003", spots)
    full = list(stream_accession_vdb("SRRV000003"))
    parts = []
    for rank in range(3):
        parts += list(stream_accession_vdb("SRRV000003", rank=rank, ntasks=3))
    assert parts == full
    start, stop = assign_read_range(1, 10, 0, 3)
    assert [r for r, _, _ in full][: stop - start] == list(range(start, stop))


def test_controlled_access_classification(vdb_env):
    from kwage.sriracha.sra_source import (
        SRA_DOWNLOAD_CONTROLLED_ACCESS,
        DownloadError,
    )
    from kwage.sriracha.vdb import stream_accession_vdb

    _write_spots(vdb_env, "SRRV000004", [["ACGT"]])
    (vdb_env / "SRRV000004.controlled").touch()
    with pytest.raises(DownloadError) as ei:
        list(stream_accession_vdb("SRRV000004"))
    assert ei.value.status == SRA_DOWNLOAD_CONTROLLED_ACCESS


def test_missing_accession_is_controlled_access(vdb_env):
    """kptNotFound after the retry loop falls into the default branch
    (sra_stream.cpp:200-204), like the reference."""
    from kwage.sriracha.sra_source import (
        SRA_DOWNLOAD_CONTROLLED_ACCESS,
        DownloadError,
    )
    from kwage.sriracha.vdb import stream_accession_vdb

    with pytest.raises(DownloadError) as ei:
        list(stream_accession_vdb("SRRV999999"))
    assert ei.value.status == SRA_DOWNLOAD_CONTROLLED_ACCESS


def test_path_type_notfound_retries(vdb_env):
    """A spuriously-kptNotFound first PathType call is retried
    (sra_stream.cpp:113-130)."""
    from kwage.sriracha.vdb import stream_accession_vdb

    _write_spots(vdb_env, "SRRV000005", [["ACGTACGT"]])
    (vdb_env / "SRRV000005.flaky").touch()
    assert list(stream_accession_vdb("SRRV000005")) == [(1, 1, "ACGTACGT")]


def test_cell_data_transient_failure_retries(vdb_env):
    """VCursorCellDataDirect failures retry MAX_RETRY times per call
    (sra_stream.cpp:281-308) before classifying."""
    from kwage.sriracha.vdb import stream_accession_vdb

    spots = [["ACGTAC", "GGTTCC"], ["TTTTAA"]]
    _write_spots(vdb_env, "SRRV000006", spots)
    (vdb_env / "SRRV000006.cellflaky").touch()
    got = list(stream_accession_vdb("SRRV000006"))
    assert got == [(1, 1, "ACGTAC"), (1, 2, "GGTTCC"), (2, 1, "TTTTAA")]


def test_stream_accession_prefers_vdb(vdb_env, monkeypatch):
    """sra_source.stream_accession routes through the VDB cursors when the
    library is present -- no toolkit subprocess at all."""
    import kwage.sriracha.sra_source as src

    _write_spots(vdb_env, "SRRV000007", [["ACGTACGTAC", "TGCATGCATG"]])
    monkeypatch.setattr(
        src, "_find_fasterq",
        lambda: (_ for _ in ()).throw(AssertionError("pipe used")),
    )
    got = list(src.stream_accession("SRRV000007"))
    assert got == [(1, 1, "ACGTACGTAC"), (1, 2, "TGCATGCATG")]

    monkeypatch.setenv("KWAGE_NO_VDB", "1")
    with pytest.raises(AssertionError):
        list(src.stream_accession("SRRV000007"))


def test_cli_sliced_streaming_via_vdb(vdb_env, data_dir, tmp_path, monkeypatch):
    """--slice/--of on a remote accession streams through the VDB cursors
    (VCursorIdRange row range, sra_stream.cpp:336-356) -- no toolkit
    materialization; the union of slices equals the full-range TSV."""
    import kwage.sriracha.sra_source as src
    from kwage.cli.sriracha import main as sriracha_main

    spots = []
    with open(data_dir / "sriracha_reads.fasta") as f:
        seq = ""
        for line in f:
            if line.startswith(">"):
                if seq:
                    spots.append([seq])
                seq = ""
            else:
                seq += line.strip()
        if seq:
            spots.append([seq])
    _write_spots(vdb_env, "SRRV000010", spots)

    boom = lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("materialized path used"))
    monkeypatch.setattr(src, "resolve_accession", boom)
    monkeypatch.setattr(src, "_find_fasterq", boom)

    def run(extra, name):
        out = tmp_path / name
        rc = sriracha_main(
            ["-k", "11", "-t", "0.4",
             "-i", str(data_dir / "sriracha_queries.fasta"),
             "-o", str(out)] + extra + ["SRRV000010"])
        assert rc == 0
        return [l for l in out.read_text().splitlines() if "\t" in l]

    full = run([], "full.tsv")
    parts = []
    for sl in range(3):
        parts += run(["--slice", str(sl), "--of", "3"], f"s{sl}.tsv")
    # Results are score-sorted per run; compare as multisets.
    assert sorted(parts) == sorted(full) and full


def test_cli_sliced_no_vdb_env_materializes(vdb_env, data_dir, tmp_path,
                                            monkeypatch):
    """KWAGE_NO_VDB=1 with the library PRESENT: stream_accession will skip
    VDB and the pipe cannot seek, so the CLI's sliced gate must route to
    the materialize fallback (same gate as stream_accession) instead of
    raising 'sliced streaming requires libncbi-vdb'."""
    import os
    import stat

    from kwage.cli.sriracha import main as sriracha_main

    monkeypatch.setenv("KWAGE_NO_VDB", "1")

    # Minimal fake fasterq-dump: only the -O (materialize) mode.
    bindir = tmp_path / "bin"
    bindir.mkdir()
    tool = bindir / "fasterq-dump"
    tool.write_text(
        "#!/usr/bin/env python3\n"
        "import os, sys\n"
        "args = sys.argv[1:]\n"
        "acc = args[-1]\n"
        "out = args[args.index('-O') + 1]\n"
        "os.makedirs(out, exist_ok=True)\n"
        "src = os.path.join(os.environ['FAKE_SRA_DIR'], acc + '.fastq')\n"
        "open(os.path.join(out, acc + '.fastq'), 'w').write(open(src).read())\n"
    )
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    sradir = tmp_path / "sra"
    sradir.mkdir()
    monkeypatch.setenv("FAKE_SRA_DIR", str(sradir))

    with open(data_dir / "sriracha_reads.fasta") as f:
        seqs = [l.strip() for l in f if not l.startswith(">")]
    acc = "SRRV000020"
    with open(sradir / f"{acc}.fastq", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@{acc}.{i + 1}\n{s}\n+\n{'I' * len(s)}\n")

    out = tmp_path / "out.tsv"
    rc = sriracha_main(
        ["-k", "11", "-t", "0.4",
         "-i", str(data_dir / "sriracha_queries.fasta"),
         "-o", str(out), "--slice", "0", "--of", "2", acc])
    assert rc == 0
    text = out.read_text()
    assert "Download failed" not in text and text.strip().endswith("//")


# ---------------------------------------------------------------------------
# Aligned-accession Bloom ingest (make_bloom.cpp:170-300)
# ---------------------------------------------------------------------------

def _write_aligned(d, acc, spots, palids, alignments):
    """Aligned-run layout: spots + per-fragment alignment ids + the
    PRIMARY_ALIGNMENT table's READ rows."""
    _write_spots(d, acc, spots)
    with open(d / f"{acc}.palid", "w") as f:
        for ids in palids:
            f.write("|".join(str(i) for i in ids) + "\n")
    with open(d / f"{acc}.pal", "w") as f:
        for seq in alignments:
            f.write(seq + "\n")


ALIGNED_SPOTS = [
    ["AAAATTTTCCCC", "GGGGAAAATTTT"],   # partially aligned (frag 1 aligned)
    ["CCCCGGGGAAAA"],                   # fully unaligned
    ["TTTTCCCCGGGG", "ACACACACACAC"],   # fully unaligned
]
ALIGNED_PALIDS = [[5, 0], [0], [0, 0]]
# Alignment READ rows differ from the raw spots (clipped bases) to prove
# content comes from PRIMARY_ALIGNMENT, not the SEQUENCE table.
ALIGNED_READS = ["AAATTTTCCC", "GTGTGTGTGT"]


def test_aligned_run_streams_alignments_first(vdb_env):
    """Primary alignments stream FIRST (PRIMARY_ALIGNMENT.READ -- the
    aligned bases of getAlignedFragmentBases), then the fragments of
    fully-UNALIGNED spots only; the unaligned mate of a partially aligned
    spot is deliberately missed (make_bloom.cpp:174-258)."""
    from kwage.sriracha.vdb import (
        BloomStreamProgress,
        stream_accession_bloom_vdb,
    )

    _write_aligned(vdb_env, "SRRA000001", ALIGNED_SPOTS, ALIGNED_PALIDS,
                   ALIGNED_READS)
    progress = BloomStreamProgress()
    got = list(stream_accession_bloom_vdb("SRRA000001", progress=progress))
    assert got == ALIGNED_READS + [
        "CCCCGGGGAAAA", "TTTTCCCCGGGG", "ACACACACACAC",
    ]
    assert progress.num_primary_align == 2
    assert progress.curr_primary_align == 2
    assert progress.num_unaligned_read == 2
    assert progress.curr_unaligned_read == 2
    assert progress.num_bp == sum(len(s) for s in got)


def test_aligned_run_force_unaligned_streams_all_spots(vdb_env):
    """force_unaligned (the aligned-colorspace fallback,
    worker_main.cpp:301-310) streams EVERY spot per fragment in spot
    order, ignoring PRIMARY_ALIGNMENT."""
    from kwage.sriracha.vdb import stream_accession_bloom_vdb

    _write_aligned(vdb_env, "SRRA000002", ALIGNED_SPOTS, ALIGNED_PALIDS,
                   ALIGNED_READS)
    got = list(stream_accession_bloom_vdb("SRRA000002", force_unaligned=True))
    assert got == [f for frags in ALIGNED_SPOTS for f in frags]


def test_aligned_run_empty_alignment_table_uses_spot_order(vdb_env):
    """getAlignmentCount == 0 takes the unaligned branch even when the
    PRIMARY_ALIGNMENT table exists (make_bloom.cpp:188,260-300)."""
    from kwage.sriracha.vdb import (
        BloomStreamProgress,
        stream_accession_bloom_vdb,
    )

    _write_spots(vdb_env, "SRRA000003", ALIGNED_SPOTS)
    (vdb_env / "SRRA000003.pal").touch()  # table present, zero rows
    progress = BloomStreamProgress()
    got = list(stream_accession_bloom_vdb("SRRA000003", progress=progress))
    assert got == [f for frags in ALIGNED_SPOTS for f in frags]
    assert progress.num_primary_align == 0
    assert progress.curr_read == len(ALIGNED_SPOTS)


def test_unaligned_run_bloom_stream_is_spot_order(vdb_env):
    """Runs without a PRIMARY_ALIGNMENT table stream all spots per
    fragment, identical to the search stream's sequence order."""
    from kwage.sriracha.vdb import (
        stream_accession_bloom_vdb,
        stream_accession_vdb,
    )

    _write_spots(vdb_env, "SRRA000004", ALIGNED_SPOTS)
    got = list(stream_accession_bloom_vdb("SRRA000004"))
    assert got == [s for _, _, s in stream_accession_vdb("SRRA000004")]


def test_bloom_order_sensitivity_is_load_bearing():
    """The conservative-update counting Bloom is order-sensitive: under
    counting-filter aliasing, a permuted read stream yields a DIFFERENT
    .bloom, so reproducing the reference's alignments-first ingest order
    (make_bloom.cpp:181-258) is required for bit parity -- not cosmetic."""
    import numpy as np

    from kwage.core.info import FilterInfo
    from kwage.pipeline.make_bloom import (
        BuildOptions,
        build_bloom_from_sequences,
    )

    opts = BuildOptions(kmer_len=11, min_kmer_count=2,
                        min_log_2_count_len=8, max_log_2_count_len=8,
                        min_log_2_filter_len=10, max_log_2_filter_len=14)
    r = np.random.default_rng(0)
    reads = ["".join(r.choice(list("ACGT"), size=40)) for _ in range(30)]
    fwd = build_bloom_from_sequences(list(reads), opts, FilterInfo())
    rev = build_bloom_from_sequences(list(reversed(reads)), opts, FilterInfo())
    assert fwd.bits.tobytes() != rev.bits.tobytes()


def _stream_opts(tmp_path, **kw):
    from kwage.parallel.maestro import MaestroOptions

    kw.setdefault("stream_sra", True)
    return MaestroOptions(
        scratch_bloom_dir=str(tmp_path),
        kmer_len=11, min_kmer_count=1,
        min_log_2_filter_len=10, max_log_2_filter_len=14, **kw,
    )


def test_worker_colorspace_fallback_retries_force_unaligned(vdb_env, tmp_path):
    """The ncbi-vdb#31 signature -- all primary alignments read, unaligned
    reads exist, none read -- retries the whole build force-unaligned
    (worker_main.cpp:301-310); the result equals a clean forced build."""
    from kwage.io.bloom_file import read_bloom_file, write_bloom_file
    from kwage.core.info import FilterInfo
    from kwage.parallel.maestro import (
        STATUS_BLOOM_SUCCESS,
        StreamingResolver,
        execute_bloom_task,
    )
    from kwage.pipeline.make_bloom import build_bloom_from_sequences
    from kwage.sriracha.vdb import stream_accession_bloom_vdb

    acc = "SRRA000005"
    _write_aligned(vdb_env, acc, ALIGNED_SPOTS, ALIGNED_PALIDS, ALIGNED_READS)
    (vdb_env / f"{acc}.unalbroken").touch()

    opt = _stream_opts(tmp_path)
    out = tmp_path / f"{acc}.bloom"
    status, param = execute_bloom_task(
        acc, FilterInfo(), "full",
        StreamingResolver(str(tmp_path / "scratch")), opt, str(out),
    )
    assert status == STATUS_BLOOM_SUCCESS

    forced = build_bloom_from_sequences(
        list(stream_accession_bloom_vdb(acc, force_unaligned=True)),
        opt.build_options(), FilterInfo(),
    )
    got = read_bloom_file(str(out))
    assert got.bits.tobytes() == forced.bits.tobytes()
    assert got.param == forced.param


def test_worker_aligned_stream_builds_aligned_order(vdb_env, tmp_path):
    """A healthy aligned run builds from the alignments-first stream --
    byte-equal to building from that exact sequence list."""
    from kwage.io.bloom_file import read_bloom_file
    from kwage.core.info import FilterInfo
    from kwage.parallel.maestro import (
        STATUS_BLOOM_SUCCESS,
        StreamingResolver,
        execute_bloom_task,
    )
    from kwage.pipeline.make_bloom import build_bloom_from_sequences

    acc = "SRRA000006"
    _write_aligned(vdb_env, acc, ALIGNED_SPOTS, ALIGNED_PALIDS, ALIGNED_READS)
    opt = _stream_opts(tmp_path)
    out = tmp_path / f"{acc}.bloom"
    status, _ = execute_bloom_task(
        acc, FilterInfo(), "full",
        StreamingResolver(str(tmp_path / "scratch")), opt, str(out),
    )
    assert status == STATUS_BLOOM_SUCCESS
    want_seqs = ALIGNED_READS + ["CCCCGGGGAAAA", "TTTTCCCCGGGG", "ACACACACACAC"]
    want = build_bloom_from_sequences(
        want_seqs, opt.build_options(), FilterInfo())
    assert read_bloom_file(str(out)).bits.tobytes() == want.bits.tobytes()


def test_staged_sra_path_streams_vdb_bloom_order(vdb_env, tmp_path):
    """A resolver that stages <acc>.sra routes through the VDB bloom
    stream (local paths are valid VDBManagerPathType targets), keeping
    aligned-first order in prefetch (non-streaming) mode."""
    import os

    from kwage.io.bloom_file import read_bloom_file
    from kwage.core.info import FilterInfo
    from kwage.parallel.maestro import (
        STATUS_BLOOM_SUCCESS,
        SourceResolver,
        execute_bloom_task,
    )
    from kwage.pipeline.make_bloom import build_bloom_from_sequences

    acc = "SRRA000007"
    sra_path = tmp_path / "staged" / f"{acc}.sra"
    sra_path.parent.mkdir()
    sra_path.touch()
    # The mock resolves "<path>.vdb" relative to FAKE_VDB_DIR: mirror the
    # absolute staged path inside it.
    mirror = str(vdb_env) + str(sra_path)
    os.makedirs(os.path.dirname(mirror), exist_ok=True)

    class Staged(SourceResolver):
        def resolve(self, a):
            return str(sra_path)

    import pathlib
    mirror_dir = pathlib.Path(os.path.dirname(mirror))
    _write_aligned(mirror_dir, f"{acc}.sra", ALIGNED_SPOTS, ALIGNED_PALIDS,
                   ALIGNED_READS)

    opt = _stream_opts(tmp_path, stream_sra=False, save_sra=True)
    out = tmp_path / f"{acc}.bloom"
    status, _ = execute_bloom_task(
        acc, FilterInfo(), "full", Staged(), opt, str(out),
    )
    assert status == STATUS_BLOOM_SUCCESS
    want_seqs = ALIGNED_READS + ["CCCCGGGGAAAA", "TTTTCCCCGGGG", "ACACACACACAC"]
    want = build_bloom_from_sequences(
        want_seqs, opt.build_options(), FilterInfo())
    assert read_bloom_file(str(out)).bits.tobytes() == want.bits.tobytes()


@pytest.mark.parametrize("buffer_bp", [None, "10"])
def test_batch_colorspace_fallback(vdb_env, tmp_path, monkeypatch, buffer_bp):
    """The batched (device-build) worker path retries force-unaligned on
    the colorspace signature too -- both when the failure hits while
    buffering a small accession (prepare) and mid-stream on a big one
    routed to the chunked builder (finish, KWAGE_STREAM_BUFFER_BP
    shrunk)."""
    from kwage.io.bloom_file import read_bloom_file
    from kwage.core.info import FilterInfo
    from kwage.parallel.maestro import (
        STATUS_BLOOM_SUCCESS,
        StreamingResolver,
        execute_bloom_batch,
    )
    from kwage.pipeline.make_bloom import build_bloom_device
    from kwage.sriracha.vdb import stream_accession_bloom_vdb

    if buffer_bp is not None:
        monkeypatch.setenv("KWAGE_STREAM_BUFFER_BP", buffer_bp)
    acc = "SRRA000008"
    _write_aligned(vdb_env, acc, ALIGNED_SPOTS, ALIGNED_PALIDS, ALIGNED_READS)
    (vdb_env / f"{acc}.unalbroken").touch()

    opt = _stream_opts(tmp_path, device_build=True)
    out = tmp_path / f"{acc}.bloom"
    results = execute_bloom_batch(
        [(0, acc, FilterInfo(), "full")],
        StreamingResolver(str(tmp_path / "scratch")), opt,
        lambda key: str(out),
    )
    (key, status, param, _t) = results[0]
    assert (key, status) == (0, STATUS_BLOOM_SUCCESS)

    forced = build_bloom_device(
        list(stream_accession_bloom_vdb(acc, force_unaligned=True)),
        opt.build_options(), FilterInfo(),
    )
    assert read_bloom_file(str(out)).bits.tobytes() == forced.bits.tobytes()


# ---------------------------------------------------------------------------
# Direct VDB metadata (sra_meta.cpp:17-122)
# ---------------------------------------------------------------------------

def test_vdb_metadata_database_fallback(vdb_env):
    """A database accession is not a flat table: OpenTableRead fails and
    the read falls back to OpenDBRead + SEQUENCE (sra_meta.cpp:42-55),
    then KTable -> KMetadata -> STATS/TABLE -> BASE_COUNT."""
    from kwage.sriracha.vdb import meta_available, vdb_number_of_bases

    _write_spots(vdb_env, "SRRM000001", [["ACGTACGT"]])
    (vdb_env / "SRRM000001.meta").write_text(
        "BASE_COUNT=12345\nSPOT_COUNT=67\n")
    assert meta_available()
    assert vdb_number_of_bases("SRRM000001") == (12345, 67)


def test_vdb_metadata_flat_table_direct(vdb_env):
    """Flat-table accessions open directly; SPOT_COUNT absent reads 0
    (the reference only consumes BASE_COUNT)."""
    from kwage.sriracha.vdb import vdb_number_of_bases

    _write_spots(vdb_env, "SRRM000002", [["ACGT"]], flat=True)
    (vdb_env / "SRRM000002.meta").write_text("BASE_COUNT=999\n")
    assert vdb_number_of_bases("SRRM000002") == (999, 0)


def test_vdb_metadata_missing_node_raises(vdb_env):
    from kwage.sriracha.sra_source import DownloadError
    from kwage.sriracha.vdb import vdb_number_of_bases

    _write_spots(vdb_env, "SRRM000003", [["ACGT"]])
    with pytest.raises(DownloadError):
        vdb_number_of_bases("SRRM000003")


def test_sra_meta_prefers_library(vdb_env, monkeypatch):
    """pipeline.sra_meta.sra_number_of_bases uses the KMetadata read when
    libncbi-vdb is present -- no sra-stat subprocess; KWAGE_NO_VDB=1
    routes to the toolkit probe (RuntimeError when absent)."""
    import kwage.pipeline.sra_meta as sm

    _write_spots(vdb_env, "SRRM000004", [["ACGT"]])
    (vdb_env / "SRRM000004.meta").write_text(
        "BASE_COUNT=4242\nSPOT_COUNT=11\n")
    monkeypatch.setattr(sm.shutil, "which", lambda _name: None)
    assert sm.sra_number_of_bases("SRRM000004") == (4242, 11)

    monkeypatch.setenv("KWAGE_NO_VDB", "1")
    with pytest.raises(RuntimeError):
        sm.sra_number_of_bases("SRRM000004")


# ---------------------------------------------------------------------------
# ABI-variant libraries (VERDICT r04 task 5): every documented pin and
# fallback exercised against a second mock flavor, not just the
# present/absent binary.
# ---------------------------------------------------------------------------


def _build_variant(tmp_path_factory, name, defines):
    d = tmp_path_factory.mktemp(name)
    so = d / f"lib{name}.so"
    proc = subprocess.run(
        ["g++", "-O1", "-shared", "-fPIC", "-o", str(so), MOCK_SRC]
        + [f"-D{df}" for df in defines],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"variant mock build failed: {proc.stderr[:200]}")
    return so


@pytest.fixture(scope="module")
def old_abi_lib(tmp_path_factory):
    """An older-release flavor: pre-KDB KPathType numbering (database=2,
    table=3) and no KMetadata surface."""
    return _build_variant(tmp_path_factory, "mock_vdb_old",
                          ["MOCK_KPT_DATABASE=2", "MOCK_KPT_TABLE=3",
                           "MOCK_NO_KMETADATA"])


@pytest.fixture(scope="module")
def subset_lib(tmp_path_factory):
    """A symbol-subset flavor missing the KNamelist functions the cursor
    surface REQUIRES."""
    return _build_variant(tmp_path_factory, "mock_vdb_subset",
                          ["MOCK_NO_NAMELIST"])


def _reload_vdb(monkeypatch, lib_path, data_dir, **env):
    """Reload sriracha.vdb with the given library + env so module-level
    KPT pins are re-evaluated exactly as a real process start would."""
    import importlib

    import kwage.sriracha.vdb as vdb_mod

    monkeypatch.setenv("KWAGE_VDB_LIB", str(lib_path))
    monkeypatch.setenv("FAKE_VDB_DIR", str(data_dir))
    monkeypatch.setenv("KWAGE_VDB_RETRY_SLEEP", "0.01")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    importlib.reload(vdb_mod)
    return vdb_mod


@pytest.fixture
def _restore_vdb_module():
    """Whatever a variant test did, leave sriracha.vdb re-imported fresh
    (env vars are already unwound by monkeypatch at this point)."""
    yield
    import importlib

    import kwage.sriracha.vdb as vdb_mod

    importlib.reload(vdb_mod)


def test_old_abi_unpinned_misclassifies(old_abi_lib, tmp_path, monkeypatch,
                                        _restore_vdb_module):
    """Against the old-numbering library WITHOUT the KWAGE_VDB_KPT_* pins
    the database path type (2) is unknown -> the controlled-access
    classification, exactly the failure the pins exist to fix."""
    from kwage.sriracha.sra_source import (
        DownloadError,
        SRA_DOWNLOAD_CONTROLLED_ACCESS,
    )

    vdb_mod = _reload_vdb(monkeypatch, old_abi_lib, tmp_path)
    assert vdb_mod.available()
    _write_spots(tmp_path, "SRRO000001", [["ACGTACGT"]])
    with pytest.raises(DownloadError) as ei:
        list(vdb_mod.stream_accession_vdb("SRRO000001"))
    assert ei.value.status == SRA_DOWNLOAD_CONTROLLED_ACCESS


def test_old_abi_kpt_pins_stream(old_abi_lib, tmp_path, monkeypatch,
                                 _restore_vdb_module):
    """KWAGE_VDB_KPT_DATABASE/_TABLE pins make the old-numbering library
    fully usable: database AND flat-table streaming, sliced ranges
    included."""
    vdb_mod = _reload_vdb(monkeypatch, old_abi_lib, tmp_path,
                          KWAGE_VDB_KPT_DATABASE="2",
                          KWAGE_VDB_KPT_TABLE="3")
    assert vdb_mod.KPT_DATABASE == 2 and vdb_mod.KPT_TABLE == 3
    spots = [["ACGTACGT", "TTGG"], ["GGGGCCCC"], ["AAAA"]]
    _write_spots(tmp_path, "SRRO000002", spots)
    got = list(vdb_mod.stream_accession_vdb("SRRO000002"))
    want = [(i + 1, j + 1, s)
            for i, frags in enumerate(spots) for j, s in enumerate(frags)]
    assert got == want
    _write_spots(tmp_path, "SRRO000003", [["ACAC"], ["GTGT"]], flat=True)
    assert list(vdb_mod.stream_accession_vdb("SRRO000003")) == [
        (1, 0, "ACAC"), (2, 0, "GTGT")]
    # Sliced: each rank streams its VCursorIdRange share.
    both = [r for rank in (0, 1)
            for r in vdb_mod.stream_accession_vdb("SRRO000002",
                                                  rank=rank, ntasks=2)]
    assert sorted(both) == sorted(want)


def test_old_abi_no_kmetadata_fallback(old_abi_lib, tmp_path, monkeypatch,
                                       _restore_vdb_module):
    """A pre-KMetadata library keeps cursor streaming but meta_available()
    is False, vdb_number_of_bases raises (lazy-bind fallback path,
    sriracha/vdb.py), and pipeline.sra_meta routes to the toolkit probe."""
    import kwage.pipeline.sra_meta as sm
    from kwage.sriracha.sra_source import DownloadError

    vdb_mod = _reload_vdb(monkeypatch, old_abi_lib, tmp_path,
                          KWAGE_VDB_KPT_DATABASE="2",
                          KWAGE_VDB_KPT_TABLE="3")
    assert vdb_mod.available()          # cursor surface fully usable
    assert not vdb_mod.meta_available()  # KMetadata genuinely absent
    _write_spots(tmp_path, "SRRO000004", [["ACGT"]])
    (tmp_path / "SRRO000004.meta").write_text("BASE_COUNT=77\n")
    with pytest.raises(DownloadError):
        vdb_mod.vdb_number_of_bases("SRRO000004")
    # pipeline fallback: no sra-stat on PATH -> RuntimeError, NOT a
    # silent wrong answer through a half-bound KMetadata.
    monkeypatch.setattr(sm.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError):
        sm.sra_number_of_bases("SRRO000004")


def test_symbol_subset_library_unavailable(subset_lib, tmp_path, monkeypatch,
                                           _restore_vdb_module):
    """A library missing part of the REQUIRED cursor surface (KNamelist*)
    fails available() at bind time -- never a crash at first use."""
    vdb_mod = _reload_vdb(monkeypatch, subset_lib, tmp_path)
    assert not vdb_mod.available()


def test_read2na_elem_bits_clean_error(vdb_env):
    """A READ column served with elem_bits=2 (packed 2na) is classified
    as READ_FORMAT_ERROR -- the binding must never decode it as ASCII."""
    from kwage.sriracha.sra_source import (
        DownloadError,
        SRA_DOWNLOAD_READ_FORMAT_ERROR,
    )
    from kwage.sriracha.vdb import stream_accession_vdb

    _write_spots(vdb_env, "SRRO000005", [["ACGTACGT"]])
    (vdb_env / "SRRO000005.read2na").touch()
    with pytest.raises(DownloadError) as ei:
        list(stream_accession_vdb("SRRO000005"))
    assert ei.value.status == SRA_DOWNLOAD_READ_FORMAT_ERROR


def test_vdb_smoke_tool(mock_vdb_lib, tmp_path):
    """tools/vdb_smoke.py end to end against the mock: bind report,
    stream, metadata -- the one-command validation for real-library
    machines."""
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "vdb_smoke.py")
    with open(tmp_path / "SRRS000001.vdb", "w") as f:
        f.write("ACGTACGT|TTGG\nGGGGCCCC\n")
    (tmp_path / "SRRS000001.meta").write_text(
        "BASE_COUNT=20\nSPOT_COUNT=2\n")
    env = dict(os.environ, KWAGE_VDB_LIB=str(mock_vdb_lib),
               FAKE_VDB_DIR=str(tmp_path), KWAGE_VDB_RETRY_SLEEP="0.01")
    proc = subprocess.run(
        [sys.executable, script, "--max-frags", "2", "SRRS000001"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-1000:]
    rep = json.loads(proc.stdout)
    assert rep["available"] and rep["meta_available"]
    assert rep["path_type_known"] and rep["stream_ok"]
    assert [f["head"] for f in rep["streamed_fragments"]] == [
        "ACGTACGT", "TTGG"]
    assert rep["metadata"] == {"BASE_COUNT": 20, "SPOT_COUNT": 2}

    # Without the accession: pure bind check, exit 0.
    proc = subprocess.run([sys.executable, script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    # With a library that does not exist: available False, exit 1.
    env["KWAGE_VDB_LIB"] = str(tmp_path / "nope.so")
    proc = subprocess.run([sys.executable, script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["available"] is False
