"""Maestro: the database-construction scheduler and worker runtime.

The JAX re-design of the reference's MPI master/worker engine
(maestro_main.cpp / worker_main.cpp). The dynamic task queue stays on the
host (the reference's rank-0 event loop becomes a future-based pool over
threads or processes; k-mer counting runs in the native library which
releases the GIL); the per-accession status-byte state machine, retry
queues, per-shape database quotas, periodic atomic checkpoints and
restart rescans are preserved exactly, including the on-disk status-file
format (file_io.cpp:201-282), so a job can be stopped and resumed
interchangeably with the reference semantics.

Work priority per scheduling round (maestro_main.cpp:339-457):
  1. database packing when a BloomParam group reaches its quota
     (forced flush when all accessions are terminal),
  2. Bloom filter creation (streaming) or creation-from-download,
  3. downloads (non-streaming mode), throttled by --delay.

SRA ingestion is a pluggable SourceResolver; the default resolves
accessions to local FASTA/FASTQ files (<source_dir>/<accession>.fasta*),
and a PrefetchResolver shells out to the SRA toolkit like the reference
(worker_main.cpp:384-474) when available.
"""

from __future__ import annotations

import os
import subprocess
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np

from ..core.accession import accession_to_str
from ..utils.mem_usage import memory_usage
from ..core.hash import MURMUR_HASH_32
from ..core.info import FilterInfo
from ..core.params import (
    BloomParam,
    DEFAULT_FALSE_POSITIVE_PROBABILITY,
    DEFAULT_KMER_LENGTH,
    DEFAULT_MAX_LOG_2_FILTER_LEN,
    DEFAULT_MIN_LOG_2_FILTER_LEN,
    DEFAULT_SRA_MIN_KMER_COUNT,
    filters_per_file_quota,
)
from ..io.bloom_file import read_bloom_file, write_bloom_file
from ..io.inventory import read_inventory
from ..io.status import read_status_file, write_status_file
from ..pipeline.build_db import build_db_from_bloom_files
from ..pipeline.make_bloom import BloomInvalid, BuildOptions, build_bloom_from_file

# ---------------------------------------------------------------------------
# Status byte vocabulary (maestro.h:8-45). Values must match the reference
# so status files are interchangeable.
# ---------------------------------------------------------------------------
STATUS_INIT = 1
STATUS_DOWNLOAD_SUCCESS = 2
STATUS_DOWNLOAD_FAIL = 3
STATUS_DOWNLOAD_FAIL_1 = 4
STATUS_DOWNLOAD_FAIL_10 = 13
MAX_NUM_DOWNLOAD_FAIL = STATUS_DOWNLOAD_FAIL_10
STATUS_BLOOM_SUCCESS = 14
STATUS_BLOOM_FAIL = 15
STATUS_BLOOM_INVALID = 16
STATUS_DATABASE_SUCCESS = 17
STATUS_DATABASE_FAIL = 18
STATUS_DATABASE_UPLOAD_FAIL = 19
STATUS_BLOOM_FAIL_1 = 20
STATUS_BLOOM_FAIL_10 = 29
STATUS_SKIPPED = 30

STATUS_NAMES = {
    STATUS_INIT: "init",
    STATUS_DOWNLOAD_SUCCESS: "downloaded",
    STATUS_DOWNLOAD_FAIL: "download failed (final)",
    STATUS_BLOOM_SUCCESS: "bloom built",
    STATUS_BLOOM_FAIL: "bloom failed (final)",
    STATUS_BLOOM_INVALID: "bloom invalid",
    STATUS_DATABASE_SUCCESS: "database committed",
    STATUS_DATABASE_FAIL: "database failed",
    STATUS_DATABASE_UPLOAD_FAIL: "database upload failed",
    STATUS_SKIPPED: "skipped",
}
for _n in range(1, 11):
    STATUS_NAMES[STATUS_DOWNLOAD_FAIL_1 + _n - 1] = f"download failed (attempt {_n})"
    STATUS_NAMES[STATUS_BLOOM_FAIL_1 + _n - 1] = f"bloom failed (attempt {_n})"
del _n

CHECKPOINT_EVERY_SEC = 300  # maestro_main.cpp:63-64


class SourceResolver:
    """Maps an SRA run accession to a local sequence file to digest."""

    def resolve(self, accession: str) -> str | None:  # pragma: no cover
        raise NotImplementedError

    def lookup(self, accession: str) -> str | None:
        """Local-only probe: the already-materialized source for an
        accession, or None. Used by the restore_download rescan
        (maestro_main.cpp:618-656) which must not trigger network
        downloads. Default: None (nothing staged locally)."""
        return None

    def open_stream(self, accession: str):
        """Iterator of read sequences streamed straight from the source,
        or None when the resolver can only materialize files. Streaming
        keeps peak scratch usage independent of accession size (the
        reference's VDB-cursor shape, sra_stream.cpp:90-211)."""
        return None

    def open_bloom_stream(self, accession: str,
                          force_unaligned: bool = False):
        """Read stream in the reference's BLOOM ingest order
        (make_bloom.cpp:170-300: primary alignments first, then fully
        unaligned spots, for aligned runs), as a BloomStream carrying
        live progress counters, or None. Default: wrap open_stream
        (spot order, no counters -- correct for local files and
        unaligned runs)."""
        stream = self.open_stream(accession)
        return None if stream is None else BloomStream(stream)

    def cleanup(self, accession: str, path: str) -> None:
        pass


class BloomStream:
    """A read-sequence stream plus its live ingest-progress counters
    (sriracha.vdb.BloomStreamProgress, or None when the source has no
    aligned/unaligned distinction)."""

    def __init__(self, it, progress=None):
        self._it = iter(it)
        self.progress = progress

    def __iter__(self):
        return self._it


def _colorspace_retry_signature(progress) -> bool:
    """The aligned-colorspace failure signature (worker_main.cpp:301-310,
    ncbi-vdb#31): every primary alignment streamed, unaligned reads known
    to exist, none read. A failed build matching it retries once with
    force_unaligned."""
    return (
        progress is not None
        and progress.num_primary_align > 0
        and progress.curr_primary_align == progress.num_primary_align
        and progress.num_unaligned_read > 0
        and progress.curr_unaligned_read == 0
    )


class LocalFastaResolver(SourceResolver):
    """Accession -> <source_dir>/<accession>.(fasta|fastq)[.gz]."""

    from ..io.sequence import SEQUENCE_EXTS as _SEQ
    EXTS = _SEQ + (".sra",)
    del _SEQ

    def __init__(self, source_dir: str):
        self.source_dir = source_dir

    def resolve(self, accession: str) -> str | None:
        for ext in self.EXTS:
            path = os.path.join(self.source_dir, accession + ext)
            if os.path.isfile(path):
                return path
        return None

    # Resolution is already a pure local probe.
    lookup = resolve


class PrefetchResolver(SourceResolver):
    """Shells out to the SRA toolkit `prefetch` like worker_main.cpp:384-474."""

    def __init__(self, repo_dir: str, max_size_gb: int = 30,
                 prefetch_bin: str = "prefetch"):
        self.repo_dir = repo_dir
        self.max_size_gb = max_size_gb
        self.prefetch_bin = prefetch_bin

    def resolve(self, accession: str) -> str | None:
        cmd = [self.prefetch_bin, "--max-size", f"{self.max_size_gb}G", accession]
        try:
            proc = subprocess.run(cmd, cwd=self.repo_dir, capture_output=True)
        except FileNotFoundError:
            return None
        if proc.returncode != 0:
            return None
        path = os.path.join(self.repo_dir, accession, accession + ".sra")
        return path if os.path.isfile(path) else None

    def lookup(self, accession: str) -> str | None:
        for path in (
            os.path.join(self.repo_dir, accession, accession + ".sra"),
            os.path.join(self.repo_dir, accession + ".sra"),
        ):
            if os.path.isfile(path):
                return path
        return None

    def cleanup(self, accession: str, path: str) -> None:
        import shutil

        d = os.path.join(self.repo_dir, accession)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)


class StreamingResolver(SourceResolver):
    """--stream mode: materialize reads directly with fasterq-dump (no
    .sra staging), the closest available analog of the reference's VDB
    streaming workers (maestro --stream; worker_main.cpp SCHEDULE_BLOOM
    streaming branch). Uses the classified-status downloader shared with
    sriracha (sriracha/sra_source.py)."""

    def __init__(self, scratch_dir: str):
        self.scratch_dir = scratch_dir

    def resolve(self, accession: str) -> str | None:
        from ..sriracha.sra_source import DownloadError, resolve_accession

        try:
            return resolve_accession(
                accession, os.path.join(self.scratch_dir, accession)
            )
        except DownloadError:
            return None

    def lookup(self, accession: str) -> str | None:
        import glob

        hits = sorted(glob.glob(os.path.join(self.scratch_dir, accession, "*")))
        return hits[0] if hits else None

    def open_stream(self, accession: str):
        """Pipe reads straight off fasterq-dump --stdout: no .sra staging,
        no FASTQ materialization (sriracha/sra_source.stream_accession).
        Each mate FRAGMENT arrives as its own read, matching the
        reference's per-fragment READ_LEN split (sra_stream.cpp:358-377)
        -- no chimeric k-mers spanning a mate junction."""
        from ..sriracha.sra_source import stream_accession

        return (seq for _, _, seq in stream_accession(accession))

    def open_bloom_stream(self, accession: str,
                          force_unaligned: bool = False):
        """Bloom-order stream (make_bloom.cpp:170-300): with libncbi-vdb
        present, aligned runs stream primary alignments first, then
        fully unaligned spots, and the returned BloomStream's progress
        counters let the worker detect the aligned-colorspace failure
        signature. Pipe fallback is spot order (not bit-identical for
        aligned runs -- PARITY.md)."""
        from ..sriracha.sra_source import stream_accession_bloom
        from ..sriracha.vdb import BloomStreamProgress

        progress = BloomStreamProgress()
        return BloomStream(
            stream_accession_bloom(
                accession, force_unaligned=force_unaligned, progress=progress
            ),
            progress,
        )

    def cleanup(self, accession: str, path: str) -> None:
        import shutil

        d = os.path.join(self.scratch_dir, accession)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)


@dataclass
class MaestroOptions:
    metadata_file: str = ""
    scratch_bloom_dir: str = ""
    scratch_database_dir: str = ""
    status_file: str = "./__sra_db_status.bin"
    s3_bucket: str = ""
    skip_sra: list[str] = field(default_factory=list)
    false_positive_probability: float = DEFAULT_FALSE_POSITIVE_PROBABILITY
    download_delay: float = 0.0
    min_kmer_count: int = DEFAULT_SRA_MIN_KMER_COUNT
    kmer_len: int = DEFAULT_KMER_LENGTH
    min_log_2_filter_len: int = DEFAULT_MIN_LOG_2_FILTER_LEN
    max_log_2_filter_len: int = DEFAULT_MAX_LOG_2_FILTER_LEN
    max_sra_file_size_GB: int = 30
    hash_func: int = MURMUR_HASH_32
    num_download_attempt: int = 3
    limit_num_download: int = 0  # --halt-after (0 = unlimited)
    retry_bloom: bool = False
    save_bloom: bool = False
    save_db: bool = False
    save_sra: bool = False
    s3_no_write: bool = False
    stream_sra: bool = False  # default: download via prefetch (options.cpp:427)
    verbose: bool = False
    num_workers: int = 4
    # Device ingest mode: exact-count thresholding on device instead of the
    # host counting-Bloom (see kwage.ops.counting).
    device_build: bool = False
    # Accessions fused per device dispatch in device-build mode: one
    # count sort and one scatter per batch amortize the host<->device
    # round trips that dominate per-accession builds (see
    # pipeline.make_bloom.build_blooms_device_batch). 1 disables.
    # 16 balances the two per-batch sync round trips against the
    # dispatch-ahead window; not yet re-measured on this device.
    device_batch: int = 16
    # Write zlib-chunked .dbz database files (engine extension).
    compress_db: bool = False
    # Transpose on device via the packed bit-transpose (engine
    # extension; ops.transpose).
    device_transpose: bool = False
    # Seconds between status-histogram displays (reference: 15 min,
    # maestro_main.cpp:63).
    status_display_sec: float = 900.0
    # Index the inventory by (accession, offset) and load FilterInfo
    # records on demand instead of materializing millions of them -- the
    # reference's parse_accession_loc memory profile (file_io.cpp:23-118).
    lazy_inventory: bool = False
    # counting-filter clamp passthrough (tests shrink it)
    min_log_2_count_len: int = 18
    max_log_2_count_len: int = 32
    # Static multi-host split (engine extension): this scheduler owns only
    # inventory shard slice_index of num_slice (the contiguous
    # shard_inventory range; same partition rule as SriRachA read ranges,
    # sra_stream.cpp:525-543). Out-of-shard accessions are pre-marked
    # SKIPPED, and database files number slice_index+1, +num_slice, ... so
    # shards sharing one S3 bucket never collide on sra.<index>.db names.
    # Each shard needs its OWN --status file and scratch directories.
    slice_index: int = 0
    num_slice: int = 1

    def build_options(self) -> BuildOptions:
        return BuildOptions(
            kmer_len=self.kmer_len,
            min_kmer_count=self.min_kmer_count,
            false_positive_probability=self.false_positive_probability,
            min_log_2_filter_len=self.min_log_2_filter_len,
            max_log_2_filter_len=self.max_log_2_filter_len,
            hash_func=self.hash_func,
            min_log_2_count_len=self.min_log_2_count_len,
            max_log_2_count_len=self.max_log_2_count_len,
        )


def _open_sra_bloom_stream(path: str, force_unaligned: bool = False):
    """Bloom-order stream over a staged local .sra (a valid
    VDBManagerPathType target), or None without libncbi-vdb."""
    from ..sriracha import vdb

    if os.environ.get("KWAGE_NO_VDB") == "1" or not vdb.available():
        return None
    progress = vdb.BloomStreamProgress()
    return BloomStream(
        vdb.stream_accession_bloom_vdb(
            path, force_unaligned=force_unaligned, progress=progress),
        progress,
    )


def _build_bloom_streamed(
    open_stream_fn,
    opt: "MaestroOptions",
    info: FilterInfo,
    bloom_out_path: str,
) -> tuple[int, "BloomParam | None"]:
    """Build + write one filter off a bloom-order stream, classifying the
    outcome, with the aligned-colorspace forced-unaligned retry: a failed
    attempt whose progress counters match the signature re-streams the
    whole accession force-unaligned (worker_main.cpp:301-310).
    ``open_stream_fn(force_unaligned)`` returns a BloomStream."""
    from ..pipeline.make_bloom import build_bloom_from_sequences
    from ..sriracha.sra_source import DownloadError

    stream = open_stream_fn(False)
    for attempt in range(2):
        try:
            if opt.device_build:
                from ..pipeline.make_bloom import build_bloom_device

                rec = build_bloom_device(stream, opt.build_options(), info)
            else:
                # The inventory's number_of_bases pre-sizes the counting
                # filter exactly like the reference reads BASE_COUNT from
                # SRA metadata (sra_meta.cpp:17-122).
                rec = build_bloom_from_sequences(
                    stream, opt.build_options(), info,
                    num_bp_hint=info.number_of_bases or None,
                )
            write_bloom_file(bloom_out_path, rec)
            return STATUS_BLOOM_SUCCESS, rec.param
        except BloomInvalid:
            return STATUS_BLOOM_INVALID, None
        except Exception as e:  # noqa: BLE001 -- classified below
            if attempt == 0 and _colorspace_retry_signature(
                    getattr(stream, "progress", None)):
                stream = open_stream_fn(True)
                continue
            if isinstance(e, DownloadError):
                return STATUS_DOWNLOAD_FAIL, None
            return STATUS_BLOOM_FAIL, None
    raise AssertionError("unreachable")  # pragma: no cover


def execute_bloom_task(
    acc: str,
    info: FilterInfo,
    phase: str,
    resolver: SourceResolver,
    opt: "MaestroOptions",
    bloom_out_path: str,
    on_downloaded=None,
) -> tuple[int, "BloomParam | None"]:
    """The pure worker-side Bloom task, shared by the local thread pool
    and remote (cross-host) workers: stage the source, build one filter,
    write the .bloom, classify the outcome (worker_main.cpp:245-474).

    phase "full" may download (and in --stream mode pipes reads straight
    off the toolkit with zero scratch, make_bloom.cpp:170-300); phase
    "bloom" only looks up an already-staged source. ``on_downloaded``
    fires after a successful non-streaming download so the scheduler can
    persist STATUS_DOWNLOAD_SUCCESS for crash resume.
    """
    if phase == "full" and opt.stream_sra:
        stream = resolver.open_bloom_stream(acc)
        if stream is not None:
            first = [stream]

            def open_fn(forced: bool):
                if not forced and first:
                    return first.pop()
                return resolver.open_bloom_stream(acc, force_unaligned=forced)

            return _build_bloom_streamed(open_fn, opt, info, bloom_out_path)

    path = resolver.lookup(acc) if phase == "bloom" else resolver.resolve(acc)
    if path is None:
        return STATUS_DOWNLOAD_FAIL, None
    if not opt.stream_sra and on_downloaded is not None:
        on_downloaded()
    if path.endswith(".sra"):
        # A staged .sra (prefetch mode, worker_main.cpp:384-474) is
        # opaque to the FASTA/FASTQ parsers; read it through the VDB
        # bloom stream -- local paths are valid VDBManagerPathType
        # targets -- so aligned runs keep the reference's
        # alignments-first ingest order (make_bloom.cpp:170-300).
        stream = _open_sra_bloom_stream(path)
        if stream is not None:
            first = [stream]

            def open_sra(forced: bool):
                if not forced and first:
                    return first.pop()
                return _open_sra_bloom_stream(path, force_unaligned=forced)

            status, param = _build_bloom_streamed(
                open_sra, opt, info, bloom_out_path)
            if not opt.save_sra:
                resolver.cleanup(acc, path)
            return status, param
    try:
        if opt.device_build:
            from ..io.sequence import iter_sequences
            from ..pipeline.make_bloom import build_bloom_device

            rec = build_bloom_device(
                (s for _, s in iter_sequences(path)), opt.build_options(), info
            )
        else:
            rec = build_bloom_from_file(path, opt.build_options(), info)
        write_bloom_file(bloom_out_path, rec)
        status: int = STATUS_BLOOM_SUCCESS
        param = rec.param
    except BloomInvalid:
        status, param = STATUS_BLOOM_INVALID, None
    except Exception:
        status, param = STATUS_BLOOM_FAIL, None
    if not opt.save_sra:
        resolver.cleanup(acc, path)
    return status, param


def _take_until_bp(stream, limit_bp: int) -> tuple[list[str], int, bool]:
    """Buffer reads off ``stream`` until limit_bp bases are held. Returns
    (buffered reads, buffered bases, stream_exhausted)."""
    buf: list[str] = []
    bp = 0
    for seq in stream:
        buf.append(seq)
        bp += len(seq)
        if bp > limit_bp:
            return buf, bp, False
    return buf, bp, True


# A streamed accession joins the fused batch dispatch only while its
# buffered prefix stays under this many bases; past it, the rest of the
# stream feeds the chunked single-accession device builder directly, so
# worker RAM is bounded regardless of accession size (the reference's
# streaming shape, SriRachA/sra_stream.cpp:90-211). Matches the batch
# builder's own big-job routing threshold (make_bloom.chunk_bp).
# Overridable via KWAGE_STREAM_BUFFER_BP (engine extension).
def _stream_batch_buffer_bp() -> int:
    """KWAGE_STREAM_BUFFER_BP read at use time (like the other env
    knobs), not frozen at import."""
    return int(os.environ.get("KWAGE_STREAM_BUFFER_BP", 8_000_000))


@dataclass
class BloomBatchWork:
    """Host-prepared batch of Bloom tasks awaiting device execution."""

    out: list                 # early (status) events: failures, routed jobs
    jobs: list                # fused-batch jobs [(source, FilterInfo)]
    job_meta: list            # (key, accession, cleanup path) per job
    big_streams: list         # (key, acc, reopen fn, read iter, progress,
                              #  FilterInfo, cleanup path)
    prep: "object | None"     # make_bloom.DeviceBatchPrep for the fused jobs
    t0: float


def prepare_bloom_batch(
    tasks: list[tuple[int, str, FilterInfo, str]],
    resolver: SourceResolver,
    opt: "MaestroOptions",
    on_downloaded=None,
) -> BloomBatchWork:
    """Host phase of the batched worker task: resolve/stream every
    source and 2-bit-pack the fused block (make_bloom.prepare_device_batch).
    No device work: safe on a parse thread while the device runs another
    batch. ``tasks`` entries are (key, accession, FilterInfo, phase);
    ``on_downloaded(key)`` fires after each successful non-streaming
    download. Streamed sources larger than KWAGE_STREAM_BUFFER_BP (8 Mbp default) never
    materialize -- their buffered prefix plus the live pipe are handed to
    the device phase for a chunked build."""
    from itertools import chain

    from ..pipeline.make_bloom import prepare_device_batch
    from ..sriracha.sra_source import DownloadError

    t0 = time.time()
    out: list[tuple[int, int, BloomParam | None, float]] = []
    jobs: list[tuple[list[str] | str, FilterInfo]] = []
    job_meta: list[tuple[int, str, str | None]] = []  # (key, acc, cleanup path)
    big_streams: list = []
    for key, acc, info, phase in tasks:
        source: list[str] | str | None = None
        path: str | None = None
        try:
            stream = open_fn = None
            if phase == "full" and opt.stream_sra:
                stream = resolver.open_bloom_stream(acc)
                if stream is not None:
                    def open_fn(forced, _a=acc):  # noqa: E731
                        return resolver.open_bloom_stream(
                            _a, force_unaligned=forced)
            if stream is None:
                path = resolver.lookup(acc) if phase == "bloom" else resolver.resolve(acc)
                if path is None:
                    out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
                    continue
                if not opt.stream_sra and on_downloaded is not None:
                    on_downloaded(key)
                if path.endswith(".sra"):
                    # Staged .sra: opaque to the FASTA/FASTQ parsers;
                    # stream it through the VDB cursors in the
                    # reference's bloom ingest order.
                    stream = _open_sra_bloom_stream(path)
                    if stream is not None:
                        def open_fn(forced, _p=path):  # noqa: E731
                            return _open_sra_bloom_stream(
                                _p, force_unaligned=forced)
                if stream is None:
                    # Pass the path through: the batch builder parses and
                    # 2-bit-packs it natively (zero Python strings).
                    source = path
            if stream is not None:
                try:
                    buf, _bp, exhausted = _take_until_bp(
                        stream, _stream_batch_buffer_bp()
                    )
                except Exception:
                    # Aligned-colorspace fallback: re-stream forced
                    # unaligned (worker_main.cpp:301-310).
                    if not _colorspace_retry_signature(
                            getattr(stream, "progress", None)):
                        raise
                    stream = open_fn(True)
                    buf, _bp, exhausted = _take_until_bp(
                        stream, _stream_batch_buffer_bp()
                    )
                if exhausted:
                    # Small accession: the bounded buffer joins the
                    # fused batch dispatch.
                    source = buf
                else:
                    # Big accession: hand the buffered prefix + live
                    # pipe to the device phase for a chunked
                    # KMC-style build -- peak RAM is the chunk plus
                    # the distinct-k-mer set, independent of
                    # accession size.
                    big_streams.append((
                        key, acc, open_fn, chain(buf, iter(stream)),
                        getattr(stream, "progress", None), info, path,
                    ))
                    continue
        except DownloadError:
            out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
            continue
        except Exception:
            out.append((key, STATUS_BLOOM_FAIL, None, time.time() - t0))
            continue
        jobs.append((source, info))
        job_meta.append((key, acc, path))

    prep = prepare_device_batch(jobs, opt.build_options()) if jobs else None
    return BloomBatchWork(out=out, jobs=jobs, job_meta=job_meta,
                          big_streams=big_streams, prep=prep, t0=t0)


def finish_bloom_batch(
    work: BloomBatchWork,
    resolver: SourceResolver,
    opt: "MaestroOptions",
    bloom_path_fn,
    handles=None,
    state=None,
) -> list[tuple[int, int, "BloomParam | None", float]]:
    """Device phase of the batched worker task: run/finish the fused
    dispatches, build any streamed big jobs off their live pipes, write
    the .bloom files, classify every outcome. ``state`` carries an
    already-dispatched scatter (pipelined path: the filter transfer is
    in flight when this runs)."""
    from ..pipeline.make_bloom import (
        build_bloom_device,
        complete_device_batch,
        finish_device_batch,
    )
    from ..sriracha.sra_source import DownloadError

    out = list(work.out)
    t0 = work.t0
    for key, acc, open_fn, stream, progress, info, path in work.big_streams:
        try:
            try:
                rec = build_bloom_device(stream, opt.build_options(), info)
            except BloomInvalid:
                raise
            except Exception:
                # Aligned-colorspace fallback: re-stream the whole
                # accession force-unaligned (worker_main.cpp:301-310).
                if not _colorspace_retry_signature(progress):
                    raise
                rec = build_bloom_device(
                    open_fn(True), opt.build_options(), info)
            write_bloom_file(bloom_path_fn(key), rec)
            out.append((key, STATUS_BLOOM_SUCCESS, rec.param, time.time() - t0))
        except DownloadError:
            out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
        except BloomInvalid:
            out.append((key, STATUS_BLOOM_INVALID, None, time.time() - t0))
        except Exception:
            out.append((key, STATUS_BLOOM_FAIL, None, time.time() - t0))
        if path is not None and not opt.save_sra:
            resolver.cleanup(acc, path)

    if work.prep is not None:
        if state is not None:
            recs = complete_device_batch(work.prep, opt.build_options(), state)
        else:
            recs = finish_device_batch(work.prep, opt.build_options(), handles)
        for (key, acc, path), rec in zip(work.job_meta, recs):
            if isinstance(rec, BloomInvalid):
                status, param = STATUS_BLOOM_INVALID, None
            elif isinstance(rec, Exception) or rec is None:
                status, param = STATUS_BLOOM_FAIL, None
            else:
                try:
                    write_bloom_file(bloom_path_fn(key), rec)
                    status, param = STATUS_BLOOM_SUCCESS, rec.param
                except Exception:
                    status, param = STATUS_BLOOM_FAIL, None
            if path is not None and not opt.save_sra:
                resolver.cleanup(acc, path)
            out.append((key, status, param, time.time() - t0))
    return out


def execute_bloom_batch(
    tasks: list[tuple[int, str, FilterInfo, str]],
    resolver: SourceResolver,
    opt: "MaestroOptions",
    bloom_path_fn,
    on_downloaded=None,
) -> list[tuple[int, int, "BloomParam | None", float]]:
    """Batched worker-side Bloom task (remote workers and the
    non-pipelined path): prepare + finish back to back. The local
    device-build scheduler instead software-pipelines the two phases
    across batches (see Maestro._run)."""
    work = prepare_bloom_batch(tasks, resolver, opt, on_downloaded)
    return finish_bloom_batch(work, resolver, opt, bloom_path_fn)


class _DeviceDispatcher:
    """Single owner of ALL device dispatches in device-build mode (one
    device = one resource: concurrent jit dispatch from threads
    contends). Two-stage software pipeline:

      stage A (batch i):  count dispatch -> nv readback -> solve ->
                          scatter dispatch -> START async filter copy
      stage B (batch i-1): collect the (in-flight) filter bytes, write
                           the .bloom files, classify outcomes

    The loop runs A(i) then B(i-1): batch i-1's filter transfer rides
    under batch i's count kernel + readback wait. Dispatch ORDER keeps
    each batch's scatter ahead of the next batch's count, so no batch's
    critical path queues behind another's compute (the naive
    dispatch-ahead variant did exactly that and measured SLOWER)."""

    _STOP = object()

    def __init__(self, maestro: "Maestro"):
        import queue
        import threading

        self.m = maestro
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, work: BloomBatchWork) -> Future:
        fut: Future = Future()
        self.q.put((work, fut))
        return fut

    def stop(self) -> None:
        self.q.put(self._STOP)
        self._thread.join()

    def _run(self) -> None:
        import queue

        from ..pipeline.make_bloom import (
            dispatch_device_batch,
            scatter_device_batch,
        )

        from collections import deque

        # Batches with stage A dispatched, awaiting stage B. The window
        # depth D (KWAGE_PIPE_DEPTH, default 2 = the measured-best
        # A(i)/B(i-1) interleave) keeps up to D-1 scatter states in
        # flight; stage B for the oldest runs only once the window fills,
        # so its filter transfer hides under the newer batches' compute.
        depth = max(2, int(os.environ.get("KWAGE_PIPE_DEPTH", "2")))
        tails: deque = deque()  # (work, fut, scatter state)
        stopped = False
        while not (stopped and not tails):
            item = None
            if not stopped:
                try:
                    item = self.q.get(block=not tails)
                except queue.Empty:
                    item = None
            if item is self._STOP:
                stopped = True
                item = None
            trace = os.environ.get("KWAGE_PIPE_TRACE") == "1"
            if item is not None:
                work, fut = item
                try:
                    t0 = time.perf_counter()
                    state = None
                    if work.prep is not None:
                        opts = self.m.opt.build_options()
                        handles = dispatch_device_batch(work.prep, opts)
                        state = scatter_device_batch(work.prep, opts, handles)
                    if trace:
                        print(f"[pipe] stageA {1e3 * (time.perf_counter() - t0):.1f} ms")
                    tails.append((work, fut, state))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
            while tails and (len(tails) >= depth or item is None or stopped):
                work, fut, state = tails.popleft()
                try:
                    t0 = time.perf_counter()
                    fut.set_result(finish_bloom_batch(
                        work, self.m.resolver, self.m.opt, self.m.bloom_path,
                        state=state,
                    ))
                    if trace:
                        print(f"[pipe] stageB {1e3 * (time.perf_counter() - t0):.1f} ms")
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
                if not (item is None or stopped):
                    break


class _LazyInfos:
    """Sequence view over a binary inventory that loads each FilterInfo
    from its file offset on access (parse_accession_loc memory profile:
    the scheduler holds one index entry per accession, not the records)."""

    def __init__(self, path: str):
        from ..io.inventory import scan_inventory_locations

        self._path = path
        pairs = scan_inventory_locations(path)
        self.accession_codes = [a for a, _ in pairs]
        self._offsets = [o for _, o in pairs]

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, idx: int) -> FilterInfo:
        from ..io.inventory import read_filter_info_at

        return read_filter_info_at(self._path, self._offsets[idx])


class Maestro:
    """The scheduler. One instance per database-construction job."""

    def __init__(
        self,
        opt: MaestroOptions,
        resolver: SourceResolver,
        infos: list[FilterInfo] | None = None,
    ):
        self.opt = opt
        self.resolver = resolver
        if infos is None:
            if opt.lazy_inventory:
                infos = _LazyInfos(opt.metadata_file)
            else:
                infos = read_inventory(opt.metadata_file)
        self.infos = infos
        if isinstance(infos, _LazyInfos):
            self.accessions = [accession_to_str(a) for a in infos.accession_codes]
        else:
            self.accessions = [accession_to_str(i.run_accession) for i in infos]
        self.status = np.full(len(infos), STATUS_INIT, dtype=np.uint8)
        # Database files count from 1 (maestro_main.cpp:180); a sliced
        # scheduler counts from slice_index+1 with stride num_slice so
        # shard outputs interleave without name collisions.
        self.database_index = 1 + (
            self.opt.slice_index if self.opt.num_slice > 1 else 0
        )
        self._mark_out_of_slice()
        # Reference scheduling state (maestro_main.cpp:246-250, 282-283):
        # a forward-only cursor over the inventory for fresh work, an
        # in-memory retry deque (dispatches from it do NOT pre-mark the
        # status byte -- only cursor dispatches do), and the deque of
        # downloaded-but-not-yet-bloomed accessions filled by the
        # restore_download rescan.
        self._cursor = 0
        self._end = len(infos)
        self._retry: deque[int] = deque()
        self._download_ready: deque[int] = deque()
        self._forced_flush = False
        # Event-driven BloomParam -> member-index map, the analog of the
        # reference's in-memory quota bookkeeping
        # (maestro_main.cpp:87-106): bloom-success events append; quota
        # packing pops. Rebuilt from scratch files only in restore() --
        # the event loop itself never opens a .bloom.
        self._groups: dict[BloomParam, list[int]] = {}
        # Every index ever absorbed into the group map (survives the
        # group being popped for packing): guards against duplicate
        # completion events re-appending a filter.
        self._grouped: set[int] = set()
        # Bounded-retry deviation: the reference's download-success event
        # resets the status byte to STATUS_DOWNLOAD_SUCCESS
        # (maestro_main.cpp:865), erasing any BLOOM_FAIL_n attempt count,
        # so a deterministic bloom failure retries forever there in
        # download mode. The worker task here preserves the BLOOM_FAIL_n
        # byte across the re-download (execute_bloom_task.on_downloaded)
        # so retries stay bounded by --retry.
        self._last_checkpoint = 0.0
        self._last_download = 0.0
        self._start_time = time.time()
        self._last_display = time.time()
        self._total_bp = 0
        self._total_filter_bytes = 0
        self._log = (lambda *a: print(*a)) if opt.verbose else (lambda *a: None)

        os.makedirs(opt.scratch_bloom_dir, exist_ok=True)
        os.makedirs(opt.scratch_database_dir, exist_ok=True)

    # -- state persistence ---------------------------------------------------

    def bloom_path(self, idx: int) -> str:
        return os.path.join(self.opt.scratch_bloom_dir, self.accessions[idx] + ".bloom")

    def _mark_out_of_slice(self) -> None:
        """--slice/--of static split: accessions outside this scheduler's
        contiguous inventory shard are terminal-SKIPPED (idempotent;
        re-applied after every status restore, like --skip marking)."""
        if self.opt.num_slice <= 1:
            return
        from .distributed import shard_inventory

        first, last = shard_inventory(
            len(self.status), self.opt.slice_index, self.opt.num_slice
        )
        self.status[:first] = STATUS_SKIPPED
        self.status[last:] = STATUS_SKIPPED

    def restore(self) -> None:
        """restore_status + scratch rescans (maestro_main.cpp:200-240, 618-802)."""
        if os.path.exists(self.opt.status_file):
            self.status, self.database_index = read_status_file(
                self.opt.status_file, len(self.infos)
            )
            self.status = self.status.copy()
            base = 1 + (self.opt.slice_index if self.opt.num_slice > 1 else 0)
            self.database_index = max(base, self.database_index)

        # --retry.bloom resurrects hard failures, including the final
        # STATUS_BLOOM_FAIL (maestro_main.cpp:200-217).
        if self.opt.retry_bloom:
            hard_fail = (self.status == STATUS_BLOOM_FAIL) | (
                (self.status >= STATUS_BLOOM_FAIL_1) & (self.status <= STATUS_BLOOM_FAIL_10)
            )
            self.status[hard_fail] = STATUS_INIT

        # --skip marking, unconditional on the current state
        # (maestro_main.cpp:219-240).
        skip = set(self.opt.skip_sra)
        for i, acc in enumerate(self.accessions):
            if acc in skip:
                self.status[i] = STATUS_SKIPPED
        self._mark_out_of_slice()

        # restore_download (maestro_main.cpp:618-656): in download mode a
        # STATUS_DOWNLOAD_SUCCESS accession whose staged source still
        # exists goes straight to the Bloom queue; a missing source rolls
        # back to INIT. Streaming mode re-streams them instead (they stay
        # DOWNLOAD_SUCCESS and the cursor picks them up).
        self._download_ready.clear()
        if not self.opt.stream_sra:
            for i in np.nonzero(self.status == STATUS_DOWNLOAD_SUCCESS)[0]:
                if self.resolver.lookup(self.accessions[int(i)]) is not None:
                    self._download_ready.append(int(i))
                else:
                    self.status[i] = STATUS_INIT

        # restore_bloom (maestro_main.cpp:699-802): reconcile claimed Bloom
        # successes AND database failures with scratch reality. A valid
        # complete .bloom file re-enters the packing pool (DATABASE_FAIL is
        # recovered by re-packing, exactly like the reference pushes it
        # back into m_bloom); a missing or incomplete file rolls back to
        # INIT. STATUS_DATABASE_UPLOAD_FAIL is deliberately NOT recovered
        # (the .db left S3-side; manual_db repairs it). This is the ONE
        # place scratch .bloom headers are read: the per-shape group map
        # rebuilds here and is maintained event-driven afterwards.
        self._groups = {}
        self._grouped = set()
        recoverable = (self.status == STATUS_BLOOM_SUCCESS) | (
            self.status == STATUS_DATABASE_FAIL
        )
        for i in np.nonzero(recoverable)[0]:
            path = self.bloom_path(int(i))
            param = None
            try:
                param = read_bloom_file(path, with_bits=False).param
            except (OSError, ValueError, EOFError):
                param = None
            if param is None:
                self.status[i] = STATUS_INIT
            else:
                self.status[i] = STATUS_BLOOM_SUCCESS
                self._grouped.add(int(i))
                self._groups.setdefault(param, []).append(int(i))

    def checkpoint(self, force: bool = False) -> None:
        now = time.time()
        if force or now - self._last_checkpoint >= CHECKPOINT_EVERY_SEC:
            write_status_file(self.opt.status_file, self.status, self.database_index)
            self._last_checkpoint = now

    def display_status(self, force: bool = False) -> None:
        """Periodic status histogram + cumulative throughput, the analog of
        the reference's 15-minute display (maestro_main.cpp:359-374,
        485-616, 961-984)."""
        now = time.time()
        if not force and now - self._last_display < self.opt.status_display_sec:
            return
        self._last_display = now
        elapsed = max(now - self._start_time, 1e-9)
        total = len(self.status)
        self._log(f"[maestro] status after {elapsed:.0f} sec:")
        for name, count in sorted(self.summary().items()):
            self._log(f"[maestro]   {name}: {count} ({100.0 * count / total:.1f}%)")
        if self._total_bp:
            # Deflation = filter bytes per 2 bits of input sequence
            # (maestro_main.cpp:505-510).
            self._log(
                f"[maestro]   throughput {self._total_bp / elapsed / 1.0e6:.2f} Mbp/sec; "
                f"deflation {self._total_filter_bytes / (2.0 * self._total_bp):.4f}"
            )

    # -- work items ------------------------------------------------------

    def _process_accession(
        self, idx: int, phase: str
    ) -> tuple[int, int, BloomParam | None, float]:
        """Worker task: stage the source and build one Bloom filter.

        phase "full": resolve (download allowed) then build — the merged
        analog of SCHEDULE_DOWNLOAD + SCHEDULE_BLOOM back-to-back, since
        the reference always schedules a completed download for Bloom
        creation at a higher priority than new downloads
        (maestro_main.cpp:437-442). phase "bloom": the source is already
        staged (restored STATUS_DOWNLOAD_SUCCESS); local lookup only.
        """
        t0 = time.time()

        def on_downloaded() -> None:
            # The download leg succeeded: persist STATUS_DOWNLOAD_SUCCESS
            # (process_event, maestro_main.cpp:852-877) so a crash during
            # the Bloom leg resumes from the staged file. Do not clobber a
            # BLOOM_FAIL_n attempt count from a prior bloom leg (bounded-
            # retry deviation; see __init__).
            s = int(self.status[idx])
            if not (STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10):
                self.status[idx] = STATUS_DOWNLOAD_SUCCESS

        status, param = execute_bloom_task(
            self.accessions[idx],
            self.infos[idx],
            phase,
            self.resolver,
            self.opt,
            self.bloom_path(idx),
            on_downloaded=on_downloaded,
        )
        return idx, status, param, time.time() - t0

    def _on_downloaded_event(self, idx: int) -> None:
        s = int(self.status[idx])
        if not (STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10):
            self.status[idx] = STATUS_DOWNLOAD_SUCCESS

    def _process_accession_batch(
        self, items: list[tuple[int, str]]
    ) -> list[tuple[int, int, BloomParam | None, float]]:
        """Device-build worker task for a BATCH of accessions: resolve
        each source, then build every Bloom filter in (at most) two
        device dispatches via execute_bloom_batch (non-pipelined path)."""
        return execute_bloom_batch(
            [(idx, self.accessions[idx], self.infos[idx], phase)
             for idx, phase in items],
            self.resolver,
            self.opt,
            lambda idx: self.bloom_path(idx),
            on_downloaded=self._on_downloaded_event,
        )

    def _prepare_batch_host(self, items: list[tuple[int, str]]) -> BloomBatchWork:
        """Host half of the pipelined device build (runs on the parse
        thread while the device executes another batch)."""
        return prepare_bloom_batch(
            [(idx, self.accessions[idx], self.infos[idx], phase)
             for idx, phase in items],
            self.resolver,
            self.opt,
            on_downloaded=self._on_downloaded_event,
        )

    def _build_database(self, db_index: int, param: BloomParam,
                        members: list[int]) -> tuple[list[int], int, str, float]:
        t0 = time.time()
        ext = "dbz" if self.opt.compress_db else "db"
        db_path = os.path.join(self.opt.scratch_database_dir, f"sra.{db_index}.{ext}")
        ok = False
        try:
            blooms = [self.bloom_path(i) for i in members]
            if self.opt.compress_db:
                from ..pipeline.build_db import build_dbz_from_bloom_files

                build_dbz_from_bloom_files(db_path, param, blooms)
            else:
                build_db_from_bloom_files(
                    db_path, param, blooms, device=self.opt.device_transpose
                )
            ok = True
        except (ValueError, OSError):
            pass
        if ok and self.opt.s3_bucket and not self.opt.s3_no_write:
            cmd = ["aws", "s3", "cp" if self.opt.save_db else "mv", db_path,
                   f"{self.opt.s3_bucket}/{os.path.basename(db_path)}"]
            proc = subprocess.run(cmd, capture_output=True)
            if proc.returncode != 0:
                return members, STATUS_DATABASE_UPLOAD_FAIL, db_path, time.time() - t0
        if ok and not self.opt.save_bloom:
            for i in members:
                try:
                    os.unlink(self.bloom_path(i))
                except OSError:
                    pass
        return members, STATUS_DATABASE_SUCCESS if ok else STATUS_DATABASE_FAIL, db_path, time.time() - t0

    # -- scheduling --------------------------------------------------------

    def _compute_end(self) -> int:
        """--halt-after caps the fresh-work cursor at the index of the
        limit'th still-pending accession (maestro_main.cpp:285-317). Hard
        Bloom failures (STATUS_BLOOM_FAIL) are not counted toward the cap,
        mirroring the reference's comment."""
        limit = self.opt.limit_num_download
        if not limit:
            return len(self.status)
        count = 0
        for i, s in enumerate(self.status):
            s = int(s)
            if (
                s == STATUS_INIT
                or STATUS_DOWNLOAD_FAIL_1 <= s <= MAX_NUM_DOWNLOAD_FAIL
                or STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10
            ):
                count += 1
            if count == limit:
                return i + 1
        return len(self.status)

    def _next_fresh(self) -> int | None:
        """Advance the forward-only cursor to the next schedulable
        accession, pre-marking its status byte as a failure so a vanished
        worker's task is retried after a restart (maestro_main.cpp:
        1404-1408 "in case we never get a response"). Streaming mode
        pre-marks BLOOM_FAIL_n and also re-streams restored
        DOWNLOAD_SUCCESS / DOWNLOAD_FAIL_n states
        (maestro_main.cpp:1386-1624); download mode pre-marks
        DOWNLOAD_FAIL_n and re-downloads restored BLOOM_FAIL* states from
        a streaming run (:1655-1801)."""
        retry = self.opt.num_download_attempt
        while self._cursor < self._end:
            i = self._cursor
            s = int(self.status[i])
            if self.opt.stream_sra:
                if (
                    s in (STATUS_INIT, STATUS_DOWNLOAD_SUCCESS)
                    or STATUS_DOWNLOAD_FAIL_1 <= s <= MAX_NUM_DOWNLOAD_FAIL
                ):
                    self.status[i] = STATUS_BLOOM_FAIL_1
                    self._cursor += 1
                    return i
                if STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10:
                    if retry > s - STATUS_BLOOM_FAIL_1 + 1:
                        self.status[i] = s + 1
                        self._cursor += 1
                        return i
            else:
                if s in (STATUS_INIT, STATUS_BLOOM_FAIL) or (
                    STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10
                ):
                    self.status[i] = STATUS_DOWNLOAD_FAIL_1
                    self._cursor += 1
                    return i
                if STATUS_DOWNLOAD_FAIL_1 <= s <= MAX_NUM_DOWNLOAD_FAIL:
                    if retry > s - STATUS_DOWNLOAD_FAIL_1 + 1:
                        self.status[i] = s + 1
                        self._cursor += 1
                        return i
            self._cursor += 1
        return None

    def _on_download_fail(self, idx: int) -> bool:
        """process_event STATUS_DOWNLOAD_FAIL (maestro_main.cpp:879-930):
        increment the failure counter stored in the status byte; finalize
        past the retry budget, else requeue. Returns True when final."""
        s = int(self.status[idx])
        s = STATUS_DOWNLOAD_FAIL_1 if s == STATUS_INIT else s + 1
        if s > STATUS_DOWNLOAD_FAIL + self.opt.num_download_attempt:
            self.status[idx] = STATUS_DOWNLOAD_FAIL
            return True
        self.status[idx] = s
        self._retry.append(idx)
        return False

    def _on_bloom_fail(self, idx: int) -> bool:
        """process_event STATUS_BLOOM_FAIL (maestro_main.cpp:988-1040)."""
        s = int(self.status[idx])
        if s in (STATUS_INIT, STATUS_DOWNLOAD_SUCCESS):
            s = STATUS_BLOOM_FAIL_1
        else:
            s += 1
        if s + 1 > STATUS_BLOOM_FAIL_1 + self.opt.num_download_attempt:
            self.status[idx] = STATUS_BLOOM_FAIL
            return True
        self.status[idx] = s
        self._retry.append(idx)
        return False

    def _next_work_item(self, block_delay: bool = True) -> tuple[int, str] | str | None:
        """Pop the next dispatchable accession: restored downloads first
        (bloom phase), then the retry deque (no pre-mark,
        maestro_main.cpp:1640-1647), then fresh work off the cursor.

        With ``block_delay=False`` (the coordinator path, which holds the
        scheduling lock) an unelapsed --delay returns the string "delay"
        instead of sleeping, so completion RPCs are never blocked behind
        the throttle."""
        if self._download_ready:
            return self._download_ready.popleft(), "bloom"
        if self.opt.download_delay > 0:
            wait_for = self._last_download + self.opt.download_delay - time.time()
            if wait_for > 0:
                if not block_delay:
                    return "delay"
                time.sleep(wait_for)
        if self._retry:
            idx = self._retry.popleft()
        else:
            nxt = self._next_fresh()
            if nxt is None:
                return None
            idx = nxt
        self._last_download = time.time()
        return idx, "full"

    def _absorb_bloom_event(self, idx: int, status: int, param, dt: float) -> None:
        """Apply one bloom/download completion to the state machine."""
        opt = self.opt
        if status != STATUS_BLOOM_SUCCESS and (
            idx in self._grouped
            or int(self.status[idx]) in (STATUS_BLOOM_SUCCESS,
                                         STATUS_DATABASE_SUCCESS)
        ):
            # Stale FAILURE after an absorbed success (--task-timeout
            # re-dispatch raced a slow-but-alive worker, or a buffered
            # remote event arrived late): the completed filter stands --
            # overwriting would mark a built accession terminal-failed
            # and drop it from the corpus on the next checkpoint.
            return
        if status == STATUS_BLOOM_SUCCESS:
            if int(self.status[idx]) == STATUS_BLOOM_SUCCESS or idx in self._grouped:
                # Duplicate completion (e.g. --task-timeout re-dispatched a
                # slow-but-alive worker's task and BOTH finished, each with
                # a distinct eid). The group map is event-driven state, not
                # a per-round rescan -- a second append would pack the same
                # filter twice. The first completion stands.
                return
            self.status[idx] = STATUS_BLOOM_SUCCESS
            self._grouped.add(idx)
            self._groups.setdefault(param, []).append(idx)
            bp = self.infos[idx].number_of_bases or 0
            self._total_bp += bp
            self._total_filter_bytes += param.filter_len // 8
            self._log(
                f"[maestro] bloom {self.accessions[idx]} ok "
                f"(L={param.log_2_filter_len}, h={param.num_hash}) "
                f"in {dt:.2f}s ({bp / max(dt, 1e-9) / 1.0e6:.2f} Mbp/sec; "
                f"mem {100.0 * memory_usage():.1f}%)"
            )
        elif status == STATUS_BLOOM_INVALID:
            self.status[idx] = STATUS_BLOOM_INVALID
            self._log(f"[maestro] bloom {self.accessions[idx]} invalid")
        elif status == STATUS_DOWNLOAD_FAIL and not opt.stream_sra:
            final = self._on_download_fail(idx)
            self._log(
                f"[maestro] download {self.accessions[idx]} failed "
                f"({'final' if final else STATUS_NAMES[int(self.status[idx])]})"
            )
        else:
            # Streaming-mode failures are all bloom-classed (the reference
            # streaming worker replies STATUS_BLOOM_FAIL for download
            # errors too).
            final = self._on_bloom_fail(idx)
            self._log(
                f"[maestro] bloom {self.accessions[idx]} failed "
                f"({'final' if final else STATUS_NAMES[int(self.status[idx])]})"
            )

    def _take_ready_groups(self) -> list[tuple[BloomParam, list[int]]]:
        """Pop BloomParam groups at (or past) quota from the event-driven
        group map -- O(groups) per round with ZERO file opens (the
        reference's in-memory bookkeeping, maestro_main.cpp:87-106;
        headers are read only by restore()). Once the forced flush
        triggers, quotas drop to zero permanently and every nonempty
        group packs (maestro_main.cpp:410-415). Returned members are
        removed from the map: the caller owns their dispatch."""
        out = []
        for param in sorted(self._groups):
            members = self._groups[param]
            quota = filters_per_file_quota(param.log_2_filter_len)
            members.sort()
            while len(members) >= quota:
                out.append((param, members[:quota]))
                del members[:quota]
            if members and self._forced_flush:
                out.append((param, list(members)))
                members.clear()
            if not members:
                del self._groups[param]
        return out

    def run(self) -> None:
        """The event loop: dispatch work, absorb completions, checkpoint."""
        from ..utils import device_trace

        with device_trace():
            self._run()

    def _run(self) -> None:
        opt = self.opt
        self._end = self._compute_end()
        self.checkpoint(force=True)
        futures: dict[Future, str] = {}
        in_flight_db: set[int] = set()
        pending_db: deque[tuple[BloomParam, list[int]]] = deque()

        # Pipelined device-build mode: ONE parse thread feeds host-packed
        # batches to ONE device dispatcher with a two-deep dispatch-ahead
        # window (more full workers contend on the one device, and a pool
        # cannot overlap a batch's upload with another's readback from
        # the same thread). Three batches in flight total.
        pipelined = opt.device_build and opt.device_batch > 1
        parse_pool = ThreadPoolExecutor(max_workers=1) if pipelined else None
        dispatcher = _DeviceDispatcher(self) if pipelined else None
        bloom_cap = 3 if pipelined else opt.num_workers

        def _submit_pipelined(items: list[tuple[int, str]]) -> Future:
            final: Future = Future()

            def _chain(pf: Future, final: Future = final) -> None:
                e = pf.exception()
                if e is not None:
                    final.set_exception(e)
                    return
                dfut = dispatcher.submit(pf.result())

                def _copy(d: Future, final: Future = final) -> None:
                    de = d.exception()
                    if de is not None:
                        final.set_exception(de)
                    else:
                        final.set_result(d.result())

                dfut.add_done_callback(_copy)

            parse_pool.submit(self._prepare_batch_host, items).add_done_callback(_chain)
            return final

        with ThreadPoolExecutor(max_workers=opt.num_workers) as pool:
            while True:
                # Forced flush: no fresh work left, nothing staged, all
                # workers idle -> zero the per-shape quotas permanently
                # (maestro_main.cpp:410-415; retries still pending do not
                # block the flush, matching the reference).
                if self._cursor >= self._end and not self._download_ready and not futures:
                    self._forced_flush = True

                # Priority 1: database packing. Ready groups pop off the
                # event-driven map, so a group can never be re-discovered
                # while its build is in flight. Builds are SERIALIZED (one
                # at a time): a full group loads up to the per-file filter
                # quota into RAM, and unlike the reference's MPI ranks
                # (separate hosts) concurrent packs here share one
                # address space. Un-dispatched groups wait in pending_db
                # with their BLOOM_SUCCESS bytes intact, so a crash
                # re-groups them in restore().
                pending_db.extend(self._take_ready_groups())
                if pending_db and not in_flight_db:
                    param, members = pending_db.popleft()
                    db_index = self.database_index
                    self.database_index += self.opt.num_slice
                    self._log(
                        f"[maestro] building database {db_index} "
                        f"(L={param.log_2_filter_len}, h={param.num_hash}, "
                        f"{len(members)} filters)"
                    )
                    fut = pool.submit(self._build_database, db_index, param, list(members))
                    futures[fut] = "db"
                    in_flight_db.update(members)
                    # Pre-mark as failed so a crash retries on restart
                    # (maestro_main.cpp:1404-1408).
                    for i in members:
                        self.status[i] = STATUS_DATABASE_FAIL

                # Priority 2: Bloom creation from restored downloads;
                # priority 3: retries, then fresh work off the cursor
                # (download+bloom merged in one task). Device builds fuse
                # up to --device-batch accessions into one batch, fed
                # through the parse->dispatch pipeline.
                batch_n = opt.device_batch if opt.device_build else 1
                n_bloom = sum(1 for v in futures.values() if v != "db")
                while n_bloom < bloom_cap:
                    item = self._next_work_item()
                    if item is None:
                        break
                    if batch_n > 1:
                        items = [item]
                        while len(items) < batch_n:
                            nxt = self._next_work_item()
                            if nxt is None:
                                break
                            items.append(nxt)
                        if pipelined:
                            fut = _submit_pipelined(items)
                        else:
                            fut = pool.submit(self._process_accession_batch, items)
                        futures[fut] = "bloom_batch"
                    else:
                        fut = pool.submit(self._process_accession, *item)
                        futures[fut] = "bloom"
                    n_bloom += 1

                if not futures:
                    # Completion condition (maestro_main.cpp:341-346):
                    # fresh cursor exhausted, nothing staged, no retries,
                    # no Bloom filters awaiting database packing, all
                    # workers idle. Pending blooms loop once more so the
                    # forced flush pops their (now quota-free) groups.
                    if not (
                        self._cursor < self._end
                        or self._download_ready
                        or self._retry
                        or bool((self.status == STATUS_BLOOM_SUCCESS).any())
                    ):
                        break
                    continue

                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    kind = futures.pop(fut)
                    if kind == "bloom":
                        self._absorb_bloom_event(*fut.result())
                    elif kind == "bloom_batch":
                        for item in fut.result():
                            self._absorb_bloom_event(*item)
                    else:
                        members, status, db_path, dt = fut.result()
                        in_flight_db.difference_update(members)
                        for i in members:
                            self.status[i] = status
                        self._log(
                            f"[maestro] database {os.path.basename(db_path)} "
                            f"{STATUS_NAMES.get(status, status)} "
                            f"({len(members)} filters) in {dt:.2f}s "
                            f"(mem {100.0 * memory_usage():.1f}%)"
                        )
                        if status == STATUS_DATABASE_SUCCESS:
                            self.checkpoint(force=True)

                self.checkpoint()
                self.display_status()

        if pipelined:
            dispatcher.stop()
            parse_pool.shutdown()
        self.checkpoint(force=True)
        self.display_status(force=True)

    def summary(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.status:
            name = STATUS_NAMES.get(int(s), f"state {int(s)}")
            out[name] = out.get(name, 0) + 1
        return out
