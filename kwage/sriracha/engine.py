"""SriRachA-style per-read k-mer confirmation search (host engine).

Per read (SriRachA/search_by_kmer.cpp:14-135): extract canonical k-mers,
apply the minimum-length / minimum-k-mer / complexity gates, intersect the
read's unique k-mer set with each query ("subject") k-mer set via binary
search, score = |intersection| / |unique read k-mers| (float32), and keep
matches with score >= threshold, culled to the top max_num_match by
(score desc, read_index asc, subindex asc).

Read sources here are local FASTA/FASTQ files (the reference's local-file
path, sra_stream.cpp:585-719: 1-based read indices, 1-based fragment
subindices). Range sharding follows assign_read_range
(sra_stream.cpp:525-543) for both --slice/--of and multi-worker splits;
the device data-parallel batch path lives in kwage.sriracha.device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np

from ..core.words import canonical_kmers
from ..io.sequence import iter_sequences
from ..native import (
    NativeReadSearcher,
    available as native_available,
    read_profile_native,
    sorted_intersect_count_native,
)

# Verbosity levels (sriracha.h:24-30)
SILENT, TACITERN, NORMAL, CHATTY = 0, 1, 2, 3

MIN_KMER_LEN = 3
MAX_KMER_LEN = 32
DEFAULT_KMER_LENGTH = 11
DEFAULT_KMER_MATCH_THRESHOLD = 0.8
DEFAULT_MIN_READ_COMPLEXITY = 0.75
DEFAULT_MIN_VALID_KMER = 1
DEFAULT_MIN_READ_LENGTH = 0
DEFAULT_MAX_MATCH = 100


@dataclass
class SrirachaOptions:
    input_sequence_files: list[str] = field(default_factory=list)
    output_filename: str = ""
    sra_accession: list[str] = field(default_factory=list)
    sra_accession_filename: str = ""
    kmer_len: int = DEFAULT_KMER_LENGTH
    kmer_match_threshold: float = DEFAULT_KMER_MATCH_THRESHOLD
    min_read_complexity: float = DEFAULT_MIN_READ_COMPLEXITY
    min_read_length: int = DEFAULT_MIN_READ_LENGTH
    min_valid_kmer: int = DEFAULT_MIN_VALID_KMER
    max_num_match: int = DEFAULT_MAX_MATCH
    max_retry: int = 0
    slice_index: int = 0
    num_slice: int = 1
    verbose: int = SILENT
    use_device: bool = False
    # Host-path search threads over sub-ranges of this rank's reads --
    # the analog of the reference's OpenMP split of the local-file range
    # (sra_stream.cpp:632-699; 5 reader threads measured optimal there).
    num_threads: int = 1


@dataclass
class SearchMatch:
    read_index: int
    read_subindex: int
    score: float
    read_seq: str

    def sort_key(self):
        return (-self.score, self.read_index, self.read_subindex)


@dataclass
class StreamStats:
    num_reads: int = 0
    num_bases: int = 0


def extract_sra_accession(path: str) -> str:
    """Leaf path component up to the first punctuation (main.cpp:584-612)."""
    end = len(path)
    while end > 0 and path[end - 1] == os.sep:
        end -= 1
    if end == 0:
        raise ValueError("unable to parse accession")
    begin = end
    while begin > 0 and path[begin - 1] != os.sep:
        begin -= 1
    stop = begin + 1
    import string as _string

    while stop < end and path[stop] not in _string.punctuation:
        stop += 1
    return path[begin:stop]


def assign_read_range(first_read: int, num_read: int, rank: int, ntasks: int) -> tuple[int, int]:
    """Contiguous per-rank read slice [start, stop) (sra_stream.cpp:525-543)."""
    chunk = (num_read - first_read + 1) // ntasks
    start = first_read + chunk * rank
    if rank == ntasks - 1:
        chunk += (num_read - first_read + 1) % ntasks
    return start, start + chunk


def load_subject_kmers(files: Iterable[str], k: int, verbose: int = SILENT):
    """Per-query (defline, sorted unique canonical k-mers) list (main.cpp:121-170)."""
    import sys

    out: list[tuple[str, np.ndarray]] = []
    for path in files:
        if verbose >= NORMAL:
            print(f"Reading sequences from {path}", file=sys.stderr)
        for defline, seq in iter_sequences(path):
            kmers = np.unique(canonical_kmers(seq, k))
            if verbose >= CHATTY:
                print(f"\t{defline} has {kmers.size} unique kmers", file=sys.stderr)
            if kmers.size == 0:
                if verbose >= TACITERN:
                    print(f"Did not extract any kmers from: {defline}", file=sys.stderr)
                continue
            out.append((defline, kmers))
    return out


def search_one_read(
    seq: str,
    read_index: int,
    read_subindex: int,
    subject_kmers: list[tuple[str, np.ndarray]],
    results: list[list[SearchMatch]],
    num_perfect: list[int],
    opt: SrirachaOptions,
) -> None:
    """The per-read kernel (search_by_kmer.cpp:14-135)."""
    if len(seq) < opt.min_read_length:
        return
    # Native fast path: extraction + dedup + lower_bound intersection in C
    # (25x the numpy formulation per read); all float32 scoring stays here
    # so both paths produce identical scores and culling.
    profile = read_profile_native(seq, opt.kmer_len)
    if profile is not None:
        num_kmer, uniq = profile
    else:
        kmers = canonical_kmers(seq, opt.kmer_len)
        num_kmer = kmers.size
        uniq = np.unique(kmers) if num_kmer else kmers
    if num_kmer < opt.min_valid_kmer:
        return
    num_unique = uniq.size
    if np.float32(num_unique) / np.float32(num_kmer) < np.float32(opt.min_read_complexity):
        return

    for index, (_, subject) in enumerate(subject_kmers):
        if num_perfect[index] >= opt.max_num_match:
            continue
        count = sorted_intersect_count_native(uniq, subject)
        if count is None:
            pos = np.searchsorted(subject, uniq)
            pos = np.minimum(pos, subject.size - 1)
            count = int((subject[pos] == uniq).sum())
        score = np.float32(count) / np.float32(num_unique)
        if score >= np.float32(opt.kmer_match_threshold):
            bucket = results[index]
            bucket.append(SearchMatch(read_index, read_subindex, float(score), seq))
            if score == 1.0:
                num_perfect[index] += 1
            if opt.max_num_match > 0 and len(bucket) > 10 * opt.max_num_match:
                bucket.sort(key=SearchMatch.sort_key)
                del bucket[opt.max_num_match :]


def count_reads(path: str) -> int:
    """Record count of a local sequence file (the VCursorIdRange analog
    for the local-file path). One streaming parse, O(1) memory (native
    parser when available; record segmentation is equivalence-tested)."""
    from ..io.sequence import UNKNOWN_SEQUENCE, get_file_type
    from ..native import scan_file_native

    ftype = get_file_type(path)
    if ftype != UNKNOWN_SEQUENCE:
        spots, _bp = scan_file_native(path, ftype)
        return spots
    return sum(1 for _ in iter_sequences(path))


def _search_file_range_native(
    path: str,
    lo: int,
    hi: int,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: "StreamStats | None",
) -> list[list["SearchMatch"]] | None:
    """Native whole-file scan of read range [lo, hi): parsing + per-read
    kernel in C, Python only per match. Returns None when unavailable
    (library absent / unknown extension) -- callers fall back to the
    iterator + search_reads twin, which produces identical output."""
    from ..io.sequence import UNKNOWN_SEQUENCE, get_file_type

    if not subject_kmers or not native_available():
        return None
    ftype = get_file_type(path)
    if ftype == UNKNOWN_SEQUENCE:
        return None
    searcher = NativeReadSearcher([s for _, s in subject_kmers])
    results: list[list[SearchMatch]] = [[] for _ in subject_kmers]
    num_perfect = [0] * len(subject_kmers)
    for i in range(len(subject_kmers)):
        if num_perfect[i] >= opt.max_num_match:
            searcher.active[i] = 0

    def on_match(s: int, ridx: int, score: float, seq: bytes) -> None:
        bucket = results[s]
        # The reference upper-cases every base on parse
        # (parse_sequence.cpp:134-135); the native parser preserves file
        # bytes, so normalize the echoed read here (scoring is
        # case-insensitive either way).
        bucket.append(SearchMatch(ridx, 1, score, seq.decode("ascii").upper()))
        if score == 1.0:
            num_perfect[s] += 1
            if num_perfect[s] >= opt.max_num_match:
                searcher.active[s] = 0
        if opt.max_num_match > 0 and len(bucket) > 10 * opt.max_num_match:
            bucket.sort(key=SearchMatch.sort_key)
            del bucket[opt.max_num_match :]

    try:
        reads, bases = searcher.search_file(
            path, ftype, lo, hi, opt.kmer_len, opt.min_read_length,
            opt.min_valid_kmer, opt.min_read_complexity,
            opt.kmer_match_threshold, on_match)
    except MemoryError:
        return None  # native scratch OOM: iterator twin streams instead
    if stats is not None:
        stats.num_reads += reads
        stats.num_bases += bases
    for bucket in results:
        bucket.sort(key=SearchMatch.sort_key)
        if opt.max_num_match > 0 and len(bucket) > opt.max_num_match:
            del bucket[opt.max_num_match :]
    return results


def iter_reads_range(path: str, rank: int, ntasks: int, num_read: int | None = None):
    """Yield (seq, read_index, subindex) for this rank's contiguous range.

    Local files use 1-based read indices and 1-based fragment subindices
    (sra_stream.cpp:620-643); FASTA/FASTQ records are single-fragment.
    Streams the file twice (count, then the range) instead of
    materializing it -- host RAM stays O(1) in the accession size, the
    reference's read-range streaming shape (sra_stream.cpp:525-543).
    """
    if ntasks == 1:
        # Unsliced: the range is the whole file -- one pass, no count.
        for i, (_, seq) in enumerate(iter_sequences(path), 1):
            yield seq, i, 1
        return
    if num_read is None:
        num_read = count_reads(path)
    if num_read == 0:
        return
    start, stop = assign_read_range(1, num_read, rank, ntasks)
    for i, (_, seq) in enumerate(iter_sequences(path), 1):
        if i >= stop:
            break
        if i >= start:
            yield seq, i, 1


def _spot_key(header: str) -> str:
    """First header token -- ``<accession>.<spot>`` for toolkit output;
    consecutive records sharing it are mate fragments of one spot (the
    same synthesis stream_accession's pipe path uses)."""
    return header.split(None, 1)[0] if header else ""


def count_spots(path: str) -> int:
    """Spot count of a --split-spot toolkit file (consecutive same-key
    records collapse into one spot). One streaming parse, O(1) memory."""
    prev: str | None = None
    n = 0
    for header, _ in iter_sequences(path):
        key = _spot_key(header)
        if not key or key != prev:
            n += 1
        prev = key or None
    return n


def iter_toolkit_fragments_range(path: str, rank: int, ntasks: int):
    """Yield (seq, spot_index, subindex) for this rank's spot range from
    a toolkit-materialized (--split-spot) FASTQ/FASTA.

    Unlike iter_reads_range (genuinely local files: one fragment per
    record, sra_stream.cpp:620-643), this groups consecutive records
    sharing a header spot key into (1-based spot, 1-based fragment)
    numbering and partitions SPOTS across slices -- the same numbering
    and sharding the streamed VDB/pipe path produces
    (sra_stream.cpp:221-413, 336-356), so TSV ``idx.sub`` rows do not
    depend on whether the accession was streamed or materialized.
    """
    num_spot = count_spots(path)
    if num_spot == 0:
        return
    start, stop = assign_read_range(1, num_spot, rank, ntasks)
    prev: str | None = None
    ordinal = 0  # positional spot count: partitions the slice ranges
    spot = 0     # REPORTED index: the toolkit's row id from the header
    sub = 0
    for header, seq in iter_sequences(path):
        key = _spot_key(header)
        if not key or key != prev:
            ordinal += 1
            # Number spots from the header's trailing row id exactly like
            # the streamed pipe path (stream_accession), so idx.sub rows
            # do not depend on whether the accession was materialized.
            # Toolkit ids are consecutive, so ordinal == id in practice;
            # the positional ordinal still drives slice partitioning.
            tail = key.rsplit(".", 1)[-1] if key else ""
            spot = int(tail) if tail.isdigit() else spot + 1
            sub = 1
        else:
            sub += 1
        prev = key or None
        if ordinal >= stop:
            break
        if ordinal >= start:
            yield seq, spot, sub


def _search_one_read_native(
    searcher: NativeReadSearcher,
    seq: str,
    read_index: int,
    read_subindex: int,
    results: list[list["SearchMatch"]],
    num_perfect: list[int],
    opt: SrirachaOptions,
) -> None:
    """Native-call twin of search_one_read (identical output)."""
    if len(seq) < opt.min_read_length:
        return
    out = searcher.search(seq, opt.kmer_len, opt.min_valid_kmer,
                          opt.min_read_complexity, opt.kmer_match_threshold)
    if out is None:
        return
    _num_kmer, num_unique, matched, counts = out
    for index in matched:
        index = int(index)
        score = np.float32(counts[index]) / np.float32(num_unique)
        bucket = results[index]
        bucket.append(SearchMatch(read_index, read_subindex, float(score), seq))
        if score == 1.0:
            num_perfect[index] += 1
            if num_perfect[index] >= opt.max_num_match:
                searcher.active[index] = 0
        if opt.max_num_match > 0 and len(bucket) > 10 * opt.max_num_match:
            bucket.sort(key=SearchMatch.sort_key)
            del bucket[opt.max_num_match :]


def search_reads(
    read_iter,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: StreamStats | None = None,
) -> list[list[SearchMatch]]:
    """Run the per-read kernel over a read stream; returns per-subject
    matches sorted + culled (main.cpp:452-459)."""
    results: list[list[SearchMatch]] = [[] for _ in subject_kmers]
    num_perfect = [0] * len(subject_kmers)
    searcher = None
    if subject_kmers and native_available():
        # One native call per read: profile + gates + every subject's
        # lower_bound intersection + f32 score threshold (C float ==
        # np.float32, so scores and culling are identical to the twin).
        searcher = NativeReadSearcher([s for _, s in subject_kmers])
        for i in range(len(subject_kmers)):
            if num_perfect[i] >= opt.max_num_match:
                searcher.active[i] = 0
    for seq, ridx, sidx in read_iter:
        if stats is not None:
            stats.num_reads += 1
            stats.num_bases += len(seq)
        if searcher is not None:
            _search_one_read_native(
                searcher, seq, ridx, sidx, results, num_perfect, opt)
        else:
            search_one_read(
                seq, ridx, sidx, subject_kmers, results, num_perfect, opt)

    for bucket in results:
        bucket.sort(key=SearchMatch.sort_key)
        if opt.max_num_match > 0 and len(bucket) > opt.max_num_match:
            del bucket[opt.max_num_match :]
    return results


def merge_worker_results(
    all_results: list[list[list[SearchMatch]]], opt: SrirachaOptions
) -> list[list[SearchMatch]]:
    """Rank-0 merge + re-sort + re-cull (main.cpp:462-531)."""
    if not all_results:
        return []
    merged = [list(b) for b in all_results[0]]
    for worker in all_results[1:]:
        for i, bucket in enumerate(worker):
            merged[i].extend(bucket)
    for bucket in merged:
        bucket.sort(key=SearchMatch.sort_key)
        if opt.max_num_match > 0 and len(bucket) > opt.max_num_match:
            del bucket[opt.max_num_match :]
    return merged


def format_results(
    accession_path: str,
    subject_kmers: list[tuple[str, np.ndarray]],
    results: list[list[SearchMatch]],
) -> str:
    """TSV rendering (main.cpp:553-578): accession, read[.sub], score, seq, defline."""
    accession = extract_sra_accession(accession_path)
    out = []
    for i, (defline, _) in enumerate(subject_kmers):
        for m in results[i]:
            idx = str(m.read_index)
            if m.read_subindex > 0:
                idx += f".{m.read_subindex}"
            out.append(f"{accession}\t{idx}\t{m.score:g}\t{m.read_seq}\t{defline}\n")
    return "".join(out)


def search_accession(
    accession_path: str,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: StreamStats | None = None,
) -> list[list[SearchMatch]]:
    """Search one accession (a local FASTA/FASTQ file or directory).

    With --of N / --slice i, only that shard of the read range is scanned;
    otherwise the full range is processed (single worker).
    """
    path = accession_path
    if os.path.isdir(path):
        # directory containing <leaf>.fasta/.fastq etc (reference expects
        # <leaf>.sra; for the file-based engine pick the first sequence file)
        for name in sorted(os.listdir(path)):
            from ..io.sequence import SEQUENCE_EXTS

            if name.endswith(SEQUENCE_EXTS):
                path = os.path.join(path, name)
                break

    if opt.use_device:
        from .device import search_reads_device

        return search_reads_device(
            iter_reads_range(path, opt.slice_index, opt.num_slice),
            subject_kmers, opt, stats,
        )
    if opt.num_threads > 1:
        # Split this rank's range across threads, thread-local results,
        # rank-0-style merge + re-cull -- the reference's OpenMP local-file
        # split (sra_stream.cpp:634-699; worker merge main.cpp:462-531).
        # Each thread streams its own sub-range off a fresh parse (T
        # passes over the file, O(1) RAM), like the reference's per-thread
        # read ranges.
        from concurrent.futures import ThreadPoolExecutor

        num_read = count_reads(path)
        if num_read == 0:
            return [[] for _ in subject_kmers]
        rank_start, rank_stop = assign_read_range(
            1, num_read, opt.slice_index, opt.num_slice
        )
        n_local = rank_stop - rank_start
        if n_local <= 0:
            return [[] for _ in subject_kmers]
        nt = min(opt.num_threads, n_local)
        # assign_read_range spans the INCLUSIVE id range [first, last].
        spans = [assign_read_range(0, n_local - 1, t, nt) for t in range(nt)]
        per_stats = [StreamStats() for _ in range(nt)]

        def _thread_search(t: int):
            lo = rank_start + spans[t][0]
            hi = rank_start + spans[t][1]
            # Native whole-file scan (parse + kernel in C, GIL released:
            # threads genuinely parallel, like the reference's reader
            # threads); iterator twin as fallback.
            res = _search_file_range_native(
                path, lo, hi, subject_kmers, opt, per_stats[t])
            if res is not None:
                return res

            def _range():
                for i, (_, seq) in enumerate(iter_sequences(path), 1):
                    if i >= hi:
                        break
                    if i >= lo:
                        yield seq, i, 1

            return search_reads(_range(), subject_kmers, opt, per_stats[t])

        with ThreadPoolExecutor(max_workers=nt) as pool:
            parts = list(pool.map(_thread_search, range(nt)))
        if stats is not None:
            for s in per_stats:
                stats.num_reads += s.num_reads
                stats.num_bases += s.num_bases
        return merge_worker_results(parts, opt)
    num_read = None
    if subject_kmers and native_available():
        if opt.num_slice == 1:
            # Unsliced: the whole file is the range -- no counting pass
            # (the native scan stops at EOF on its own).
            start, stop = 1, 1 << 62
        else:
            num_read = count_reads(path)
            if num_read == 0:
                return [[] for _ in subject_kmers]
            start, stop = assign_read_range(
                1, num_read, opt.slice_index, opt.num_slice)
        res = _search_file_range_native(
            path, start, stop, subject_kmers, opt, stats)
        if res is not None:
            return res
    return search_reads(
        iter_reads_range(path, opt.slice_index, opt.num_slice, num_read),
        subject_kmers, opt, stats,
    )


def merge_slice_tsvs(
    slice_texts: "list[str]",
    subject_deflines: "list[str]",
    accessions: "list[str]",
    max_num_match: int,
) -> str:
    """Rank-0 cross-slice merge of independently written --slice/--of
    TSVs (the MPI gather + re-cull of SriRachA/main.cpp:462-578).

    The reference's rank 0 concatenates every rank's per-subject match
    deques, re-sorts by the SearchMatch ordering (score descending, then
    read index, then subindex) and re-culls to max_num_match before
    anything is written; all ranks agree on per-accession failure via
    MPI_Allreduce(MAX) -- any failed rank turns the whole accession into
    one ``NA`` line -- and the final ``//`` terminator is written only
    when no accession failed anywhere. Here each slice's TSV plays the
    role of the packed result buffer: a slice ending in ``//`` vouches
    that it saw no failures, so the merged output ends in ``//`` iff
    every slice did.

    ``subject_deflines`` (the -i query deflines, in load order) and
    ``accessions`` (the CLI accession order) reconstruct rank 0's output
    ordering, which the slice files alone cannot fix (an accession or
    query absent from a slice leaves no ordering trace).

    Transport note: scores ride the TSV as %g text (6 significant
    digits) and are compared as float32 after re-parsing; two *distinct*
    scores that render identically would tie here and fall back to the
    read-index order. Score steps are 1/num_query_kmers, so this needs
    queries with >~10^5 k-mers to even be possible.
    """
    if len(set(subject_deflines)) != len(subject_deflines):
        raise ValueError(
            "duplicate query deflines: cross-slice merge cannot attribute "
            "TSV rows to a unique query"
        )
    order = {d: i for i, d in enumerate(subject_deflines)}

    rows: dict[str, dict[str, list]] = {}   # acc -> defline -> [row...]
    failures: dict[str, str] = {}           # acc -> failure line
    seen_rows: dict = {}    # (acc, defline, ridx, rsub) -> (slice#, line)
    all_terminated = bool(slice_texts)
    for slice_no, text in enumerate(slice_texts):
        lines = text.splitlines()
        if lines and lines[-1] == "//":
            lines.pop()
        else:
            all_terminated = False
        for line in lines:
            parts = line.split("\t", 4)
            if len(parts) == 4 and parts[1] == "NA":
                # Per-accession failure line "<acc>\tNA\t0\t<error>"
                # (main.cpp:538-543): any slice's failure wins for the
                # whole accession.
                failures.setdefault(parts[0], line)
                continue
            if len(parts) != 5:
                raise ValueError(f"malformed slice TSV row: {line!r}")
            acc, idx, score_text, seq, defline = parts
            if defline not in order:
                raise ValueError(f"TSV row for unknown query: {defline!r}")
            if "." in idx:
                ridx, rsub = (int(x) for x in idx.split(".", 1))
            else:
                ridx, rsub = int(idx), 0
            key = (acc, defline, ridx, rsub)
            if key in seen_rows:
                # Disjoint --slice/--of shards never share a (read,
                # query) pair ACROSS slice files: a cross-file repeat
                # means the same slice TSV (or slices from inconsistent
                # --of values) was fed twice. A byte-identical repeat
                # WITHIN one slice TSV is legitimate -- the sliced run's
                # accession argument list may repeat an accession,
                # duplicating its rows inside that slice's output (the
                # output loop below dedupes accession args the same
                # way) -- and is idempotent: keep one.
                prev_slice, prev_line = seen_rows[key]
                if prev_slice == slice_no and prev_line == line:
                    continue
                raise ValueError(
                    f"duplicate slice TSV row for {acc} read {idx} "
                    f"{defline!r}: overlapping or repeated slice inputs"
                )
            seen_rows[key] = (slice_no, line)
            rows.setdefault(acc, {}).setdefault(defline, []).append(
                (float(np.float32(score_text)), ridx, rsub, line)
            )

    out: list[str] = []
    seen: set[str] = set()
    for acc_arg in accessions:
        acc = extract_sra_accession(acc_arg)
        if acc in seen:
            continue
        seen.add(acc)
        if acc in failures:
            out.append(failures[acc] + "\n")
            continue
        per_subject = rows.get(acc, {})
        for defline in sorted(per_subject, key=order.__getitem__):
            bucket = per_subject[defline]
            bucket.sort(key=lambda r: (-r[0], r[1], r[2]))
            if max_num_match > 0 and len(bucket) > max_num_match:
                del bucket[max_num_match:]
            out.extend(r[3] + "\n" for r in bucket)
    leftover = set(rows) - seen | set(failures) - seen
    if leftover:
        raise ValueError(
            f"slice TSV rows for accessions not in the merge argument "
            f"list: {sorted(leftover)}"
        )
    if all_terminated and not failures:
        out.append("//\n")
    return "".join(out)
