"""Native host library loader (ctypes) with a pure-Python fallback.

The C++ library implements the ingest hot path (the reference's worker-side
count_words loop, make_bloom.cpp:506-621): canonical k-mer extraction,
multi-seed murmur3-32, and counting-Bloom thresholding. It is compiled
from kwage_native.cpp alone, on first use, with the local toolchain and
``-march=native``, into ``build/`` beside the source (ignored by git). The
cached file's name carries both the source's hash and the machine's: a
checkout copied to another host never loads a library built for an
instruction set that host may lack.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

# Per-(subject, read) match callback of kn_sriracha_file:
# (ctx, subject_index, read_index, f32 score, seq_ptr, seq_len).
_MATCH_CB_T = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_float,
    ctypes.POINTER(ctypes.c_char), ctypes.c_uint64)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kwage_native.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")
_CFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Exception | None = None


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _machine_tag() -> str:
    """What ``-march=native`` means on this host: the compiler's
    predefined macros under it (one per instruction-set extension it
    enables), plus the architecture name."""
    macros = subprocess.run(
        ["g++", "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        check=True, capture_output=True,
    ).stdout
    digest = hashlib.sha256(macros).hexdigest()[:12]
    return f"{platform.machine()}-{digest}"


def _build() -> str:
    so_path = os.path.join(
        _BUILD_DIR, f"libkwage_native_{_source_tag()}_{_machine_tag()}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_CFLAGS, "-o", tmp, _SRC, "-lz"],
                   check=True, capture_output=True)
    os.replace(tmp, so_path)  # atomic: concurrent builds race harmlessly
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.kn_new.restype = ctypes.c_void_p
    lib.kn_new.argtypes = [u32, u32, u32, u32]
    lib.kn_free.argtypes = [ctypes.c_void_p]
    lib.kn_num_valid_kmer.restype = u64
    lib.kn_num_valid_kmer.argtypes = [ctypes.c_void_p]
    lib.kn_num_bp.restype = u64
    lib.kn_num_bp.argtypes = [ctypes.c_void_p]
    lib.kn_add_seq.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64]
    lib.kn_fold.restype = ctypes.c_int
    lib.kn_fold.argtypes = [ctypes.c_void_p, u32, u32, u8p]
    lib.kn_digest_file.restype = ctypes.c_int
    lib.kn_digest_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kn_scan_file.restype = ctypes.c_int
    lib.kn_scan_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u32, u64p, u64p, u64p, u64p]
    lib.kn_pack_file.restype = ctypes.c_int
    lib.kn_pack_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u32, u64, u64, u64, u64,
        u32p, u32p, u64p]
    lib.kn_canonical_kmers.restype = u64
    lib.kn_canonical_kmers.argtypes = [
        ctypes.c_char_p, u64, u32, ctypes.POINTER(ctypes.c_uint64)]
    lib.kn_murmur32.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), u64, u32, u32,
        ctypes.POINTER(ctypes.c_uint32)]
    lib.kn_unique_kmers.restype = u64
    lib.kn_unique_kmers.argtypes = [
        ctypes.c_char_p, u64, u32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.kn_sorted_intersect_count.restype = u64
    lib.kn_sorted_intersect_count.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), u64,
        ctypes.POINTER(ctypes.c_uint64), u64]
    # Hot per-read call: raw c_void_p pointers (cached ints on the Python
    # side) instead of data_as() marshalling.
    vp = ctypes.c_void_p
    lib.kn_read_search.restype = ctypes.c_int64
    lib.kn_read_search.argtypes = [
        ctypes.c_char_p, u64, u32, u64, ctypes.c_float, ctypes.c_float,
        vp, vp, vp, vp, u32, vp, vp, vp,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.kn_sriracha_file.restype = ctypes.c_int64
    lib.kn_sriracha_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u64, u64, u32, u64, u64,
        ctypes.c_float, ctypes.c_float, vp, vp, vp, vp, u32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        _MATCH_CB_T, vp]
    lib.kn_search.restype = u64
    lib.kn_search.argtypes = [
        u8p, u64, ctypes.POINTER(ctypes.c_uint64), u64, u32, u32,
        ctypes.c_int, u64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.kn_search_all.restype = u64
    lib.kn_search_all.argtypes = [
        u8p, u64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), u64,
        u32, u32, u32, u32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.kn_transpose_bits.argtypes = [u8p, u64, u64, u8p, u64]
    lib.kn_build_inventory.restype = ctypes.c_int64
    lib.kn_build_inventory.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), u64,
        u32, u32, u32, u32, u32, u32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, u64]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The native library, or None if the toolchain is unavailable."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                _LIB = _bind(ctypes.CDLL(_build()))
            except Exception as e:  # pragma: no cover - toolchain missing
                _LIB_ERR = e
    return _LIB


def available() -> bool:
    return get_lib() is not None


class CountingBuilder:
    """Per-accession counting-Bloom thresholding (native-backed).

    Reproduces the reference worker kernel exactly: two 4-bit counting
    sub-filters (seeds 0,1 and 2,3) with conservative update; a k-mer
    occurrence that lifts the minimum cell count to ``min_count`` sets its
    five hash bits in planes of length 2**max_log2_filter_len, later folded
    down to the solved filter length.
    """

    def __init__(self, k: int, min_count: int, log2_count_len: int,
                 max_log2_filter_len: int):
        lib = get_lib()
        if lib is None:
            from .fallback import PyCountingBuilder
            self._impl = PyCountingBuilder(
                k, min_count, log2_count_len, max_log2_filter_len)
            self._ptr = None
        else:
            self._lib = lib
            self._ptr = lib.kn_new(k, min_count, log2_count_len, max_log2_filter_len)
            if not self._ptr:
                raise ValueError("invalid CountingBuilder parameters")
            self._impl = None

    def add_sequence(self, seq: str | bytes) -> None:
        if self._ptr is None:
            self._impl.add_sequence(seq)
            return
        if isinstance(seq, str):
            seq = seq.encode("ascii", errors="replace")
        self._lib.kn_add_seq(self._ptr, seq, len(seq))

    @property
    def num_valid_kmer(self) -> int:
        if self._ptr is None:
            return self._impl.num_valid_kmer
        return int(self._lib.kn_num_valid_kmer(self._ptr))

    @property
    def num_bp(self) -> int:
        if self._ptr is None:
            return self._impl.num_bp
        return int(self._lib.kn_num_bp(self._ptr))

    def fold(self, log2_filter_len: int, num_hash: int) -> np.ndarray:
        """Final filter bytes (2**L / 8, LSB-first bit packing)."""
        if self._ptr is None:
            return self._impl.fold(log2_filter_len, num_hash)
        out = np.zeros((1 << log2_filter_len) // 8, dtype=np.uint8)
        rc = self._lib.kn_fold(
            self._ptr, log2_filter_len, num_hash,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == -4:
            raise MemoryError("counting builder ran out of memory mid-stream")
        if rc != 0:
            raise ValueError(
                f"invalid fold parameters (L={log2_filter_len}, h={num_hash})")
        return out

    def digest_file(self, path: str, file_format: int) -> tuple[int, int]:
        """Stream a FASTA(0)/FASTQ(1) file (.gz ok) through the counter in
        native code; returns (num_spots, num_bp). Raises on parse errors.
        Falls back to the Python reader when the native library is absent."""
        if self._ptr is None:
            from ..io.sequence import iter_sequences

            spots = bp = 0
            for _, seq in iter_sequences(path):
                self._impl.add_sequence(seq)
                spots += 1
                bp += len(seq)
            return spots, bp
        return _digest_file(self._lib, self._ptr, path, file_format)

    def close(self) -> None:
        if self._ptr is not None:
            self._lib.kn_free(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _digest_file(lib, ptr, path: str, file_format: int) -> tuple[int, int]:
    spots = ctypes.c_uint64(0)
    bp = ctypes.c_uint64(0)
    rc = lib.kn_digest_file(
        ptr, path.encode(), file_format, ctypes.byref(spots), ctypes.byref(bp)
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"truncated FASTQ record in {path}")
    if rc == -4:
        # Counting-builder/parser scratch OOM (same class as fold's -4).
        raise MemoryError(f"native builder ran out of memory ({path})")
    if rc != 0:
        raise OSError(f"error reading {path} (code {rc})")
    return spots.value, bp.value


def scan_file_native(path: str, file_format: int) -> tuple[int, int]:
    """(num_spots, num_bp) of a sequence file via the native parser;
    returns None-equivalent fallback via the Python reader when absent."""
    lib = get_lib()
    if lib is None:
        from ..io.sequence import iter_sequences

        spots = bp = 0
        for _, seq in iter_sequences(path):
            spots += 1
            bp += len(seq)
        return spots, bp
    return _digest_file(lib, None, path, file_format)


def scan_file_batch_native(path: str, file_format: int, min_len: int):
    """Batch-sizing scan: (spots, bp, rows_with_len>=min_len, max_len),
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    spots = ctypes.c_uint64()
    bp = ctypes.c_uint64()
    rows = ctypes.c_uint64()
    max_len = ctypes.c_uint64()
    rc = lib.kn_scan_file(
        path.encode(), file_format, min_len,
        ctypes.byref(spots), ctypes.byref(bp),
        ctypes.byref(rows), ctypes.byref(max_len),
    )
    if rc != 0:
        raise OSError(f"native scan of {path} failed (code {rc})")
    return spots.value, bp.value, rows.value, max_len.value


def pack_file_native(path: str, file_format: int, min_len: int,
                     row_off: int, max_rows: int,
                     packed: np.ndarray, validw: np.ndarray) -> int:
    """Pack a file's reads (len >= min_len) straight into zeroed 2-bit
    batch rows starting at row_off (the pack_reads_host layout, with NO
    intermediate Python strings). Returns the number of rows written."""
    lib = get_lib()
    assert lib is not None, "pack_file_native requires the native library"
    assert packed.dtype == np.uint32 and validw.dtype == np.uint32
    assert packed.flags["C_CONTIGUOUS"] and validw.flags["C_CONTIGUOUS"]
    rows = ctypes.c_uint64()
    rc = lib.kn_pack_file(
        path.encode(), file_format, min_len, row_off, max_rows,
        packed.shape[1], validw.shape[1],
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        validw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(rows),
    )
    if rc != 0:
        raise OSError(f"native pack of {path} failed (code {rc})")
    return rows.value


def search_native(
    slices: np.ndarray,
    flat_idx: np.ndarray,
    num_hash: int,
    num_filter: int,
    threshold: float,
    qt: int,
) -> list[tuple[int, int]] | None:
    """Bit-sliced search reduction over an in-memory slice matrix.

    ``slices``: uint8 [n_rows, slice_size]; ``flat_idx``: the
    n_kmer * num_hash row indices (k-mer major). Returns
    ``[(filter_index, count), ...]`` ascending (count == n_kmer for
    threshold 1.0), or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    assert slices.dtype == np.uint8 and slices.ndim == 2
    slices = np.ascontiguousarray(slices)
    idx = np.ascontiguousarray(flat_idx.reshape(-1), dtype=np.uint64)
    n_kmer = idx.shape[0] // num_hash
    out_idx = np.empty(num_filter, dtype=np.uint32)
    out_counts = np.empty(num_filter, dtype=np.uint64)
    n = lib.kn_search(
        slices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        slices.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_kmer, num_hash, num_filter,
        1 if threshold == 1.0 else 0, qt,
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if n == (1 << 64) - 1:  # native OOM sentinel: use the numpy twin
        return None
    return [(int(out_idx[i]), int(out_counts[i])) for i in range(n)]


def build_inventory_native(
    tar_path: str,
    out_path: str,
    strategies: "set[str] | list[str]",
    sources: "set[str] | list[str]",
    include_accessions: "list[int]",
    begin_date: tuple[int, int, int],
    end_date: tuple[int, int, int],
) -> tuple[int, int] | None:
    """Native two-pass inventory build (kn_build_inventory): returns
    (records_written, records_with_injected_sample_attrs), or None when
    the native library is unavailable. Raises like the Python twin on
    malformed archives. Dates are (day, month, year)."""
    lib = get_lib()
    if lib is None:
        return None
    if "" in strategies or "" in sources:
        # The newline-joined wire format cannot express a set containing
        # the empty string; the Python twin treats it as an active filter.
        return None
    inc = np.asarray(sorted(include_accessions), dtype=np.uint64)
    injected = ctypes.c_uint64()
    err = ctypes.create_string_buffer(512)
    rc = lib.kn_build_inventory(
        tar_path.encode(), out_path.encode(),
        "\n".join(sorted(strategies)).encode(),
        "\n".join(sorted(sources)).encode(),
        inc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), inc.shape[0],
        begin_date[0], begin_date[1], begin_date[2],
        end_date[0], end_date[1], end_date[2],
        ctypes.byref(injected), err, len(err))
    if rc == -1:
        raise FileNotFoundError(
            f"{err.value.decode(errors='replace')}: {tar_path}")
    if rc == -5:
        raise OSError(
            f"{err.value.decode(errors='replace')}: {out_path}")
    if rc < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return int(rc), int(injected.value)


def search_all_native(
    slices: np.ndarray,
    queries: list[str],
    kmer_len: int,
    num_hash: int,
    log2_filter_len: int,
    num_filter: int,
    threshold: float,
    chunk: int | None = None,
) -> list[list[tuple[int, int, int]] | None] | None:
    """Every query against one slice matrix in ONE native call.

    Returns, per query, ``[(filter_index, count, n_unique_kmer), ...]``
    in ascending filter order, or None for a query with no valid k-mers
    (the engine's no-k-mers contract). Returns None overall when the
    native library is unavailable or scratch allocation failed -- the
    caller runs the per-query twin.
    """
    lib = get_lib()
    if lib is None:
        return None
    assert slices.dtype == np.uint8 and slices.ndim == 2
    slices = np.ascontiguousarray(slices)
    # The hit buffers are sized for the hard maximum (every filter hits
    # every query), so bound them by chunking large batches.
    if chunk is None:
        chunk = max(1, 4_000_000 // max(1, num_filter))
    if len(queries) > chunk:
        out: list[list[tuple[int, int, int]] | None] = []
        for a in range(0, len(queries), chunk):
            part = search_all_native(
                slices, queries[a:a + chunk], kmer_len, num_hash,
                log2_filter_len, num_filter, threshold, chunk=chunk)
            if part is None:
                return None
            out.extend(part)
        return out
    nq = len(queries)
    # Non-ASCII codepoints become one invalid byte each ('?'): the C
    # extractor resets its window on them, exactly like the Python twin
    # does on the original characters. Callers with several database
    # files pass pre-encoded bytes to avoid re-encoding per file.
    encoded = [q if isinstance(q, bytes) else
               q.encode("ascii", errors="replace") for q in queries]
    blob = b"".join(encoded)
    off = np.zeros(nq + 1, dtype=np.uint64)
    np.cumsum([len(b) for b in encoded], out=off[1:])
    cap = nq * num_filter
    out_qid = np.empty(cap, dtype=np.uint32)
    out_fidx = np.empty(cap, dtype=np.uint32)
    out_counts = np.empty(cap, dtype=np.uint64)
    out_nkmer = np.empty(nq, dtype=np.uint64)
    n = lib.kn_search_all(
        slices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        slices.shape[1], blob,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nq, kmer_len, num_hash, log2_filter_len, num_filter,
        threshold,
        out_qid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_nkmer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if n == (1 << 64) - 1:  # native OOM sentinel
        return None
    results: list[list[tuple[int, int, int]] | None] = [
        None if out_nkmer[q] == 0 else [] for q in range(nq)
    ]
    for j in range(n):
        q = int(out_qid[j])
        results[q].append(
            (int(out_fidx[j]), int(out_counts[j]), int(out_nkmer[q])))
    return results


_TLS = threading.local()


def read_profile_native(seq: str | bytes, k: int) -> tuple[int, np.ndarray] | None:
    """(total_kmer_count, sorted-unique canonical k-mer words) for one read,
    or None when the native library is unavailable. The returned array
    aliases a thread-local scratch buffer -- consume it before the next
    call on the same thread (the SriRachA per-read loop does)."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    n_max = max(0, len(seq) - k + 1)
    buf = getattr(_TLS, "kmer_buf", None)
    if buf is None or buf.shape[0] < n_max:
        buf = np.empty(max(n_max, 4096), dtype=np.uint64)
        _TLS.kmer_buf = buf
    total = ctypes.c_uint64()
    u = lib.kn_unique_kmers(
        seq, len(seq), k,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(total))
    return int(total.value), buf[:u]


def sorted_intersect_count_native(uniq: np.ndarray, subject: np.ndarray) -> int | None:
    """|uniq ∩ subject| for sorted uint64 arrays (branchless lower_bound),
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    assert uniq.dtype == np.uint64 and subject.dtype == np.uint64
    return int(lib.kn_sorted_intersect_count(
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), uniq.shape[0],
        subject.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), subject.shape[0]))


class NativeReadSearcher:
    """Per-thread driver for kn_read_search: the whole SriRachA per-read
    kernel (profile, gates, per-subject lower_bound intersection, float32
    score threshold) in one native call.

    Construct with the subject k-mer arrays (sorted u64, as produced by
    load_subject_kmers); call ``search(seq, threshold, ...)`` per read.
    NOT thread-safe -- create one per worker thread.
    """

    def __init__(self, subjects: list[np.ndarray]):
        self._lib = get_lib()
        assert self._lib is not None
        n = len(subjects)
        flat = (np.concatenate(subjects) if n else
                np.empty(0, dtype=np.uint64)).astype(np.uint64, copy=False)
        self._flat = np.ascontiguousarray(flat)
        lens = np.array([s.shape[0] for s in subjects], dtype=np.uint64)
        offs = np.zeros(n, dtype=np.uint64)
        if n > 1:
            offs[1:] = np.cumsum(lens)[:-1]
        self._lens, self._offs = lens, offs
        self.active = np.ones(n, dtype=np.uint8)
        self._counts = np.zeros(n, dtype=np.uint64)
        self._matched = np.zeros(n, dtype=np.uint8)
        self._kbuf = np.empty(4096, dtype=np.uint64)
        self._p_kbuf = self._kbuf.ctypes.data
        self._n = n
        # Raw pointers cached once; all arrays are owned by self.
        self._p_flat = self._flat.ctypes.data
        self._p_offs = offs.ctypes.data
        self._p_lens = lens.ctypes.data
        self._p_active = self.active.ctypes.data
        self._p_counts = self._counts.ctypes.data
        self._p_matched = self._matched.ctypes.data
        self._nu = ctypes.c_uint64()
        self._nk = ctypes.c_uint64()

    def search(self, seq: bytes | str, k: int, min_valid_kmer: int,
               min_complexity: float, threshold: float):
        """Returns None when a gate rejected the read; otherwise
        (num_kmer, num_unique, matched_indices, counts_view)."""
        if isinstance(seq, str):
            seq = seq.encode("ascii", errors="replace")
        n_max = len(seq)
        if self._kbuf.shape[0] < n_max:
            self._kbuf = np.empty(n_max, dtype=np.uint64)
            self._p_kbuf = self._kbuf.ctypes.data
        rc = self._lib.kn_read_search(
            seq, len(seq), k, min_valid_kmer, min_complexity, threshold,
            self._p_flat, self._p_offs, self._p_lens, self._p_active,
            self._n, self._p_kbuf, self._p_counts,
            self._p_matched, ctypes.byref(self._nu), ctypes.byref(self._nk))
        if rc < 0:
            return None
        matched = np.nonzero(self._matched)[0] if rc else ()
        return int(self._nk.value), int(self._nu.value), matched, self._counts

    def search_file(self, path: str, file_format: int, start: int, stop: int,
                    k: int, min_read_length: int, min_valid_kmer: int,
                    min_complexity: float, threshold: float,
                    on_match) -> tuple[int, int]:
        """Stream a local file's read range [start, stop) through the
        kernel entirely in native code; ``on_match(subject_index,
        read_index, score, seq_bytes)`` fires per match (it may flip
        ``self.active`` entries off). Returns (num_reads, num_bases) of
        the range.

        An exception raised by ``on_match`` re-raises here after the scan
        returns (ctypes would otherwise print-and-swallow it inside the C
        callback, silently dropping matches)."""
        cb_err: list[BaseException] = []

        def _cb(_ctx, s, ridx, score, seqp, seqlen):
            if cb_err:
                return  # poisoned: drain remaining native callbacks
            try:
                on_match(int(s), int(ridx), float(score),
                         ctypes.string_at(seqp, seqlen))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                cb_err.append(e)

        cb = _MATCH_CB_T(_cb)
        reads = ctypes.c_uint64()
        bases = ctypes.c_uint64()
        rc = self._lib.kn_sriracha_file(
            path.encode(), file_format, start, stop, k, min_read_length,
            min_valid_kmer, min_complexity, threshold,
            self._p_flat, self._p_offs, self._p_lens, self._p_active,
            self._n, ctypes.byref(reads), ctypes.byref(bases), cb, None)
        if cb_err:
            raise cb_err[0]
        if rc == -1:
            raise FileNotFoundError(path)
        if rc == -2:
            raise ValueError(f"truncated FASTQ record in {path}")
        if rc == -4:
            raise MemoryError(f"native scan scratch allocation failed ({path})")
        if rc < 0:
            raise OSError(f"error reading {path} (code {rc})")
        return int(reads.value), int(bases.value)


def canonical_kmers_native(seq: str | bytes, k: int) -> np.ndarray:
    """Canonical k-mer words via the native library (numpy fallback otherwise)."""
    lib = get_lib()
    if lib is None:
        from ..core.words import canonical_kmers
        return canonical_kmers(seq, k)
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    n_max = max(0, len(seq) - k + 1)
    out = np.empty(n_max, dtype=np.uint64)
    n = lib.kn_canonical_kmers(
        seq, len(seq), k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out[:n]


def murmur32_native(words: np.ndarray, k: int, num_seeds: int) -> np.ndarray:
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint64)
    if lib is None:
        from ..core.hash import murmur32_words
        return murmur32_words(words, k, num_seeds)
    out = np.empty((words.shape[0], num_seeds), dtype=np.uint32)
    lib.kn_murmur32(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        words.shape[0], k, num_seeds,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def transpose_bits_native(
    filter_bytes: "np.ndarray", num_filter: int
) -> "np.ndarray | None":
    """Packed bit-matrix transpose [F, nbytes] -> [8*nbytes,
    ceil(num_filter/8)] (the .db build's filters -> bit-slices step,
    build_db.cpp:280-362), LSB-first both sides. Delta-swap 8x8 blocks
    with output-resident tiling -- ~50x numpy's unpack/transpose/pack on
    the 2048-filter x 2^18-bit design point. None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(filter_bytes, dtype=np.uint8)
    F, nbytes = src.shape
    if num_filter < F:
        # num_filter only ever PADS the output width (ceil(num_filter/8)
        # columns); a narrower-than-source width would make the C kernel
        # write past its row stride. Same contract as the numpy twin.
        raise ValueError(f"num_filter ({num_filter}) < source rows ({F})")
    stride = max((num_filter + 7) // 8, 1)
    dst = np.empty((8 * nbytes, stride), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kn_transpose_bits(
        src.ctypes.data_as(u8p), F, nbytes, dst.ctypes.data_as(u8p), stride
    )
    return dst
