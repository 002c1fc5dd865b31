"""On-chip SriRachA device-path bench: end-to-end Mbp/s at a given k.

Measures kwage.sriracha.device.search_reads_device over a synthetic
read stream (the reference's per-read kernel loop, sra_stream.cpp:525-543
+ search_by_kmer.cpp), INCLUDING host-side batching/packing and the
per-batch np.asarray readbacks -- i.e. what a user of `sriracha --device`
actually gets. One warm-up span pays the per-shape compile; the timed
region covers the remaining spans.

Honest-timing note (CLAUDE.md measurement discipline): the end-to-end
number is real throughput, not dispatch rate, ONLY because
search_reads_device drains its 1-deep span pipeline -- every span's
results are np.asarray'd before the function returns. Do not time a
sub-piece (e.g. dispatch_span alone) with this pattern.

Usage: python tools/bench_sriracha_device.py [k] [read_len] [n_reads] [path]
``path``: auto (default) | lut | hash -- forces the kernel-only section's
subject-table formulation (the end-to-end section always uses the
production routing).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_reads(n: int, read_len: int, rng: np.random.Generator):
    bases = np.array(list("ACGT"))
    arr = rng.integers(0, 4, size=(n, read_len))
    return ["".join(bases[row]) for row in arr]


def main() -> None:
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 21
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    n_reads = int(sys.argv[3]) if len(sys.argv) > 3 else 65536
    path = sys.argv[4] if len(sys.argv) > 4 else "auto"
    subj_kmers = int(sys.argv[5]) if len(sys.argv) > 5 else 2048

    from kwage.sriracha.engine import SrirachaOptions, canonical_kmers
    from kwage.sriracha.device import search_reads_device
    from kwage.utils.runtime import enable_compile_cache, require_accelerator

    require_accelerator("bench_sriracha_device.py")
    enable_compile_cache()

    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))

    # 4 subjects, ~subj_kmers k-mers each (default 2048: gene-scale).
    subjects = []
    for i in range(4):
        seq = "".join(bases[rng.integers(0, 4, size=subj_kmers + k - 1)])
        subjects.append((f"subject{i}", np.unique(canonical_kmers(seq, k))))

    opt = SrirachaOptions(kmer_len=k)
    reads = make_reads(n_reads, read_len, rng)
    stream = [(seq, i, 0) for i, seq in enumerate(reads)]

    batch = 512
    span = 16 * batch
    # Warm-up: one span pays the compile for this (k, padded-len) shape.
    t0 = time.time()
    search_reads_device(stream[:span], subjects, opt, batch_size=batch,
                        span_reads=span)
    warm_s = time.time() - t0

    timed = stream[span:]
    t0 = time.time()
    res = search_reads_device(timed, subjects, opt, batch_size=batch,
                              span_reads=span)
    dt = time.time() - t0
    bp = len(timed) * read_len
    mbps = bp / dt / 1e6

    # Kernel-only chained timing (CLAUDE.md measurement discipline):
    # N dependent kernel invocations inside one jit, batch rows rotated
    # per iteration so nothing hoists, slope between two N. Separates
    # the device kernel's own rate from host packing + transfer RTTs.
    import jax
    import jax.numpy as jnp
    from kwage.sriracha.device import (
        _read_batch_kernel_hash, _read_batch_kernel_tables,
        _build_hash_group, build_subject_table, uses_dense_table,
    )

    block = np.zeros((batch, read_len), dtype=np.uint8)
    for r in range(batch):
        block[r] = np.frombuffer(reads[r].encode("ascii"), dtype=np.uint8)
    lengths = np.full(batch, read_len, dtype=np.int32)
    block_d, lengths_d = jnp.asarray(block), jnp.asarray(lengths)
    ns_groups = (len(subjects),)

    if path == "auto":  # search_reads_device's own router
        use_lut = uses_dense_table(subjects, k)
    else:
        use_lut = path == "lut"
    if use_lut:
        smax = max(s.size for _, s in subjects)
        subj = np.full((len(subjects), smax), 0xFFFFFFFF, dtype=np.uint32)
        for i, (_, s) in enumerate(subjects):
            subj[i, : s.size] = s.astype(np.uint32)
        tables = (build_subject_table(jnp.asarray(subj), k),)

        def kern(b, l):
            return _read_batch_kernel_tables(b, l, tables, k, ns_groups)
    else:
        tables = (tuple(jnp.asarray(a) for a in _build_hash_group(
            [s.astype(np.uint64) for _, s in subjects])),)

        def kern(b, l):
            return _read_batch_kernel_hash(b, l, tables, k, ns_groups)

    @jax.jit
    def chained(b, l, n):
        def body(i, acc):
            c, nk_, nu_ = kern(jnp.roll(b, i, axis=0), l)
            return acc + c.sum(dtype=jnp.int32) + nk_.sum(dtype=jnp.int32)
        return jax.lax.fori_loop(0, n, body, jnp.int32(0))

    np.asarray(chained(block_d, lengths_d, 1))  # compile + warm
    import time as _t
    per = []
    for _ in range(5):
        t0 = _t.perf_counter()
        np.asarray(chained(block_d, lengths_d, 2))
        lo = _t.perf_counter() - t0
        t0 = _t.perf_counter()
        np.asarray(chained(block_d, lengths_d, 34))
        hi = _t.perf_counter() - t0
        per.append((hi - lo) / 32)
    kernel_s = sorted(per)[len(per) // 2]
    kernel_mbps = batch * read_len / kernel_s / 1e6

    out = {
        "metric": "sriracha_device_mbps",
        "kernel_only_mbps": round(kernel_mbps, 1),
        "k": k,
        "read_len": read_len,
        "reads_timed": len(timed),
        "value": round(mbps, 1),
        "unit": "Mbp/s",
        "warmup_compile_s": round(warm_s, 1),
        "timed_s": round(dt, 2),
        "matches": sum(len(r) for r in res),
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
