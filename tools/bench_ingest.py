"""Device ingest speed-of-light probe: Mbp/s through the full on-chip
counting pipeline (k-merize -> 3-key segmented sort -> shifted-compare
threshold -> murmur -> batched filter scatter), the compute path behind
build_blooms_device_batch.

Workload is REPRESENTATIVE, not adversarial: reads are sampled from a
per-accession genome at ~COV x coverage (like real SRA runs), so
min_kmer_count thresholding selects ~genome-many distinct k-mers and the
scatter sets distinct x num_hash bits -- the same regime the reference's
count_words runs in (make_bloom.cpp:506-621). Random unique reads with
min_count=1 are the worst case (every window scatters; measured
separately as the floor).

Data is generated ON DEVICE and timing is device-chained (N dependent
iterations inside one jit, slope between two N, readback at the end) --
the host link never enters the measurement (CLAUDE.md discipline).

Env: INGEST_ACCS (8), INGEST_READS (8192 per acc batch), INGEST_LEN
(384), INGEST_COV (4), INGEST_MINCOUNT (2), INGEST_HASH (5),
INGEST_LOG2L (20).

The pipeline's irreducible element-granularity ops are the (acc, word)
sort, the compaction gathers and the final scatter; the production build
path amortizes everything behind batching and host pipelining
(bench_build.py). Device rate on the H100: not measured.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

ACCS = int(os.environ.get("INGEST_ACCS", "8"))
READS = int(os.environ.get("INGEST_READS", "8192"))
RLEN = int(os.environ.get("INGEST_LEN", "384"))
COV = int(os.environ.get("INGEST_COV", "4"))
MINCOUNT = int(os.environ.get("INGEST_MINCOUNT", "2"))
NH = int(os.environ.get("INGEST_HASH", "5"))
LOG2L = int(os.environ.get("INGEST_LOG2L", "20"))
K = 31


def main() -> None:
    import jax
    import jax.numpy as jnp

    from kwage.utils.runtime import enable_compile_cache, require_accelerator

    require_accelerator("bench_ingest.py")
    enable_compile_cache()

    from kwage.ops.counting import (
        count_kmers_device_multi,
        set_filter_bits_multi,
    )

    total_bp = ACCS * READS * RLEN
    genome_len = READS * RLEN // COV

    @jax.jit
    def make_reads(key):
        """Coverage reads sampled from per-accession genomes, on device."""
        bases = jnp.frombuffer(b"ACGT", dtype=jnp.uint8)
        kg, ks = jax.random.split(key)
        genomes = jax.random.choice(kg, bases, shape=(ACCS, genome_len))
        starts = jax.random.randint(
            ks, (ACCS, READS), 0, genome_len - RLEN, dtype=jnp.int32
        )
        window = jnp.arange(RLEN, dtype=jnp.int32)
        reads = jax.vmap(lambda g, s: g[s[:, None] + window])(genomes, starts)
        return reads.reshape(ACCS * READS, RLEN)

    reads = make_reads(jax.random.key(0))
    acc_ids = jnp.repeat(jnp.arange(ACCS, dtype=jnp.int32), READS)
    slot = jnp.arange(ACCS + 1, dtype=jnp.int32).at[ACCS].set(-1)

    # Probe the selected count once to size the static compaction bucket
    # (the production builder does the same off its num_valid readback).
    nv = np.asarray(
        count_kmers_device_multi(reads, acc_ids, K, MINCOUNT, ACCS)[4]
    )
    total_sel = int(nv.sum())
    compact = 1 << max(int(np.ceil(np.log2(max(total_sel, 1)))), 10)
    if compact >= reads.shape[0] * (reads.shape[1] - K + 1):
        compact = 0

    @jax.jit
    def chained(reads, acc_ids, n):
        def body(i, acc):
            r = jnp.roll(reads, i, axis=0)
            acc_s, hi_s, lo_s, selected, nv = count_kmers_device_multi(
                r, acc_ids, K, MINCOUNT, ACCS
            )
            packed = set_filter_bits_multi(
                acc_s, hi_s, lo_s, selected, slot, K, NH, LOG2L, ACCS, compact
            )
            return acc + packed[0, 0] + nv[0].astype(jnp.uint32)
        return jax.lax.fori_loop(0, n, body, jnp.uint32(0))

    np.asarray(chained(reads, acc_ids, 1))

    def measure(n_lo, n_hi):
        res = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(chained(reads, acc_ids, n_lo))
            lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            np.asarray(chained(reads, acc_ids, n_hi))
            hi = time.perf_counter() - t0
            res.append((hi - lo) / (n_hi - n_lo))
        return sorted(res)[1]

    per_iter = measure(1, 5)
    print(
        json.dumps(
            {
                "metric": "device_ingest_mbp_per_sec",
                "value": round(total_bp / per_iter / 1e6, 1),
                "unit": (
                    f"Mbp/s on-chip (count+threshold+{NH}-seed scatter, "
                    f"{ACCS} accs batched, {COV}x coverage, "
                    f"min_count={MINCOUNT}, L=2^{LOG2L})"
                ),
                "ms_per_batch": round(per_iter * 1e3, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
