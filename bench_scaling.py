"""Scaling harness: k-mer query throughput vs mesh size (BASELINE config 4).

Shards the signature matrix over the "filters" axis of a 1D mesh built
from the first 1, 2, 4, ... N available devices; the TOTAL database grows
with the mesh (weak scaling -- each device holds one 2048-filter shard of
a 2^20-row matrix), so perfect scaling = flat time per step as devices
double. Prints one JSON line per mesh size with queries/s and efficiency
vs the single-device point.

Run on real hardware, or on a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python bench_scaling.py

Multi-host pods: launch one copy per host with the standard
jax.distributed env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID; all three are needed). The cluster initializes, the
single measured point is the FULL global mesh (smaller meshes would need
non-participating processes to idle inside collective programs), and
process 0 prints the JSON line; set SCALING_BASE_RATE to a recorded
single-chip kmer_queries_per_sec to get the efficiency column.

Timing is device-chained (see bench.py): N dependent iterations inside
one jit, slope between two iteration counts, host readback at the end.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

LOG2_L = int(os.environ.get("SCALING_LOG2_L", "20"))
# 512 words = 8 fused 2048-filter files per device: the wide-row regime
# the single-chip bench runs in (narrow rows are gather-latency bound).
W_PER_DEV = int(os.environ.get("SCALING_W_PER_DEV", "512"))
NQ = int(os.environ.get("SCALING_NQ", "8"))
NK = int(os.environ.get("SCALING_NK", "512"))
NH = 5


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kwage.ops.search import counts_kernel

    from kwage.parallel.distributed import init_distributed
    from kwage.utils.runtime import enable_compile_cache, require_accelerator

    multiproc = init_distributed()
    require_accelerator("bench_scaling.py")
    enable_compile_cache()

    devices = jax.devices()
    rng = np.random.default_rng(0)
    idx_host = rng.integers(0, 1 << LOG2_L, size=(NQ, NK, NH), dtype=np.int32)
    mask = jnp.int32((1 << LOG2_L) - 1)

    if multiproc:
        # Every process must execute every collective program, so only the
        # full global mesh is measurable; sub-mesh points come from runs
        # with fewer hosts (or the recorded single-chip rate).
        sizes = [len(devices)]
    else:
        sizes = []
        n = 1
        while n <= len(devices):
            sizes.append(n)
            n *= 2

    base_rate = float(os.environ["SCALING_BASE_RATE"]) \
        if os.environ.get("SCALING_BASE_RATE") else None
    for nd in sizes:
        mesh = Mesh(np.array(devices[:nd]), ("filters",))
        sharding = NamedSharding(mesh, P(None, "filters"))

        def make_db(key):
            return jax.random.bits(key, (1 << LOG2_L, W_PER_DEV * nd), dtype=jnp.uint32)

        # out_shardings materializes each shard on its own device directly
        # (no full-size staging buffer; required for process-spanning meshes).
        db = jax.jit(make_db, out_shardings=sharding)(jax.random.key(0))
        idx = jnp.asarray(idx_host)
        valid = jnp.ones((NQ, NK), dtype=bool)

        sharded = jax.jit(
            jax.shard_map(
                counts_kernel,
                mesh=mesh,
                in_specs=(P(None, "filters"), P(None, None, None), P(None, None)),
                out_specs=P(None, "filters"),
            )
        )

        @jax.jit
        def chained(db, idx, valid, n):
            def body(i, acc):
                ix = (idx + i) & mask
                return acc + sharded(db, ix, valid).sum(dtype=jnp.int32)
            return jax.lax.fori_loop(0, n, body, jnp.int32(0))

        np.asarray(chained(db, idx, valid, 1))
        res = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(chained(db, idx, valid, 2))
            lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            np.asarray(chained(db, idx, valid, 18))
            hi = time.perf_counter() - t0
            res.append((hi - lo) / 16)
        per_iter = sorted(res)[1]
        # 2048-filter file-equivalents: each device-local row covers
        # W_PER_DEV/64 files.
        rate = NQ * NK * nd * (W_PER_DEV // 64) / per_iter
        if base_rate is None:
            if multiproc:
                # No single-device point exists in a multi-process run:
                # without SCALING_BASE_RATE the efficiency column would
                # read 1/nd -- meaningless. Report null instead.
                eff = None
            else:
                base_rate = rate
                eff = 1.0
        else:
            eff = round(rate / (base_rate * nd), 3)
        if jax.process_index() == 0:
            print(
                json.dumps(
                    {
                        "devices": nd,
                        "kmer_queries_per_sec": round(rate, 1),
                        "scaling_efficiency": eff,
                    }
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
