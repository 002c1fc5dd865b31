"""Multi-host wiring: jax.distributed init + pod-spanning search meshes.

The reference scales with MPI ranks over the network (maestro
master/worker, SriRachA SPMD; SURVEY.md section 5.8). The JAX
equivalents:

- device-side: one global Mesh over every device of every process; the
  signature matrix shards along "filters", query batches along "data".
  The search kernels need NO collective on the hot path (outputs stay
  sharded on both axes), so axis placement is free; keeping "filters"
  within a host means any future cross-filter reduction stays on the
  host's NVLink.
- host-side: the maestro work queue stays per-process (accessions are
  embarrassingly parallel); run one maestro per host over a disjoint
  inventory shard (`shard_inventory`), sharing nothing but the S3 bucket.

All functions degrade gracefully to single-process use.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed from args or the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; all
    three are needed, nothing is detected). Returns True when a
    multi-process runtime was started, False for single-process runs."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_search_mesh(num_data: int | None = None):
    """A ("data", "filters") mesh over every device in the (possibly
    multi-host) runtime. "filters" is laid out innermost so each host's
    local devices hold adjacent filter shards (cross-filter traffic, if a
    kernel ever needs it, stays within a host)."""
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if num_data is None:
        num_data = jax.process_count() if n % jax.process_count() == 0 else 1
    if n % num_data:
        raise ValueError(f"{n} devices not divisible into {num_data} data shards")
    return Mesh(devices.reshape(num_data, n // num_data), ("data", "filters"))


def shard_inventory(num_records: int, process_id: int, num_processes: int) -> tuple[int, int]:
    """Contiguous per-host accession range [first, last): equal chunks,
    remainder to the last host -- the same partition rule SriRachA applies
    to read ranges (sra_stream.cpp:525-543)."""
    per = num_records // num_processes
    first = process_id * per
    last = num_records if process_id == num_processes - 1 else first + per
    return first, last
