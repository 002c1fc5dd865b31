"""Device mesh construction for sharded search.

Two logical axes:
- ``data``    -- query batch parallelism (each device searches its own
                 query shard against its filter shard, then gathers),
- ``filters`` -- corpus width: the signature matrix is sharded by packed
                 filter words (the device analog of the reference's
                 <=2048-filter database files searched independently,
                 options.h:137-138 / kwage.cpp:76-151).

The mesh follows the algorithm alone: the search kernels need no
collective on the hot path, and the cards of one host reach each other
all to all over NVLink, so no device order is better than another.
Scaling the corpus means growing the ``filters`` axis, matching how KWAGE
scales by adding database files.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_search_mesh(
    num_data: int = 1, num_filter_shards: int | None = None, devices=None
) -> Mesh:
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if num_filter_shards is None:
        num_filter_shards = n // num_data
    if num_data * num_filter_shards != n:
        raise ValueError(
            f"mesh {num_data}x{num_filter_shards} != {n} devices"
        )
    import numpy as np

    return Mesh(
        np.asarray(devices).reshape(num_data, num_filter_shards),
        ("data", "filters"),
    )
