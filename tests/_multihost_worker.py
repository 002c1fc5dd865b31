"""Subprocess body for test_multihost: one process of a 2-process
jax.distributed CPU cluster running the REAL mesh search pipeline.

Usage: python _multihost_worker.py <pid> <nproc> <port> <workdir>
Prints one line: RESULT <json> (identical on every process: mesh outputs
are all-gathered back to each host by sharded_search.to_host).
"""

import glob
import json
import os
import sys

# Runnable straight from a checkout, with or without `pip install -e .`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nproc, port, work = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from kwage.parallel.distributed import (
        init_distributed,
        make_global_search_mesh,
        shard_inventory,
    )

    assert init_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    mesh = make_global_search_mesh(num_data=1)
    assert mesh.devices.size == jax.device_count()

    from kwage.parallel.sharded_search import sharded_search_files

    dbs = sorted(glob.glob(os.path.join(work, "db", "*.db")))
    queries = [(int(i), q) for i, q in json.load(
        open(os.path.join(work, "queries.json")))]
    got = sharded_search_files(mesh, dbs, queries, 0.5)
    out = {
        str(i): [
            [m.num_kmers_found, m.num_query_kmer,
             int(m.subject_info.run_accession)]
            for m in ms
        ]
        for i, ms in sorted(got.items())
    }
    # The contiguous per-host split rule is pure arithmetic; pin it here
    # so the multi-process run exercises it at its real call site shape.
    first, last = shard_inventory(10, pid, nproc)
    assert 0 <= first <= last <= 10
    print("RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
