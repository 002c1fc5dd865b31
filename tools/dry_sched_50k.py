"""Scheduler-only stress: 50k accessions through the full event loop.

Workers are instant fakes (no parsing, no device), so wall time measures
pure scheduling: cursor dispatch, event absorption, the event-driven
BloomParam group map, quota packing, checkpoints. Proves the
maestro_main.cpp:87-106-analog grouping stays flat at the scale the lazy
inventory was built for (the round-2 rescan design was O(pending) file
opens per round -> O(n^2) per job; this run must do ZERO .bloom opens
and complete in seconds).

Prints one JSON line; env: DRY_N (50000), DRY_QUOTA accessions/file via
L (default leaves the 2048 quota).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

N = int(os.environ.get("DRY_N", "50000"))


def main() -> int:
    import kwage.parallel.maestro as maestro_mod
    from kwage.core import BloomParam, FilterInfo, str_to_accession
    from kwage.core.hash import MURMUR_HASH_32
    from kwage.io.inventory import write_inventory
    from kwage.parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )

    class DryMaestro(Maestro):
        """Instant worker fakes: the event loop is the only real work."""

        def _process_accession(self, idx, phase):
            # Two shapes -> two concurrent BloomParam groups in the map.
            L = 18 + (idx & 1)
            return (idx, maestro_mod.STATUS_BLOOM_SUCCESS,
                    BloomParam(kmer_len=31, log_2_filter_len=L,
                               num_hash=5, hash_func=MURMUR_HASH_32), 0.0)

        def _build_database(self, db_index, param, members):
            return (members, STATUS_DATABASE_SUCCESS,
                    f"sra.{db_index}.db", 0.0)

    opens = {"n": 0}
    real = maestro_mod.read_bloom_file

    def counting(path, with_bits=True):
        opens["n"] += 1
        return real(path, with_bits)

    maestro_mod.read_bloom_file = counting
    work = tempfile.mkdtemp(prefix="dry50k.")
    try:
        infos = [FilterInfo(run_accession=str_to_accession(f"SRR8{i:07d}"))
                 for i in range(N)]
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        opt = MaestroOptions(
            metadata_file=inv,
            scratch_bloom_dir=os.path.join(work, "bloom"),
            scratch_database_dir=os.path.join(work, "db"),
            status_file=os.path.join(work, "status.bin"),
            num_workers=4,
            lazy_inventory=True,
        )
        t0 = time.perf_counter()
        m = DryMaestro(opt, LocalFastaResolver(work))
        m.restore()
        m.run()
        dt = time.perf_counter() - t0
        ok = bool((m.status == STATUS_DATABASE_SUCCESS).all())
        n_db = m.database_index - 1
        print(json.dumps({
            "accessions": N,
            "ok": ok,
            "db_files_packed": int(n_db),
            "bloom_header_opens": opens["n"],
            "wall_sec": round(dt, 2),
            "events_per_sec": round(N / dt, 1),
        }))
        return 0 if ok and opens["n"] == 0 else 1
    finally:
        maestro_mod.read_bloom_file = real
        import shutil

        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
