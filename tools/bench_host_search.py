"""Host search head-to-head vs the reference kwage binary.

Builds a corpus at the reference's design point (2048 filters, L=18,
random bits -- both engines do identical work on identical bytes),
verifies byte-identical JSON output, then times:
  - the oracle binary end to end (its startup is negligible),
  - our CLI end to end (cold; the host CLI's import chain is jax-free),
  - our warm in-process engine (the serving operating point),
using the 100->1000-query slope for the honest marginal cost per query.

Usage: python tools/bench_host_search.py [workdir]
Writes one JSON line per phase; requires /tmp/oracle/kwage for the
oracle legs (skips them otherwise).
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ORACLE = "/tmp/oracle/kwage"


def log(phase, **kw):
    rec = {"phase": phase, **kw}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    from kwage.core import FilterInfo, str_to_accession
    from kwage.core.params import BloomParam
    from kwage.io.bloom_file import BloomFilterRecord, write_bloom_file
    from kwage.pipeline import build_db_from_bloom_files
    from kwage.search.engine import search_database_files

    work = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="hostsearch.")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)

    L = int(os.environ.get("HSB_L", 18))
    nf = int(os.environ.get("HSB_FILTERS", 2048))
    rng = np.random.default_rng(1)
    param = BloomParam(kmer_len=31, log_2_filter_len=L, num_hash=5)
    nbytes = (1 << L) // 8
    os.makedirs("blooms", exist_ok=True)
    t0 = time.time()
    paths = []
    for i in range(nf):
        bits = rng.random(nbytes * 8) < 0.30
        bb = np.packbits(bits.reshape(-1, 8)[:, ::-1]).astype(np.uint8)
        rec = BloomFilterRecord(
            param=param, crc32=zlib.crc32(bb.tobytes()) & 0xFFFFFFFF,
            info=FilterInfo(run_accession=str_to_accession(f"SRR{i + 1:07d}")),
            bits=bb)
        p = f"blooms/b{i}.bloom"
        write_bloom_file(p, rec)
        paths.append(p)
    build_db_from_bloom_files("sra.1.db", param, paths)
    log("corpus", filters=nf, L=L,
        db_mb=round(os.path.getsize("sra.1.db") / 1e6, 1),
        build_sec=round(time.time() - t0, 1))

    qs = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(1000)]
    for n in (100, 1000):
        with open(f"q{n}.fasta", "w") as f:
            for i, s in enumerate(qs[:n]):
                f.write(f">q{i}\n{s}\n")

    have_oracle = os.path.exists(ORACLE)
    for thr in ("0.8", "1.0"):
        times = {}
        if have_oracle:
            for n in (100, 1000):
                t0 = time.time()
                subprocess.run(
                    [ORACLE, "-d", "sra.1.db", "-t", thr, "-i",
                     f"q{n}.fasta", "--o.json", "-o", f"o_{thr}_{n}.json"],
                    check=True, capture_output=True)
                times[f"oracle_{n}q_sec"] = round(time.time() - t0, 3)
            times["oracle_marginal_ms_per_q"] = round(
                (times["oracle_1000q_sec"] - times["oracle_100q_sec"])
                / 900 * 1000, 3)
        for n in (100, 1000):
            t0 = time.time()
            subprocess.run(
                [sys.executable, "-m", "kwage.cli.kwage", "-d",
                 "sra.1.db", "-t", thr, "-i", f"q{n}.fasta", "--o.json",
                 "-o", f"u_{thr}_{n}.json"],
                check=True, capture_output=True)
            times[f"cli_cold_{n}q_sec"] = round(time.time() - t0, 3)
        queries = [(i, s) for i, s in enumerate(qs)]
        t0 = time.time()
        search_database_files(["sra.1.db"], queries[:100], float(thr))
        t1 = time.time()
        search_database_files(["sra.1.db"], queries, float(thr))
        t2 = time.time()
        times["warm_100q_sec"] = round(t1 - t0, 3)
        times["warm_1000q_sec"] = round(t2 - t1, 3)
        times["warm_marginal_ms_per_q"] = round(
            ((t2 - t1) - (t1 - t0)) / 900 * 1000, 3)
        identical = True
        if have_oracle:
            for n in (100, 1000):
                with open(f"o_{thr}_{n}.json", "rb") as f:
                    a = f.read()
                with open(f"u_{thr}_{n}.json", "rb") as f:
                    b = f.read()
                identical = identical and a == b
        log("search", threshold=float(thr),
            byte_identical_to_oracle=identical if have_oracle else None,
            **times)
    return 0


if __name__ == "__main__":
    sys.exit(main())
