"""REAL multi-process mesh search: 2 jax.distributed CPU processes.

The virtual 8-device mesh used everywhere else lives in ONE process; this
suite spawns two OS processes that form a gloo-backed jax.distributed
cluster (2 local devices each -> 4 global), build the process-spanning
global mesh, and run `sharded_search_files` end to end over on-disk .db
files. Every process must emit the identical GLOBAL hit list (outputs
are all-gathered back by `to_host`), and that hit list must equal the
host engine's -- the cross-host analog of the reference's MPI rank-0
result merge (SriRachA/main.cpp:462-531).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from kwage.core import FilterInfo, str_to_accession
    from kwage.pipeline import (
        BuildOptions,
        build_bloom_from_file,
        build_db_from_bloom_files,
    )
    from kwage.io.bloom_file import write_bloom_file

    work = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(40)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    opts = BuildOptions(
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=10, max_log_2_filter_len=14,
        min_log_2_count_len=10, max_log_2_count_len=14,
    )
    genomes, blooms = {}, []
    (work / "db").mkdir()
    for i in range(6):
        acc = f"SRR88000{i}"
        g = lut[rng.integers(0, 4, size=3000, dtype=np.uint8)].tobytes().decode()
        genomes[acc] = g
        fa = work / f"{acc}.fasta"
        fa.write_text(f">{acc}\n{g}\n")
        rec = build_bloom_from_file(
            str(fa), opts, FilterInfo(run_accession=str_to_accession(acc)))
        bpath = work / f"{acc}.bloom"
        write_bloom_file(str(bpath), rec)
        blooms.append((rec.param, str(bpath)))
    # Two .db files of 3 filters each (same param group).
    param = blooms[0][0]
    assert all(p == param for p, _ in blooms)
    for fi, chunk in enumerate((blooms[:3], blooms[3:])):
        build_db_from_bloom_files(
            str(work / "db" / f"sra.{fi + 1}.db"), param,
            [b for _, b in chunk])
    queries = [
        [0, genomes["SRR880001"][500:900]],
        [1, genomes["SRR880004"][100:450]],
        [2, "".join("ACGT"[b] for b in rng.integers(0, 4, size=200))],
    ]
    (work / "queries.json").write_text(json.dumps(queries))
    return work, queries


def test_two_process_mesh_search_matches_host(corpus):
    work, queries = corpus
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    worker = os.path.join(HERE, "_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, out
        outs.append(json.loads(lines[-1][len("RESULT "):]))

    # Identical global result on every process.
    assert outs[0] == outs[1]

    # Equal to the host engine (the reference's output semantics).
    from kwage.search.engine import search_database_files

    dbs = sorted(str(p) for p in (work / "db").glob("*.db"))
    want = search_database_files(dbs, [(i, q) for i, q in queries], 0.5)
    expect = {
        str(i): [
            [m.num_kmers_found, m.num_query_kmer,
             int(m.subject_info.run_accession)]
            for m in ms
        ]
        for i, ms in sorted(want.items())
    }
    assert outs[0] == expect
    # The random query must have matched nothing; the genome slices must
    # have matched their source accession (guards against an all-empty
    # vacuous pass).
    assert outs[0].get("2", []) == [] and outs[0]["0"] and outs[0]["1"]
