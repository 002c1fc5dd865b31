"""Smoke run of the main path on an NVIDIA GPU: build -> search -> serve
-> SriRachA, through the entry points a user calls, at real sizes.

    python chip_smoke.py          # one card, every phase
    python chip_smoke.py --four   # four cards: the mesh paths only

Run it from the root of a checkout on a machine with a GPU. Phases:

1. device    -- what JAX found; no GPU is an error.
2. build     -- ``maestro --device-build --device-transpose`` over 256
                synthetic accessions of ~300 kbp, then the same command
                on the host: every .db and .bloom file is sha256-identical.
3. search    -- a warehouse at the reference's own settings (k=31, 5
                seeds, 2048 filters per file, L=24: 4 GiB per file, 4
                files) with planted query k-mers; ``kwage --device`` at
                -t 1.0 and 0.5 is byte-identical to the host engine and
                finds exactly the planted hits.
4. serve     -- ``SearchServer`` with the device engine on the same
                files, in this process: every reply equals the batch
                output of phase 3.
5. sriracha  -- ``sriracha --device`` over 100k 150 bp reads, against a
                k=21 panel (hash table) and a k=11 panel large enough for
                the dense table: TSVs identical to the host path.
6. kernels   -- informational timings (transpose, filter scatter and
                packing, search kernel), each beside the card's name and
                power limit.

``--four`` runs only what spans cards, on four: ``kwage --device`` over
the phase-3 warehouse (four devices select the filters mesh), the mesh
serve path, ``sriracha --device`` on the data mesh, and the multi-device
dry run, each against the host engine.

All device arithmetic here is integer or bitwise, so every comparison is
exact. Every input is generated from --seed into a scratch directory
under TMPDIR, removed at exit. One JSON object is the last line of
standard output, printed only when every phase passed; any failure exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import re
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

import kwage  # noqa: F401  -- fails fast outside a checkout

BUILD_ACCESSIONS = 256
BUILD_BP = 300_000
WAREHOUSE = dict(kmer_len=31, num_hash=5, num_filter=2048,
                 log2_filter_len=24, num_files=4)
NUM_QUERIES = 64
QUERY_LEN = (200, 10_000)
NUM_READS = 100_000
READ_LEN = 150
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


class SmokeFailure(RuntimeError):
    """A phase's output differed from what it is compared with."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "unknown"


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "card": card()}), flush=True)


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _device_peak_gib() -> float | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return None if peak is None else peak / 2**30


def _random_dna(rng: np.random.Generator, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n, dtype=np.uint8)].tobytes().decode()


# -- phase 2: build ---------------------------------------------------------


def make_build_corpus(root: str, n_acc: int, bp: int, seed: int):
    """bench_build.py's shape: per accession, 300 bp reads sampled at ~4x
    coverage from a genome of bp/4 bases. Returns (fasta dir, inventory)."""
    from kwage.core import FilterInfo, str_to_accession
    from kwage.io.inventory import write_inventory

    rng = np.random.default_rng(seed)
    src = os.path.join(root, "fa")
    os.makedirs(src)
    lut = np.frombuffer(b"ACGT", np.uint8)
    read_len = 300
    accs = [f"SRR5{i:06d}" for i in range(n_acc)]
    for acc in accs:
        genome = lut[rng.integers(0, 4, size=max(bp // 4, read_len), dtype=np.uint8)]
        starts = rng.integers(0, genome.size - read_len + 1, size=bp // read_len)
        parts = []
        for r, st in enumerate(starts):
            parts += [b">r%d\n" % r, genome[st:st + read_len].tobytes(), b"\n"]
        with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
            f.write(b"".join(parts))
    inv = os.path.join(root, "inv.bin")
    write_inventory(inv, [FilterInfo(run_accession=str_to_accession(a)) for a in accs])
    return src, inv


def tree_digests(root: str, exts: tuple[str, ...]) -> dict[str, str]:
    """{relative path: sha256} of every file under root ending in exts."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            if name.endswith(exts):
                path = os.path.join(d, name)
                h = hashlib.sha256()
                with open(path, "rb") as f:
                    for block in iter(lambda: f.read(1 << 24), b""):
                        h.update(block)
                out[os.path.relpath(path, root)] = h.hexdigest()
    return out


def phase_build(work: str, n_acc: int, bp: int, seed: int) -> dict:
    """maestro with --device-build --device-transpose, then on the host:
    the .db and .bloom files must be identical.

    The device build counts k-mers exactly; the host reproduces the
    reference's 4-bit counting Bloom filter, which drops a k-mer whose
    four cells other k-mers already raised (at min.kmer.count 1 too). The
    two agree when that filter does not alias, so the counting filter is
    sized at 2^28 cells (--count-len.min 28), where aliasing among this
    corpus's ~10^5 k-mers per accession has a chance near 1e-11 per
    k-mer; the default sizing aims at a 1% four-probe false positive
    rate."""
    from kwage.cli.maestro import main as maestro_main

    src, inv = make_build_corpus(work, n_acc, bp, seed)
    digests, secs = {}, {}
    for name, flags in (("device", ["--device-build", "--device-transpose"]),
                        ("host", [])):
        scratch = os.path.join(work, f"build_{name}")
        argv = ["--meta", inv, "--scratch", scratch, "--source-dir", src,
                "--s3.no-write", "--min-kmer-count", "1", "--count-len.min", "28",
                "--save.bloom",
                "--status", os.path.join(scratch, "status.bin"), *flags]
        t0 = time.perf_counter()
        rc = maestro_main(argv)
        secs[name] = time.perf_counter() - t0
        check(rc == 0, f"maestro ({name}) exited {rc}")
        digests[name] = tree_digests(scratch, (".db", ".bloom"))
    n_db = sum(p.endswith(".db") for p in digests["host"])
    n_bloom = sum(p.endswith(".bloom") for p in digests["host"])
    check(n_bloom == n_acc and n_db > 0,
          f"host build made {n_bloom} .bloom / {n_db} .db for {n_acc} accessions")
    check(digests["device"] == digests["host"],
          "device-built .db/.bloom files differ from the host build")
    shutil.rmtree(os.path.join(work, "fa"))
    for name in digests:
        shutil.rmtree(os.path.join(work, f"build_{name}"))
    return {"accessions": n_acc, "db_files": n_db, "bloom_files": n_bloom,
            "device_s": secs["device"], "host_s": secs["host"],
            "sha256_identical": True}


# -- phase 3: search --------------------------------------------------------


def make_queries(n: int, lengths: tuple[int, int], seed: int) -> list[str]:
    rng = np.random.default_rng(seed + 1)
    return [_random_dna(rng, int(rng.integers(lengths[0], lengths[1] + 1)))
            for _ in range(n)]


def accession_of(file_index: int, column: int) -> str:
    return f"SRR{1_000_000 + file_index * 100_000 + column}"


def plan_plants(queries: list[str], spec: dict, seed: int):
    """Which filters each query is planted in, and how fully.

    The first half of the queries get all their k-mers planted in two
    filters each; the next quarter get 60% of their k-mers planted in one
    filter; the rest are not planted. Returns ({file: (rows, cols)}, the
    expected hit sets {threshold: {query index: set of accessions}})."""
    from kwage.core.hash import slice_indices
    from kwage.core.words import unique_canonical_kmers

    rng = np.random.default_rng(seed + 2)
    k, nh, log2_l = spec["kmer_len"], spec["num_hash"], spec["log2_filter_len"]
    nf, n_files = spec["num_filter"], spec["num_files"]
    n = len(queries)
    rows: dict[int, list] = {f: [] for f in range(n_files)}
    cols: dict[int, list] = {f: [] for f in range(n_files)}
    expect = {1.0: {}, 0.5: {}}
    for qi, q in enumerate(queries):
        if qi < n // 2:
            share, targets = 1.0, 2
        elif qi < 3 * n // 4:
            share, targets = 0.6, 1
        else:
            continue
        kmers = unique_canonical_kmers(q, k)
        if share < 1.0:
            kmers = rng.choice(kmers, size=int(round(share * kmers.size)), replace=False)
        r = slice_indices(kmers, k, nh, log2_l).reshape(-1).astype(np.int64)
        for _ in range(targets):
            f, c = int(rng.integers(n_files)), int(rng.integers(nf))
            rows[f].append(r)
            cols[f].append(np.full(r.size, c, np.int64))
            for t in expect:
                if share >= t:
                    expect[t].setdefault(qi, set()).add(accession_of(f, c))
    plants = {}
    for f in range(n_files):
        rr = np.concatenate(rows[f]) if rows[f] else np.empty(0, np.int64)
        cc = np.concatenate(cols[f]) if cols[f] else np.empty(0, np.int64)
        order = np.argsort(rr, kind="stable")
        plants[f] = (rr[order], cc[order])
    return plants, expect


def make_warehouse(root: str, spec: dict, plants: dict, seed: int) -> list[str]:
    """Write spec["num_files"] .db files with the repo's streaming writer.

    Background slice words are a & (b | c) of three uniform words, so
    37.5% of the bits are set; they are generated on the device in row
    chunks, and the planted (row, column) bits are OR-ed into each chunk
    on the host. The host never holds more than one chunk."""
    import jax
    import jax.numpy as jnp

    from kwage.core import FilterInfo, str_to_accession
    from kwage.core.params import BloomParam
    from kwage.io.db_file import write_db_file_streaming

    log2_l, nf = spec["log2_filter_len"], spec["num_filter"]
    n_rows, words = 1 << log2_l, nf // 32
    chunk = min(n_rows, 1 << 21)

    @jax.jit
    def background(key):
        a, b, c = jax.random.bits(key, (3, chunk, words), jnp.uint32)
        return a & (b | c)

    param = BloomParam(kmer_len=spec["kmer_len"], log_2_filter_len=log2_l,
                       num_hash=spec["num_hash"])
    os.makedirs(root)
    base = jax.random.key(seed)
    paths = []
    for f in range(spec["num_files"]):
        prow, pcol = plants[f]

        def chunks(f=f, prow=prow, pcol=pcol):
            for r0 in range(0, n_rows, chunk):
                key = jax.random.fold_in(jax.random.fold_in(base, f), r0)
                block = np.array(background(key)).view(np.uint8).reshape(chunk, nf // 8)
                lo, hi = np.searchsorted(prow, [r0, r0 + chunk])
                r, c = prow[lo:hi] - r0, pcol[lo:hi]
                np.bitwise_or.at(block, (r, c >> 3), (1 << (c & 7)).astype(np.uint8))
                yield block

        infos = [FilterInfo(run_accession=str_to_accession(accession_of(f, c)),
                            number_of_bases=1_000_000 + c)
                 for c in range(nf)]
        path = os.path.join(root, f"sra.{f}.db")
        write_db_file_streaming(path, param, chunks(), infos, nf)
        paths.append(path)
    return paths


def hits_by_query(output: str) -> dict[str, set[str]]:
    """{query defline: accessions hit} from kwage's JSON output."""
    doc = json.loads(output) if output.strip() else []
    if isinstance(doc, dict):
        doc = [doc]
    return {q["query"]: {r["sample_metadata"]["run"] for r in q["results"]}
            for q in doc}


def run_kwage(argv: list[str], out_path: str) -> str:
    from kwage.cli.kwage import main as kwage_main

    rc = kwage_main([*argv, "-o", out_path])
    check(rc == 0, f"kwage {' '.join(argv)} exited {rc}")
    with open(out_path) as f:
        return f.read()


def host_ram_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def phase_search(work: str, spec: dict, n_queries: int, lengths, seed: int) -> dict:
    """kwage --device vs the host engine at -t 1.0 and 0.5: byte-identical
    output, and exactly the planted hits."""
    spec = dict(spec)

    def corpus_bytes():
        return spec["num_files"] * (1 << spec["log2_filter_len"]) * spec["num_filter"] // 8

    # The device path holds the corpus on the host up to three times over
    # (file reads, fused matrix, page cache) while it uploads.
    reduced = None
    if 3 * corpus_bytes() + 8 * 2**30 > host_ram_bytes() and spec["log2_filter_len"] > 18:
        reduced = (f"L=2^{spec['log2_filter_len'] - 1}: host RAM "
                   f"{host_ram_bytes() / 2**30:.0f} GiB cannot hold 3x the "
                   f"{corpus_bytes() / 2**30:.0f} GiB L=2^{spec['log2_filter_len']} corpus")
        spec["log2_filter_len"] -= 1
        print(f"search: reduced to {reduced}", flush=True)
    corpus = corpus_bytes()
    queries = make_queries(n_queries, lengths, seed)
    plants, expect = plan_plants(queries, spec, seed)
    t0 = time.perf_counter()
    db_dir = os.path.join(work, "warehouse")
    paths = make_warehouse(db_dir, spec, plants, seed)
    t_make = time.perf_counter() - t0
    qfa = os.path.join(work, "q.fasta")
    with open(qfa, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")
    outs, secs = {}, {}
    for t in (1.0, 0.5):
        argv = ["-d", db_dir, "-i", qfa, "--o.json", "-t", str(t)]
        t0 = time.perf_counter()
        dev = run_kwage([*argv, "--device"], os.path.join(work, "dev.json"))
        secs[f"device_t{t}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = run_kwage(argv, os.path.join(work, "host.json"))
        secs[f"host_t{t}_s"] = time.perf_counter() - t0
        check(dev == host, f"kwage --device output differs from the host engine at -t {t}")
        got = hits_by_query(dev)
        want = {f"q{qi}": s for qi, s in expect[t].items()}
        check(got == want, f"-t {t}: hits {sorted(got)} differ from the planted {sorted(want)}")
        outs[t] = dev
    check(set(expect[0.5]) > set(expect[1.0]), "threshold 0.5 adds no hits over 1.0")
    return {"spec": spec, "reduced": reduced, "corpus_gib": corpus / 2**30,
            "paths": paths, "db_dir": db_dir, "queries": queries, "outputs": outs,
            "queries_hit": {str(t): len(expect[t]) for t in expect},
            "make_warehouse_s": t_make, **secs}


def summary(search: dict) -> dict:
    """phase_search's result without the bulk that later phases reuse."""
    return {k: v for k, v in search.items()
            if k not in ("paths", "db_dir", "queries", "outputs")}


# -- phase 4: serve ---------------------------------------------------------


def relabel(cli_output: str) -> str:
    """Batch output for deflines q<i> -> the server's labels for the same
    queries sent in order ("command line seq <i>")."""
    return re.sub(r'"query": "q(\d+)"', r'"query": "command line seq \1"', cli_output)


def time_search_kernels(db, param, queries: list[str], reps: int = 5) -> dict:
    """block_until_ready timings of the resident matrix's search kernels
    at the batch's own shape, and the slice-gather bytes they move."""
    import jax.numpy as jnp

    from kwage.ops.search import make_query_batch, search_complete, search_counts

    idx, valid, _ = make_query_batch(queries, param.kmer_len, param.num_hash,
                                     param.log_2_filter_len)
    idx_d, valid_d = jnp.asarray(idx), jnp.asarray(valid)
    gather = idx.size * db.shape[1] * 4
    out = {"shape": {"rows": db.shape[0], "words": db.shape[1],
                     "nq": idx.shape[0], "nk": idx.shape[1], "seeds": idx.shape[2]},
           "gather_bytes": gather}
    for name, fn in (("counts", search_counts), ("complete", search_complete)):
        ms, samples = _median_ms(fn, db, idx_d, valid_d, reps=reps)
        out[name] = {"ms": ms, "samples_ms": samples,
                     "gather_GB_per_s": gather / ms / 1e6,
                     "share_of_hbm_peak": gather / (ms / 1e3) / HBM_BYTES_PER_S}
    return out


def phase_serve(search: dict, time_kernels: bool = True) -> dict:
    """SearchServer (device engine) on the phase-3 files, in this process;
    each reply over loopback must equal the batch CLI output."""
    import jax

    from kwage.cli.kwage import find_db_files
    from kwage.search.resident import SearchServer

    files = find_db_files([search["db_dir"]])
    t0 = time.perf_counter()
    server = SearchServer(files, engine="device")
    t_load = time.perf_counter() - t0
    server.start()
    result = {"load_s": t_load, "requests": 0}
    try:
        with socket.create_connection(server.address, timeout=600) as s:
            stream = s.makefile("rwb")
            for t in (1.0, 0.5, 1.0, 0.5):
                req = {"queries": search["queries"], "threshold": t, "format": "json"}
                t0 = time.perf_counter()
                stream.write((json.dumps(req) + "\n").encode())
                stream.flush()
                reply = json.loads(stream.readline())
                result[f"request_{result['requests']}_t{t}_s"] = time.perf_counter() - t0
                result["requests"] += 1
                check(reply.get("ok") is True, f"server error: {reply.get('error')}")
                check(reply["output"] == relabel(search["outputs"][t]),
                      f"server reply at -t {t} differs from the batch CLI output")
        searcher = server.searcher
        if len(jax.devices()) > 1:
            shards = []
            for sdb, _ in searcher._groups:
                check(sdb.db is not None, "mesh group is not device-resident")
                shards.append(sorted(str(x.device) for x in sdb.db.addressable_shards))
            check(all(len(set(s)) == len(jax.devices()) for s in shards),
                  f"mesh shards do not land on distinct devices: {shards}")
            result["shard_devices"] = shards
        elif time_kernels:
            param, db, _ = searcher._groups[0]
            result["search_kernels"] = time_search_kernels(db, param, search["queries"])
    finally:
        server.shutdown()
    return result


# -- phase 5: sriracha ------------------------------------------------------


def make_sriracha_inputs(root: str, n_reads: int, read_len: int, seed: int,
                         panels: dict[int, tuple[int, int]]) -> tuple[str, dict]:
    """Subject panels {k: (subjects, bp each)} as FASTA files, and a read
    set in which 30% of the reads are drawn from the subjects (half of
    those reverse-complemented), the rest random."""
    rng = np.random.default_rng(seed + 3)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    subjects, paths = [], {}
    for k, (count, bp) in panels.items():
        path = os.path.join(root, f"subjects_k{k}.fasta")
        with open(path, "w") as f:
            for i in range(count):
                s = _random_dna(rng, bp)
                subjects.append(s)
                f.write(f">k{k}_subject_{i}\n{s}\n")
        paths[k] = path
    reads_path = os.path.join(root, "reads.fasta")
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(reads_path, "wb") as f:
        for r in range(n_reads):
            if rng.random() < 0.3:
                s = subjects[int(rng.integers(len(subjects)))]
                st = int(rng.integers(0, len(s) - read_len + 1))
                read = s[st:st + read_len].encode()
                if rng.random() < 0.5:
                    read = read.translate(comp)[::-1]
            else:
                read = lut[rng.integers(0, 4, size=read_len, dtype=np.uint8)].tobytes()
            f.write(b">read%d\n%s\n" % (r, read))
    return reads_path, paths


def sriracha_formulation(subject_path: str, k: int) -> str:
    """Which intersection the device path picks for this panel."""
    from kwage.sriracha.device import uses_dense_table
    from kwage.sriracha.engine import load_subject_kmers

    table = uses_dense_table(load_subject_kmers([subject_path], k, 0), k)
    return "table" if table else "hash"


def phase_sriracha(work: str, n_reads: int, read_len: int, seed: int,
                   panels: dict[int, tuple[int, int]], expect: dict[int, str]) -> dict:
    """sriracha --device vs the host path, per panel: identical TSVs."""
    from kwage.cli.sriracha import main as sriracha_main

    reads, subject_paths = make_sriracha_inputs(work, n_reads, read_len, seed, panels)
    result = {"reads": n_reads, "read_len": read_len}
    for k, subj in subject_paths.items():
        form = sriracha_formulation(subj, k)
        check(form == expect[k], f"k={k} panel takes the {form} path, not {expect[k]}")
        outs = {}
        for mode in ("device", "host"):
            out = os.path.join(work, f"sriracha_k{k}_{mode}.tsv")
            argv = ["-i", subj, "-k", str(k), "-o", out, reads]
            if mode == "device":
                argv.insert(0, "--device")
            t0 = time.perf_counter()
            rc = sriracha_main(argv)
            result[f"k{k}_{mode}_s"] = time.perf_counter() - t0
            check(rc == 0, f"sriracha ({mode}, k={k}) exited {rc}")
            with open(out) as f:
                outs[mode] = f.read()
        check(outs["device"] == outs["host"], f"sriracha --device TSV differs at k={k}")
        rows = outs["host"].count("\n") - 1
        check(rows > 0, f"sriracha k={k} found nothing")
        result[f"k{k}"] = {"formulation": form, "tsv_lines": rows + 1}
    return result


# -- phase 6: kernels -------------------------------------------------------


def _median_ms(fn, *args, reps: int = 5) -> tuple[float, list[float]]:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2], ts


def phase_kernels(num_filter: int = 2048, log2_bits: int = 20,
                  log2_image: int = 26, batch: int = 16) -> dict:
    """The device transpose at num_filter x 2^log2_bits bits beside the
    native host one (each checked against the other), and the batched
    filter scatter + pack at L=log2_image."""
    import jax
    import jax.numpy as jnp

    from kwage.native import transpose_bits_native
    from kwage.ops.counting import set_filter_bits_multi
    from kwage.ops.transpose import transpose_bits_device

    out = {}
    bits = 1 << log2_bits
    words = jax.random.bits(jax.random.key(1), (num_filter, bits // 32), jnp.uint32)
    as_bytes = jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(num_filter, bits // 8)
    ms, samples = _median_ms(lambda b: transpose_bits_device(b, num_filter), as_bytes)
    mem = transpose_bits_device.lower(as_bytes, num_filter).compile().memory_analysis()
    got = np.asarray(transpose_bits_device(as_bytes, num_filter))
    host_in = np.asarray(as_bytes)
    want = np.packbits(np.unpackbits(host_in, axis=1, bitorder="little").T,
                       axis=1, bitorder="little") if num_filter * bits <= 1 << 26 else None
    check(want is None or np.array_equal(got, want),
          "device transpose differs from the numpy oracle")
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        native = transpose_bits_native(host_in, num_filter)
        host.append((time.perf_counter() - t0) * 1e3)
    check(np.array_equal(native, got), "device transpose differs from the native one")
    nbytes = num_filter * bits // 8
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    out["transpose"] = {
        "filters": num_filter, "bits": bits, "bytes": nbytes,
        "copy_bound_ms": bound_ms, "device_ms": ms, "device_samples_ms": samples,
        "device_share_of_copy_bound": bound_ms / ms,
        "device_temp_bytes": mem.temp_size_in_bytes,
        "host_native_ms": min(host)}
    del words, as_bytes

    n = 1 << 23
    keys = jax.random.split(jax.random.key(2), 4)
    hi = jax.random.bits(keys[0], (n,), jnp.uint32) & jnp.uint32(0x3FFFFFFF)
    lo = jax.random.bits(keys[1], (n,), jnp.uint32)
    acc = jnp.sort(jax.random.randint(keys[2], (n,), 0, batch).astype(jnp.uint32))
    sel = jax.random.bits(keys[3], (n,), jnp.uint8) < 128
    slot = jnp.arange(batch + 1, dtype=jnp.int32).at[batch].set(-1)
    static = dict(k=31, num_hash=5, log2_filter_len=log2_image, num_acc=batch, compact=0)
    mem = set_filter_bits_multi.lower(acc, hi, lo, sel, slot, **static).compile().memory_analysis()
    ms, samples = _median_ms(lambda *a: set_filter_bits_multi(*a, **static),
                             acc, hi, lo, sel, slot, reps=3)
    out["set_filter_bits_multi"] = {
        "log2_filter_len": log2_image, "batch": batch, "words_in": n,
        "ms": ms, "samples_ms": samples,
        "temp_bytes": mem.temp_size_in_bytes,
        "argument_bytes": mem.argument_size_in_bytes,
        "output_bytes": mem.output_size_in_bytes}
    return out


# -- main -------------------------------------------------------------------


def run_one(work: str, seed: int) -> None:
    walls = {}
    t0 = time.perf_counter()
    say("build", **phase_build(work, BUILD_ACCESSIONS, BUILD_BP, seed))
    walls["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    search = phase_search(work, WAREHOUSE, NUM_QUERIES, QUERY_LEN, seed)
    walls["search"] = time.perf_counter() - t0
    say("search", **summary(search), peak_host_rss_gib=_peak_rss_gib(), device_peak_gib=_device_peak_gib())

    t0 = time.perf_counter()
    serve = phase_serve(search)
    walls["serve"] = time.perf_counter() - t0
    kernels = {"search_kernels": serve.pop("search_kernels")}
    say("serve", **serve, device_peak_gib=_device_peak_gib())
    shutil.rmtree(search["db_dir"])

    t0 = time.perf_counter()
    say("sriracha", **phase_sriracha(
        work, NUM_READS, READ_LEN, seed, {21: (8, 3000), 11: (32, 4000)},
        {21: "hash", 11: "table"}))
    walls["sriracha"] = time.perf_counter() - t0

    kernels.update(phase_kernels())
    say("kernels", wall_s=walls, **kernels)


def run_four(work: str, seed: int) -> None:
    from __graft_entry__ import dryrun_multichip

    search = phase_search(work, WAREHOUSE, NUM_QUERIES, QUERY_LEN, seed)
    say("search_mesh", **summary(search), peak_host_rss_gib=_peak_rss_gib())
    say("serve_mesh", **phase_serve(search))
    shutil.rmtree(search["db_dir"])
    say("sriracha_data_mesh", **phase_sriracha(
        work, NUM_READS, READ_LEN, seed, {21: (8, 3000), 11: (32, 4000)},
        {21: "hash", 11: "table"}))
    t0 = time.perf_counter()
    dryrun_multichip(4)
    say("dryrun_multichip", devices=4, ok=True, s=time.perf_counter() - t0)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    want = 4 if args.four else 1
    if not args.four:
        # One card: the CLIs would shard over every visible device.
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    import jax

    from kwage.utils.runtime import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    print(f"devices: {devices}", flush=True)
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    print(f"card: {card()}", flush=True)
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform})", file=sys.stderr)
        return 1
    if len(devices) != want:
        print(f"chip_smoke: needs {want} GPU(s), JAX sees {len(devices)}",
              file=sys.stderr)
        return 1

    work = tempfile.mkdtemp(prefix="chip_smoke.")
    try:
        (run_four if args.four else run_one)(work, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
