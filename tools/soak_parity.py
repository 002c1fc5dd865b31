"""Randomized oracle soak: host/device/reference equality over random
corpora and parameters.

Usage: python tools/soak_parity.py [rounds] [seed_base]  (requires /tmp/oracle/kwage,
recipe in tests/golden/README.md). Each round samples k in {11..32},
L ranges, false-positive targets, min_kmer_count, thresholds and output
formats; builds a corpus; and byte-compares the reference binary against
our host and device search paths. For min_kmer_count > 1 the exact device
builder may legitimately find zero abundant k-mers where the reference's
counting filter promoted collisions -- that divergence is by design
(bloom_test measures it) and is not a failure.
"""
import numpy as np, subprocess, sys, os, tempfile, shutil

# Runnable straight from a checkout, with or without `pip install -e .`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kwage.core import FilterInfo, str_to_accession
from kwage.io.bloom_file import write_bloom_file
from kwage.io.sequence import iter_sequences
from kwage.pipeline import (BuildOptions, build_bloom_from_file,
                                build_bloom_device, build_db_from_bloom_files)
from kwage.cli.kwage import main as kwage_main

ORACLE="/tmp/oracle/kwage"
fails = 0
rounds = int(sys.argv[1]) if len(sys.argv)>1 else 5
base = int(sys.argv[2]) if len(sys.argv)>2 else 1000
for seed in range(base, base+rounds):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([11, 19, 23, 27, 31, 32]))
    minL = int(rng.integers(10, 14)); maxL = int(rng.integers(16, 21))
    fp = float(rng.choice([0.05, 0.25, 0.5]))
    mc = int(rng.choice([1, 1, 2]))
    work = tempfile.mkdtemp(prefix="soak_")  # no "." -- a ".db"-bearing dirname hides databases from BOTH engines (mirrored reference quirk)
    try:
        opts = BuildOptions(kmer_len=k, min_kmer_count=mc, false_positive_probability=fp,
                            min_log_2_filter_len=minL, max_log_2_filter_len=maxL,
                            min_log_2_count_len=12, max_log_2_count_len=maxL)
        groups = {}
        seqs = {}
        for i in range(int(rng.integers(2, 7))):
            acc = f"SRR{seed}{i:02d}"
            # genome-sampled reads (duplication for mc=2) + Ns
            glen = int(rng.integers(300, 3000))
            g = "".join(rng.choice(list("ACGTN"), p=[.245,.245,.245,.245,.02], size=glen))
            nreads = int(rng.integers(1, 12))
            parts = []
            for _ in range(nreads):
                st = int(rng.integers(0, max(1, glen-150)))
                parts.append(g[st:st+int(rng.integers(40, 150))])
            seqs[acc] = g
            fa = os.path.join(work, f"{acc}.fasta")
            with open(fa, "w") as f:
                for j, p in enumerate(parts):
                    f.write(f">r{j}\n{p}\n")
            try:
                rec = build_bloom_from_file(fa, opts, FilterInfo(run_accession=str_to_accession(acc)))
            except Exception:
                continue  # e.g. all reads shorter than k
            # The device builder is EXACT; the host path carries the
            # reference's counting-filter approximation (which can both
            # over-promote and, under aliasing, suppress -- even at
            # min_count=1 with small counting filters). So validate the
            # device filter against exact ground truth, not the host path.
            try:
                dev = build_bloom_device((q for _, q in iter_sequences(fa)), opts,
                                         FilterInfo(run_accession=str_to_accession(acc)))
            except Exception:
                dev = None  # exact count may legitimately be zero
            if dev is not None:
                from collections import Counter
                from kwage.core.words import canonical_kmers
                from kwage.native import murmur32_native
                cnt = Counter()
                for _, q in iter_sequences(fa):
                    cnt.update(canonical_kmers(q, k).tolist())
                words = np.array(sorted(w for w, c in cnt.items() if c >= mc), dtype=np.uint64)
                gt = np.zeros(dev.param.filter_len // 8, dtype=np.uint8)
                if words.size:
                    h = murmur32_native(words, k, dev.param.num_hash)
                    idx = (h & np.uint32(dev.param.filter_len - 1)).reshape(-1).astype(np.uint64)
                    np.bitwise_or.at(gt, (idx >> 3).astype(np.int64),
                                     np.uint8(1) << (idx & 7).astype(np.uint8))
                if dev.bits.tobytes() != gt.tobytes():
                    print(f"SEED {seed}: device filter != exact ground truth acc={acc} k={k}")
                    fails += 1
            bl = os.path.join(work, f"{acc}.bloom")
            write_bloom_file(bl, rec)
            groups.setdefault(rec.param, []).append(bl)
        dbs = []
        for gi, (param, paths) in enumerate(sorted(groups.items())):
            db = os.path.join(work, f"sra.{gi}.db")
            build_db_from_bloom_files(db, param, paths)
            dbs.append(db)
        if not dbs:
            continue
        qf = os.path.join(work, "q.fasta")
        with open(qf, "w") as f:
            for i, (acc, g) in enumerate(list(seqs.items())[:3]):
                st = int(rng.integers(0, max(1, len(g)-100)))
                f.write(f">q{i}\n{g[st:st+90]}\n")
        t = float(rng.choice([1, 0.9, 0.5, 0.2]))
        fmt = str(rng.choice(["o.json", "o.csv"]))
        dargs = []
        for d in dbs: dargs += ["-d", d]
        base = dargs + ["-i", qf, "-t", str(t), f"--{fmt}"]
        o = os.path.join(work, "o.out"); m = os.path.join(work, "m.out"); dv = os.path.join(work, "d.out")
        # The oracle can exit 0 WITHOUT output under box load: a failed
        # FindFiles walk makes subject_files empty, options.cpp:144 sets
        # quit, and main returns EXIT_SUCCESS with only a stderr line.
        # Retry once with diagnostics so load flakes don't masquerade as
        # parity failures (2000-round run of 2026-08-18 hit this 3x).
        for attempt in range(2):
            proc = subprocess.run([ORACLE] + base + ["-o", o], check=True,
                                  capture_output=True)
            if os.path.exists(o):
                break
            # check=True already raised on nonzero: rc here is always 0.
            print(f"SEED {seed}: oracle wrote no output (attempt {attempt}); "
                  f"stderr={proc.stderr[-300:]!r} "
                  f"dir={sorted(os.listdir(work))}", flush=True)
            import time as _time
            _time.sleep(1.0)
        else:
            raise RuntimeError("oracle produced no output after retry")
        assert kwage_main(base + ["-o", m]) == 0
        assert kwage_main(base + ["-o", dv, "--device"]) == 0
        if open(o,"rb").read() != open(m,"rb").read():
            print(f"SEED {seed}: HOST mismatch k={k} t={t} {fmt}"); fails += 1
        if open(o,"rb").read() != open(dv,"rb").read():
            print(f"SEED {seed}: DEVICE mismatch k={k} t={t} {fmt}"); fails += 1
    except Exception as e:
        print(f"SEED {seed}: round error: {type(e).__name__}: {e}", flush=True)
        fails += 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
print(f"soak complete: {rounds} rounds, {fails} failures")
