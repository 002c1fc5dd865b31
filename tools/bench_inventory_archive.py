"""Archive-scale sra_inventory proof (VERDICT r04 task 8).

Generates a synthetic NCBI SRA metadata archive with >=1M run records
(structured like ftp.ncbi.nlm.nih.gov/sra/reports/Metadata: one
SRA_Accessions tab member + per-submission experiment/sample/study XML
members; reference consumer: sra_inventory.cpp:736-775), then measures:

  - our native build (kn_build_inventory, kwage_native.cpp:1207) --
    wall time, records/s, peak RSS of the building process;
  - the reference sra_inventory binary (/tmp/oracle/sra_inventory, MPI
    stub build per tests/golden/README.md) on the same archive;
  - record-set parity: both binary inventories decoded and compared as
    sorted per-record blob sets (the reference's equal-bases tie order
    is unstable __gnu_parallel::sort -- SETS must be identical, byte
    order may differ).

With >100k XML records the native path's overflow merge (kMaxNumXml,
mirroring the reference MAX_NUM_XML) is exercised many times over; the
RSS numbers demonstrate it bounds the annotation map. RSS is reported
as a DELTA over an import-only probe child, so that the interpreter's
own baseline does not count.

Env knobs: INV_N_RECORDS (default 1_000_000), INV_SEED (default 5),
INV_SUB_SIZE (runs per submission dir, default 1000), INV_SKIP_ORACLE,
INV_SKIP_PARITY. Usage: python tools/bench_inventory_archive.py
[workdir]. Prints one JSON line per phase; the last is {"phase":
"done", "ok": true} on success.
"""

import hashlib
import io
import json
import os
import random
import resource
import struct
import subprocess
import sys
import tarfile
import tempfile
import time

from results import write_results

N_RECORDS = int(os.environ.get("INV_N_RECORDS", "1000000"))
SEED = int(os.environ.get("INV_SEED", "5"))
SUB_SIZE = int(os.environ.get("INV_SUB_SIZE", "1000"))

HEADER = "\t".join(
    ["Accession", "Submission", "Status", "Updated", "Published",
     "Received", "Type", "Center", "Visibility", "Alias", "Experiment",
     "Sample", "Study", "Loaded", "Spots", "Bases"])

STRATEGIES = ["WGS", "RNA-Seq", "AMPLICON", "WXS"]
SOURCES = ["GENOMIC", "TRANSCRIPTOMIC", "METAGENOMIC"]
CENTERS = ["LANL", "JGI", "BROAD", "-"]


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def make_archive(path: str, n_records: int, seed: int, sub_size: int):
    """Synthetic metadata tar.gz: n_records RUN rows (each with its own
    EXPERIMENT; samples shared by run pairs, ~n/2 SAMPLE XMLs), grouped
    into ceil(n/sub_size) submission directories."""
    rng = random.Random(seed)
    t0 = time.time()
    raw_bytes = 0
    with tarfile.open(path, "w:gz", compresslevel=1) as tf:

        def add(name, text):
            nonlocal raw_bytes
            b = text.encode()
            raw_bytes += len(b)
            ti = tarfile.TarInfo(name)
            ti.size = len(b)
            tf.addfile(ti, io.BytesIO(b))

        all_rows = [HEADER]
        n_subs = (n_records + sub_size - 1) // sub_size
        for sub in range(n_subs):
            lo = sub * sub_size
            hi = min(lo + sub_size, n_records)
            subname = f"SUB{sub:06d}"
            exps, samps = [], []
            for i in range(lo, hi):
                samp = f"SRS{i // 2:08d}"
                status = "live" if i % 11 else "suppressed"
                spots = str((i % 9973) * 10) if i % 13 else "-"
                bases = str((i % 7919) * 1000) if i % 17 else "-"
                all_rows.append("\t".join(
                    [f"SRR{i:08d}", subname, status, "2020-01-01",
                     "2020-01-02",
                     f"20{10 + i % 12}-{1 + i % 12:02d}-03T01:02:03Z",
                     "RUN", CENTERS[i % 4], "public", "-",
                     f"SRX{i:08d}", samp, f"SRP{sub:06d}", "1",
                     spots, bases]))
                exps.append(
                    f'<EXPERIMENT accession="SRX{i:08d}" alias="e{i}">\n'
                    f"<TITLE>Synthetic experiment {i}</TITLE>\n"
                    f"<LIBRARY_STRATEGY>{STRATEGIES[i % 4]}"
                    "</LIBRARY_STRATEGY>\n"
                    f"<LIBRARY_SOURCE>{SOURCES[i % 3]}</LIBRARY_SOURCE>\n"
                    "</EXPERIMENT>")
                if i % 2 == 0:
                    samps.append(
                        f'<SAMPLE accession="{samp}" alias="s{i}">\n'
                        f"<SCIENTIFIC_NAME>Taxon {i % 5000}"
                        "</SCIENTIFIC_NAME>\n"
                        "<SAMPLE_ATTRIBUTE>\n<TAG>env</TAG>\n"
                        f"<VALUE>site {rng.randrange(1000)}</VALUE>\n"
                        "</SAMPLE_ATTRIBUTE>\n</SAMPLE>")
            add(f"{subname}/{subname}.experiment.xml",
                "<EXPERIMENT_SET>\n" + "\n".join(exps)
                + "\n</EXPERIMENT_SET>\n")
            if samps:
                add(f"{subname}/{subname}.sample.xml",
                    "<SAMPLE_SET>\n" + "\n".join(samps)
                    + "\n</SAMPLE_SET>\n")
            add(f"{subname}/{subname}.study.xml",
                "<STUDY_SET>\n"
                f'<STUDY accession="SRP{sub:06d}" alias="p">\n'
                f"<STUDY_TITLE>Study {sub}</STUDY_TITLE>\n</STUDY>\n"
                "</STUDY_SET>\n")
        # The run table LAST, named exactly "SRA_Accessions" (the
        # reference requires the member to END with that string --
        # io/tar.py mirrors it).
        add("SRA_Accessions", "\n".join(all_rows) + "\n")
    return time.time() - t0, raw_bytes, os.path.getsize(path)


_CHILD_RSS_PROBE = """
import resource, sys
sys.stdout.write(str(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss))
"""

_CHILD_BUILD = """
import resource, sys, time, json
from kwage.pipeline.inventory import build_inventory
t0 = time.time()
n = build_inventory(sys.argv[1], sys.argv[2], verbose=False)
dt = time.time() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"n": n, "dt": dt, "maxrss_kb": rss}))
"""


def run_child_build(archive, out):
    r = subprocess.run([sys.executable, "-c", _CHILD_BUILD, archive, out],
                       capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"native build child failed: {r.stderr[-3000:]}")
    return json.loads(r.stdout.splitlines()[-1])


def baseline_rss_kb():
    r = subprocess.run([sys.executable, "-c", _CHILD_RSS_PROBE],
                       capture_output=True, text=True, timeout=600)
    return int(r.stdout.strip())


def record_blob_set_sha(path, reader_mod):
    """Decode every FilterInfo, re-encode canonically, sha256 over the
    SORTED blob multiset. Two layers of unspecified order are erased:
    record tie order (the reference's equal-bases sort is unstable) and
    per-record sample_attributes order (the reference serializes a
    std::unordered_map -- bucket iteration order is incidental)."""
    blobs = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        r = reader_mod.BinaryReader(f)
        w_buf = io.BytesIO()
        w = reader_mod.BinaryWriter(w_buf)
        for _ in range(n):
            info = r.filter_info()
            info.sample_attributes = dict(
                sorted(dict(info.sample_attributes).items()))
            w_buf.seek(0)
            w_buf.truncate()
            w.filter_info(info)
            blobs.append(w_buf.getvalue())
    blobs.sort()
    h = hashlib.sha256()
    for b in blobs:
        h.update(struct.pack("<I", len(b)))
        h.update(b)
    return len(blobs), h.hexdigest()


def main():
    work = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="inv_archive_")
    os.makedirs(work, exist_ok=True)
    archive = os.path.join(work, "NCBI_SRA_Metadata.tar.gz")

    dt_gen, raw, gz = make_archive(archive, N_RECORDS, SEED, SUB_SIZE)
    emit("generate", n_records=N_RECORDS, seconds=round(dt_gen, 2),
         raw_mb=round(raw / 1e6, 1), gz_mb=round(gz / 1e6, 1))

    base_kb = baseline_rss_kb()
    ours = os.path.join(work, "ours.inv")
    res = run_child_build(archive, ours)
    n_live = res["n"]
    emit("native_build", n_written=n_live, seconds=round(res["dt"], 2),
         records_per_s=round(N_RECORDS / res["dt"], 1),
         raw_mb_per_s=round(raw / 1e6 / res["dt"], 1),
         maxrss_mb=round(res["maxrss_kb"] / 1024, 1),
         baseline_rss_mb=round(base_kb / 1024, 1),
         delta_rss_mb=round((res["maxrss_kb"] - base_kb) / 1024, 1))

    oracle = "/tmp/oracle/sra_inventory"
    result = {"n_records": N_RECORDS, "native_s": round(res["dt"], 2),
              "native_records_per_s": round(N_RECORDS / res["dt"], 1),
              "native_delta_rss_mb":
                  round((res["maxrss_kb"] - base_kb) / 1024, 1)}
    if os.path.exists(oracle) and not os.environ.get("INV_SKIP_ORACLE"):
        theirs = os.path.join(work, "oracle.inv")
        t0 = time.time()
        # Run via a forking wrapper so the oracle's OWN peak RSS is
        # readable (RUSAGE_CHILDREN in this process would report the
        # max over ALL children, including the earlier build child).
        wrap = ("import resource,subprocess,sys;"
                "rc=subprocess.call(sys.argv[1:]);"
                "print('RSSKB',resource.getrusage("
                "resource.RUSAGE_CHILDREN).ru_maxrss);sys.exit(rc)")
        r = subprocess.run(
            [sys.executable, "-S", "-c", wrap, oracle, "-i", archive,
             "-o", theirs],
            capture_output=True, text=True, timeout=7200)
        dt_o = time.time() - t0
        ok = r.returncode == 0
        o_rss_kb = 0
        for ln in r.stdout.splitlines():
            if ln.startswith("RSSKB"):
                o_rss_kb = int(ln.split()[1])
        emit("oracle_build", rc=r.returncode, seconds=round(dt_o, 2),
             records_per_s=round(N_RECORDS / dt_o, 1),
             maxrss_mb=round(o_rss_kb / 1024, 1),
             speedup_vs_oracle=round(dt_o / res["dt"], 2))
        result.update(oracle_s=round(dt_o, 2),
                      oracle_maxrss_mb=round(o_rss_kb / 1024, 1),
                      speedup_vs_oracle=round(dt_o / res["dt"], 2))
        if ok and not os.environ.get("INV_SKIP_PARITY"):
            from kwage.io import binary as reader_mod
            t0 = time.time()
            n_a, sha_a = record_blob_set_sha(ours, reader_mod)
            n_b, sha_b = record_blob_set_sha(theirs, reader_mod)
            emit("parity", ours=n_a, oracle=n_b,
                 record_sets_identical=(sha_a == sha_b),
                 seconds=round(time.time() - t0, 2))
            result["record_sets_identical"] = (sha_a == sha_b)
            if sha_a != sha_b or n_a != n_b:
                emit("done", ok=False)
                return 1
    if N_RECORDS >= 1000000:
        write_results("INVENTORY.json", result)
    emit("done", ok=True, n_live=n_live)
    return 0


if __name__ == "__main__":
    sys.exit(main())
