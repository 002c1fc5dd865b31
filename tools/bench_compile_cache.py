"""Cold vs cached start of a second process (the compile-tax model).

A device process compiles its kernels the first time each shape runs.
With JAX's persistent compilation cache at a fixed path, a second
process with the same shapes finds them compiled. This tool runs the
same child twice with one shared cache directory (given to the child as
JAX_COMPILATION_CACHE_DIR, which the repo's CLIs and benches honor) and
records time-to-first-result for the build + search kernel set
(count_kmers_device_multi, set_filter_bits_multi, search_files_device's
counts/complete kernels), on whatever backend JAX finds.

Usage: python tools/bench_compile_cache.py [cache_dir]
Prints JSON lines; writes results/COMPILECACHE.json under the checkout.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"]
    if os.environ.get("PYTHONPATH") else "")

from results import write_results  # noqa: E402

# The child compiles the real kernel set on small-but-real shapes,
# reporting seconds-to-first-result per kernel.
_CHILD = """
import json, os, sys, time
import jax
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
import numpy as np

from kwage.core import FilterInfo
from kwage.io.bloom_file import read_bloom_file, write_bloom_file
from kwage.pipeline import BuildOptions, build_db_from_bloom_files
from kwage.pipeline.make_bloom import build_blooms_device_batch
from kwage.ops.search import search_files_device

work = sys.argv[2]
t_start = time.time()
out = {}

opts = BuildOptions(kmer_len=31, min_kmer_count=1,
                    false_positive_probability=0.25,
                    min_log_2_filter_len=14, max_log_2_filter_len=16,
                    min_log_2_count_len=18, max_log_2_count_len=20)
rng = np.random.default_rng(0)
jobs = []
for a in range(4):
    seqs = ["".join(rng.choice(list("ACGT"), size=150)) for _ in range(6)]
    jobs.append((seqs, FilterInfo()))

# Device BUILD kernel set (count + nv readback + scatter), exactly as
# maestro --device-build dispatches it.
t0 = time.time()
recs = build_blooms_device_batch(jobs, opts)
out["device_build_batch_s"] = round(time.time() - t0, 3)

paths = []
for i, r in enumerate(recs):
    p = os.path.join(work, f"a{i}.bloom")
    write_bloom_file(p, r)
    paths.append(p)
db = os.path.join(work, "a.db")
build_db_from_bloom_files(db, recs[0].param, paths)

# Device SEARCH kernel set: complete-match (threshold 1.0) and
# counting (fractional threshold) paths.
queries = [(i, "".join(rng.choice(list("ACGT"), 100))) for i in range(4)]
t0 = time.time()
search_files_device([db], queries, 1.0)
out["search_complete_s"] = round(time.time() - t0, 3)
t0 = time.time()
search_files_device([db], queries, 0.5)
out["search_counts_s"] = round(time.time() - t0, 3)

out["total_s"] = round(time.time() - t_start, 3)
print("RESULT " + json.dumps(out))
"""


def run_child(cache_dir):
    work = tempfile.mkdtemp(prefix="cc_work_")
    t0 = time.time()
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache_dir)
    r = subprocess.run([sys.executable, "-c", _CHILD, cache_dir, work],
                       capture_output=True, text=True, timeout=1800, env=env)
    shutil.rmtree(work, ignore_errors=True)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"child failed: {r.stderr[-4000:]}")
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            out = json.loads(line[len("RESULT "):])
            out["process_wall_s"] = round(wall, 2)
            return out
    raise RuntimeError(f"no RESULT line: {r.stdout[-2000:]}")


def _backend() -> str:
    """The children's platform, asked of a short child of its own: this
    parent never opens the card, which each child needs whole."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices()[0]; print(d.platform, d.device_kind)"],
        capture_output=True, text=True, timeout=600)
    return r.stdout.strip()


def main():
    cache = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="jaxcache_")
    shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache, exist_ok=True)

    cold = run_child(cache)
    n_entries = len(os.listdir(cache))
    cached = run_child(cache)
    result = {
        "backend": _backend(),
        "cold": cold, "cached": cached,
        "cache_entries": n_entries,
        "kernel_speedup": round(cold["total_s"] / cached["total_s"], 1)
        if cached["total_s"] > 0 else None,
    }
    print(json.dumps({"phase": "compile_cache", **result}), flush=True)
    ok = cached["total_s"] < cold["total_s"] / 2 and n_entries > 0
    write_results("COMPILECACHE.json", result)
    print(json.dumps({"phase": "done", "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
