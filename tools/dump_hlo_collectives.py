"""Make the scaling claim checkable: dump the compiled HLO of the n=8
sharded search and record its collective inventory (ops + bytes).

The design argument for >=80% weak scaling is "no hot-path collective":
the per-query hit matrix is naturally sharded (query axis follows
"data", packed-filter axis follows "filters"), so the search programs
should contain NO inter-device collectives at all -- the global result
is just the concatenation of shard outputs -- and only the optional
corpus-total reduction (sharded_total_hits) should lower to one small
all-reduce (the psum over "filters"). This tool compiles all three
programs on an 8-device virtual CPU mesh, greps the HLO for collective
ops, computes their payload bytes from the result shapes, and appends a
2-process x 4-virtual-device jax.distributed weak-scaling point so the
DCN boundary is inside a real measurement. Writes results/SCALING.json.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""
)

from results import write_results  # noqa: E402

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

_DTYPE_BYTES = {"pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "bf16": 2,
                "f16": 2, "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8,
                "f64": 8}
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")
_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|collective-permute|all-to-all)"
    r"[.( ]")


def collective_inventory(hlo_text: str) -> list[dict]:
    out = []
    for m in _RE.finditer(hlo_text):
        dtype, dims, op = m.groups()
        shape = [int(d) for d in dims.split(",") if d] if dims else []
        nbytes = _DTYPE_BYTES.get(dtype, 4)
        for d in shape:
            nbytes *= d
        out.append({"op": op, "shape": f"{dtype}[{dims}]", "bytes": nbytes})
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kwage.ops.search import complete_kernel, counts_kernel
    from kwage.parallel.sharded_search import (
        _sharded,
        _total_hits_kernel,
    )

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "filters"))

    # Representative shapes (the production regime scaled down: bytes
    # scale linearly with L/W/nq, the OP LIST does not).
    L, W, NQ, NK, NH = 1 << 16, 64 * 4, 8, 128, 5
    rng = np.random.default_rng(0)
    db = jax.device_put(
        rng.integers(0, 1 << 32, size=(L, W), dtype=np.uint32),
        NamedSharding(mesh, P(None, "filters")))
    idx = jax.device_put(
        rng.integers(0, L, size=(NQ, NK, NH), dtype=np.int32),
        NamedSharding(mesh, P("data", None, None)))
    valid = jax.device_put(
        np.ones((NQ, NK), dtype=bool),
        NamedSharding(mesh, P("data", None)))

    report: dict = {"devices": 8, "mesh": "2 data x 4 filters",
                    "shapes": {"db": list(db.shape), "idx": list(idx.shape)}}
    programs = {
        "search_counts": (_sharded(counts_kernel, mesh), (db, idx, valid)),
        "search_complete": (_sharded(complete_kernel, mesh), (db, idx, valid)),
    }
    for name, (fn, args) in programs.items():
        txt = fn.lower(*args).compile().as_text()
        report[name] = {"collectives": collective_inventory(txt)}

    # total_hits: jit(shard_map(psum(...))) like sharded_total_hits.
    thr = jax.device_put(np.full(NQ, 3, dtype=np.int32),
                         NamedSharding(mesh, P("data")))
    fn = jax.jit(jax.shard_map(
        _total_hits_kernel, mesh=mesh,
        in_specs=(P(None, "filters"), P("data", None, None), P("data", None),
                  P("data")),
        out_specs=P("data"),
    ))
    txt = fn.lower(db, idx, valid, thr).compile().as_text()
    report["total_hits"] = {"collectives": collective_inventory(txt)}

    # Claim check: the hit-matrix programs carry ZERO collectives; the
    # corpus-total reduction carries exactly its psum.
    report["claim_ok"] = (
        not report["search_counts"]["collectives"]
        and not report["search_complete"]["collectives"]
        and any(c["op"] == "all-reduce"
                for c in report["total_hits"]["collectives"])
    )

    # jax.distributed weak-scaling points: the DCN (gloo) boundary sits
    # inside the measured program. Two process/device splits of the same
    # 8-device global mesh bracket the boundary -- 2x4 (one gloo hop)
    # and 4x2 (three process boundaries inside every cross-process
    # collective).
    def weak_point(nproc: int, ndev: int, port: int):
        env_common = dict(os.environ)
        env_common.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES=str(nproc),
            SCALING_LOG2_L="16", SCALING_W_PER_DEV="64",
            SCALING_NQ="4", SCALING_NK="128",
        )
        procs = []
        for pid in range(nproc):
            env = dict(env_common)
            env["JAX_PROCESS_ID"] = str(pid)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(_REPO_ROOT, "bench_scaling.py")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True))
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        rcs = [p.returncode for p in procs]
        line = next((l for o in outs for l in o.splitlines()
                     if l.startswith("{")), None)
        return {"process_rcs": rcs,
                "point": json.loads(line) if line else None,
                "note": (f"{nproc} gloo processes x {ndev} virtual CPU "
                         "devices on ONE core: validates the cross-process "
                         "collective path, not absolute throughput")}

    if os.environ.get("SKIP_DISTRIBUTED") != "1":
        report["weak_scaling_2proc_x4dev"] = weak_point(2, 4, 8476)
        report["weak_scaling_4proc_x2dev"] = weak_point(4, 2, 8477)
    weak = report.get("weak_scaling_2proc_x4dev")

    out_path = write_results("SCALING.json", report)
    print(json.dumps({"claim_ok": report["claim_ok"],
                      "out": out_path,
                      "total_hits_collectives":
                          report["total_hits"]["collectives"],
                      "weak_scaling": weak and weak["point"]}))
    return 0 if report["claim_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
