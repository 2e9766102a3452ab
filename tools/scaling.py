"""Multi-device scaling evidence on virtual CPU devices -> build/SCALING.json.

Three sections, honest about what this single-host environment can measure:

  1. virtual-mesh sweep — the full SNP-sharded solver (shard_map ops +
     psum collectives) runs at snp-shards in {1, 2, 4, 8} on the 8-device
     virtual CPU mesh for a FIXED iteration count; records nnz/s via
     multihost.nnz_throughput.  All 8 virtual devices share this box's
     physical cores, so wall-clock here validates the sharded program and
     the metric plumbing, NOT hardware scaling.
  2. two-process localhost cluster — the same SPMD program over a real
     jax.distributed 2-process (1 task x 2 snp) mesh with host-sharded
     .bed ingest (each process reads only its own byte range), timed the
     same way; again cores are shared.
  3. analytic communication model (multihost.comm_model, unit-tested) —
     per-iteration local vs collective bytes for the solver's op structure,
     evaluated at UK-Biobank scale (500k x 1M, cv batch B=100) across
     (task, snp) mesh shapes, with comm_model's default rates (the
     published H100 SXM memory and NVLink rates).  This is the perf
     prediction a real multi-chip run would be judged against: the >=80%
     @ >=2 hosts target (BASELINE.json) holds whenever the cv task batch
     is sharded over 'task' and 'snp' stays modest.

Usage: python tools/scaling.py          (CPU only; ~2-4 min warm)
"""

import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

N, P, K, ITERS = 1024, 40_000, 10, 10
SCALING_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "SCALING.json")
B_TASKS = 4          # small cv-style batch so the psum payload is realistic


def virtual_mesh_sweep():
    import mendeliht as m
    from mendeliht.parallel import multihost as mh
    from mendeliht.parallel.mesh import make_mesh, shard_geno_op
    from mendeliht.models.fit import build_fit
    from mendeliht.models.initialize import init_state
    from mendeliht.models.univariate import run_segment

    rng = np.random.default_rng(7)
    x, _ = m.simulate_random_snparray(None, N, P, rng=rng)
    y, _, _ = m.simulate_random_response(x, K, m.Normal(), rng=rng)

    rows = []
    for ns in (1, 2, 4, 8):
        mesh = make_mesh(n_task=1, n_snp=ns)
        from mendeliht.ops.linalg import PackedOp
        op = shard_geno_op(PackedOp(x), mesh)
        # tol=0 -> no early convergence: every task runs all ITERS
        op2, data, cfg, k_scalar = build_fit(
            y, op, None, k=K, tol=0.0, max_iter=ITERS + 1)
        ks = jnp.asarray([k_scalar] * B_TASKS, jnp.int32)
        cv = jnp.broadcast_to(data.sample_mask[None, :],
                              (B_TASKS, op2.n_pad))
        st0 = jax.block_until_ready(init_state(op2, data, cfg, ks, cv))
        jax.block_until_ready(run_segment(op2, data, cfg, st0, ITERS))  # warm
        t0 = time.time()
        st = jax.block_until_ready(run_segment(op2, data, cfg, st0, ITERS))
        dt = time.time() - t0
        iters = int(st.iteration) - int(st0.iteration)
        nnz_s = mh.nnz_throughput(N, P, iters, dt)
        rows.append({"snp_shards": ns, "seconds": dt, "iterations": iters,
                     "nnz_per_s": nnz_s})
        print(f"ns={ns}: {dt:.3f}s for {iters} iters -> {nnz_s/1e9:.3f} "
              f"Gnnz/s", flush=True)
    base = rows[0]["nnz_per_s"]
    for r in rows:
        r["efficiency_vs_1shard"] = r["nnz_per_s"] / (base * r["snp_shards"])
    return rows


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def two_process_run(tmpdir=os.path.join(os.path.dirname(SCALING_PATH),
                                         "scaling_mh")):
    import mendeliht as m

    os.makedirs(tmpdir, exist_ok=True)
    prefix = os.path.join(tmpdir, "g")
    rng = np.random.default_rng(11)
    n, p = 512, 20_000
    x, _ = m.simulate_random_snparray(prefix + ".bed", n, p, rng=rng)
    y, _, _ = m.simulate_random_response(x, K, m.Normal(), rng=rng)
    np.savetxt(prefix + ".phen", y)
    m.make_bim_fam_files(x, y, prefix)

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    out = {}
    for nproc in (1, 2):
        port = _free_port()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)           # 1 CPU device per process
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs, outs = [], []
        for pid in range(nproc):
            oj = os.path.join(tmpdir, f"t{nproc}_{pid}.json")
            outs.append(oj)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(here, "scaling_worker.py"),
                 str(port), str(pid), str(nproc), prefix, str(ITERS), oj],
                env=env))
        for pr in procs:
            assert pr.wait(timeout=900) == 0
        with open(outs[0]) as f:
            r = json.load(f)
        r["processes"] = nproc
        out[nproc] = r
        print(f"nproc={nproc}: {r['seconds']:.3f}s -> "
              f"{r['nnz_per_s']/1e9:.3f} Gnnz/s", flush=True)
    from mendeliht.parallel import multihost as mh
    eff = mh.scaling_efficiency(out[1]["nnz_per_s"], out[2]["nnz_per_s"], 2)
    return {"runs": list(out.values()), "efficiency_2proc": eff,
            "problem": {"n": n, "p": p, "iters": ITERS}}


def analytic_model():
    from mendeliht.parallel import multihost as mh

    rows = []
    # UK-Biobank-scale cv: 500k x 1M, B = q*|path| = 100 tasks
    for nt, ns in [(1, 2), (1, 4), (1, 8), (4, 2), (8, 2), (16, 2), (25, 4),
                   (50, 2)]:
        r = mh.comm_model(500_000, 1_000_000, B=100, n_task=nt, n_snp=ns)
        r.update(mesh=[nt, ns], devices=nt * ns)
        rows.append(r)
        print(f"mesh ({nt:3d},{ns}) = {nt*ns:3d} dev: "
              f"local {r['local_bytes_per_iter']/1e9:6.2f} GB, comm "
              f"{r['collective_bytes_per_iter']/1e9:6.3f} GB/iter -> "
              f"predicted eff {r['predicted_efficiency']*100:5.1f}%",
              flush=True)
    return {"assumptions": {
                "rates": "comm_model defaults (published H100 SXM)",
                "problem": {"n": 500_000, "p": 1_000_000, "cv_tasks": 100},
                "note": ("no-overlap ring-allreduce model; see "
                         "multihost.comm_model docstring")},
            "rows": rows}


def main():
    out = {
        "note": ("Virtual 8-device CPU mesh + 2-process localhost cluster "
                 "on a 2-core box: these rows prove the sharded SPMD "
                 "program, ingest, and metric plumbing; physical cores are "
                 "shared, so wall-clock efficiency here is NOT hardware "
                 "scaling. The analytic_model section is the multi-chip "
                 "prediction at UKB scale."),
        "virtual_mesh": virtual_mesh_sweep(),
        "two_process": two_process_run(),
        "analytic_model": analytic_model(),
    }
    path = SCALING_PATH
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # preserve the HLO-reconciliation section maintained by tools/comm_check.py
    try:
        with open(path) as f:
            prev = json.load(f)
        if "model_vs_measured" in prev:
            out["model_vs_measured"] = prev["model_vs_measured"]
    except Exception:
        pass
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
