"""Scaling-measurement worker (launched by tools/scaling.py).

Join the localhost cluster, build a (1 task x nproc snp) global mesh, read
this process's SNP shard of the .bed, and time a fixed-iteration solver
segment. argv: port pid nproc prefix iters out_json
"""

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def main():
    port, pid, nproc, prefix, iters, out_json = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        int(sys.argv[5]), sys.argv[6])
    from mendeliht.parallel import multihost as mh
    from mendeliht.parallel.sharded_ops import ShardedPackedOp
    from mendeliht.models.fit import build_fit
    from mendeliht.models.initialize import init_state
    from mendeliht.models.univariate import run_segment

    if nproc > 1:
        mh.initialize(coordinator_address=f"127.0.0.1:{port}",
                      num_processes=nproc, process_id=pid)
    mesh = mh.make_global_mesh(n_task=1, n_snp=nproc)
    geno, p_true = mh.load_bed_shard(prefix, mesh)
    n = geno.n

    op = ShardedPackedOp(geno, mesh)
    y = np.loadtxt(prefix + ".phen")
    op2, data, cfg, k_scalar = build_fit(y, op, None, k=10, tol=0.0,
                                         max_iter=iters + 1)
    data = mh.replicate(data, mesh)
    ks = mh.replicate(jnp.asarray([k_scalar], jnp.int32), mesh)
    cv = mh.replicate(jnp.broadcast_to(
        np.asarray(data.sample_mask)[None, :], (1, op2.n_pad)), mesh)

    st0 = jax.block_until_ready(init_state(op2, data, cfg, ks, cv))
    jax.block_until_ready(run_segment(op2, data, cfg, st0, iters))   # warm
    t0 = time.time()
    st = jax.block_until_ready(run_segment(op2, data, cfg, st0, iters))
    dt = time.time() - t0
    ran = int(st.iteration) - int(st0.iteration)
    out = {"seconds": dt, "iterations": ran,
           "nnz_per_s": mh.nnz_throughput(n, p_true, ran, dt)}
    if pid == 0:
        with open(out_json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
