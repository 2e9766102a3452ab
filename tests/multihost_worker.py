"""2-process multihost worker (launched by test_multihost.py).

Each process: join the localhost cluster, build a (1 task x 2 snp) global
mesh, read ITS OWN SNP-shard of the .bed, and run the unchanged IHT solver
as one SPMD program. Prints a JSON result line for the parent to compare.

argv: coordinator_port process_id prefix k out_json
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    port, pid, prefix, k, out_json = (sys.argv[1], int(sys.argv[2]),
                                      sys.argv[3], int(sys.argv[4]),
                                      sys.argv[5])
    from mendeliht.parallel import multihost as mh

    mh.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    mesh = mh.make_global_mesh(n_task=1, n_snp=2)

    geno, p_true = mh.load_bed_shard(prefix, mesh)

    from mendeliht.parallel.sharded_ops import ShardedPackedOp
    from mendeliht.models.fit import build_fit
    from mendeliht.models.univariate import fit_fused_sparse

    op = ShardedPackedOp(geno, mesh)
    y = np.loadtxt(prefix + ".phen")
    op2, data, cfg, k_scalar = build_fit(y, op, None, k=k, max_iter=50)

    # multi-process rule: every jit input must be a global array
    data = mh.replicate(data, mesh)
    ks = mh.replicate(jnp.asarray([k_scalar], jnp.int32), mesh)
    cv_wts = mh.replicate(
        jnp.broadcast_to(np.asarray(data.sample_mask)[None, :],
                         (1, op.n_pad)), mesh)

    rep = NamedSharding(mesh, P())
    fitted = jax.jit(
        lambda op, data, ks, cv: fit_fused_sparse(op, data, cfg, ks, cv),
        static_argnames=(), out_shardings=rep)(op2, data, ks, cv_wts)
    (sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg) = \
        jax.device_get(fitted)

    b = np.zeros(op.p)
    is_g = sel_valid[0].astype(bool) & (sel_idx[0] < op.p)
    b[sel_idx[0][is_g]] = sel_bc[0][is_g]
    b = b[:p_true]
    out = {
        "pid": pid,
        "support": np.flatnonzero(b).tolist(),
        "beta": b[np.flatnonzero(b)].round(6).tolist(),
        "c": np.asarray(c[0]).round(6).tolist(),
        "logl": float(logl[0]),
        "iters": int(iters[0]),
    }
    with open(out_json, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
