"""Device-mesh construction and sharding specs.

Parallelism design (SURVEY.md §2.15-2.16 maps the reference's concurrency to
mesh axes):

  * ``task`` axis — data parallelism over cross-validation (fold, k)
    combinations (the reference's `Threads.@threads :static` pool,
    src/cross_validation.jl:100); embarrassingly parallel, no communication
    except the final loss gather.
  * ``snp`` axis — model parallelism over the SNP dimension (the reference's
    thread-sharded column loops, src/utilities.jl:96-106).  The packed
    genotype matrix, b/df/best_b vectors shard along p; the score X'r is
    communication-free (each shard owns its rows); the k-sparse forward
    product and the global top-k projection need cross-shard collectives
    which XLA inserts from the sharding annotations.

Per-sample arrays (y, mu, xb, cv_wts) are replicated across ``snp`` and
sharded across ``task``.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_task: int | None = None, n_snp: int | None = None,
              devices=None) -> Mesh:
    """Build a (task, snp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    nd = len(devices)
    if n_task is None and n_snp is None:
        n_snp = 1
        n_task = nd
    elif n_task is None:
        n_task = nd // n_snp
    elif n_snp is None:
        n_snp = nd // n_task
    if n_task * n_snp > nd:
        raise ValueError(f"mesh {n_task}x{n_snp} > {nd} devices")
    dev_array = np.asarray(devices[:n_task * n_snp]).reshape(n_task, n_snp)
    return Mesh(dev_array, axis_names=("task", "snp"))


def pad_geno_rows(geno, n_shards: int):
    """Pad a PackedGenotypes to an even multiple of `n_shards` SNP rows so
    it can shard over the 'snp' axis when p is ragged (shard_map requires
    even splits).  Pad rows are inert: words zero, inv_sd == 0 (so every
    standardized product contributes exactly 0), mu == 0.  Callers keep
    using the true `p` for betas — the solver's projections can never select
    a pad row because its gradient is identically zero.  Multi-host ingest
    does the same padding host-side (multihost.shard_rows)."""
    import dataclasses
    import jax.numpy as jnp
    p = geno.p
    per = -(-(-(-p // n_shards)) // 4) * 4   # mult of 4: shards own whole
    p_pad = per * n_shards                   # quad-word rows
    if p_pad == p:
        return geno
    extra_q = p_pad // 4 - geno.words.shape[0]
    words = geno.words
    if extra_q > 0:
        words = jnp.concatenate(
            [words, jnp.zeros((extra_q, words.shape[1]), words.dtype)],
            axis=0)
    extra = p_pad - p
    mu = jnp.concatenate([geno.mu, jnp.zeros(extra, geno.mu.dtype)])
    inv = jnp.concatenate([geno.inv_sd, jnp.zeros(extra, geno.inv_sd.dtype)])
    return dataclasses.replace(geno, words=words, mu=mu, inv_sd=inv,
                               p=p_pad, maf_=None, n_missing=None)


def geno_sharding(mesh: Mesh):
    """PackedGenotypes sharding: packed rows (SNPs) across 'snp', stats too."""
    return dict(
        words=NamedSharding(mesh, P("snp", None)),
        mu=NamedSharding(mesh, P("snp")),
        inv_sd=NamedSharding(mesh, P("snp")),
    )


def state_sharding(mesh: Mesh):
    """IHTState shardings: (B, p) arrays over (task, snp); (B, n) and (B,)
    arrays over (task,); scalars replicated."""
    bp = NamedSharding(mesh, P("task", "snp"))
    bn = NamedSharding(mesh, P("task", None))
    b_ = NamedSharding(mesh, P("task"))
    rep = NamedSharding(mesh, P())
    return dict(
        b=bp, b0=bp, best_b=bp, df=bp,
        c=bn, c0=bn, best_c=bn, df2=bn,
        sel_idx=bn, sel_valid=bn, idc=bn,
        xb=bn, zc=bn, mu=bn, cv_wts=bn,
        nb_r=b_, logl=b_, best_logl=b_, k=b_, active=b_, failed=b_,
        iters=b_, eta=b_, backtracks=b_,
        iteration=rep,
    )


def shard_state(st, mesh: Mesh):
    """Apply the canonical shardings to an IHTState."""
    import dataclasses
    sh = state_sharding(mesh)
    updates = {}
    for f in dataclasses.fields(st):
        if f.name in sh:
            updates[f.name] = jax.device_put(getattr(st, f.name), sh[f.name])
    return dataclasses.replace(st, **updates)


def mv_state_sharding(mesh: Mesh):
    """MIHTState shardings: (T, r, p) tensors over (task, -, snp); (T, r, n)
    and (T, r, q) over (task,); per-task scalars over (task,)."""
    trp = NamedSharding(mesh, P("task", None, "snp"))
    trx = NamedSharding(mesh, P("task", None, None))
    tn = NamedSharding(mesh, P("task", None))
    t_ = NamedSharding(mesh, P("task"))
    rep = NamedSharding(mesh, P())
    return dict(
        B=trp, B0=trp, best_B=trp, df=trp,
        C=trx, C0=trx, best_C=trx, df2=trx,
        Gamma=trx, Gamma0=trx,
        BX=trx, CZ=trx, mu=trx, resid=trx,
        sel_idx=tn, sel_valid=tn, idc=tn, cv_wts=tn,
        logl=t_, best_logl=t_, k=t_, active=t_, failed=t_,
        iters=t_, eta=t_, backtracks=t_,
        iteration=rep,
    )


def shard_mv_state(st, mesh: Mesh):
    """Apply the canonical shardings to an MIHTState."""
    import dataclasses
    sh = mv_state_sharding(mesh)
    updates = {}
    for f in dataclasses.fields(st):
        if f.name in sh:
            updates[f.name] = jax.device_put(getattr(st, f.name), sh[f.name])
    return dataclasses.replace(st, **updates)


def shard_mv_data(data, mesh: Mesh):
    """MvData is replicated (Y, z, masks are small per-sample arrays)."""
    import dataclasses
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        data,
        Y=jax.device_put(data.Y, rep), z=jax.device_put(data.z, rep),
        zkeep=jax.device_put(data.zkeep, rep),
        sample_mask=jax.device_put(data.sample_mask, rep))


def shard_geno_op(op, mesh: Mesh, explicit: bool = True):
    """Shard a PackedOp's genotype arrays across the 'snp' axis.

    With ``explicit=True`` (default) returns a
    :class:`~..parallel.sharded_ops.ShardedPackedOp` whose products run under
    `shard_map` — required for the fused score kernel, which the SPMD
    auto-partitioner cannot split.  ``explicit=False`` keeps a plain PackedOp
    and relies on auto-sharding (fine for the XLA decode path)."""
    import dataclasses
    from ..ops.linalg import PackedOp
    if not isinstance(op, PackedOp):
        return op
    sh = geno_sharding(mesh)
    g = op.geno
    g2 = dataclasses.replace(
        g,
        words=jax.device_put(g.words, sh["words"]),
        mu=jax.device_put(g.mu, sh["mu"]),
        inv_sd=jax.device_put(g.inv_sd, sh["inv_sd"]))
    if explicit:
        from .sharded_ops import ShardedPackedOp
        return ShardedPackedOp(g2, mesh)
    return PackedOp(g2)


def shard_data(data, mesh: Mesh):
    """FitData is replicated (y, z, masks are small per-sample arrays)."""
    import dataclasses
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        data,
        y=jax.device_put(data.y, rep), z=jax.device_put(data.z, rep),
        zkeep=jax.device_put(data.zkeep, rep),
        weight=jax.device_put(data.weight, rep),
        group=jax.device_put(data.group, rep),
        group_ks=jax.device_put(data.group_ks, rep),
        sample_mask=jax.device_put(data.sample_mask, rep))
