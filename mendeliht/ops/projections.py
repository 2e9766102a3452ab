"""Sparsity projections: batched top-k hard threshold and doubly-sparse group
projection.

Reference semantics (src/utilities.jl:533-679):
  * ``project_k!`` keeps the k largest-magnitude entries of the concatenated
    ``[b; c]`` vector, where magnitudes are optionally scaled by a prior
    ``weight`` vector and ``zkeep``-pinned covariates are forced in by setting
    their magnitude to +inf (vectorize!, src/utilities.jl:291-315).  Surviving
    entries keep their *original* values.
  * ``project_group_sparse!`` keeps at most J groups and at most k (or k[g])
    predictors per group, ranking groups by the l2 norm of their top-k entries.

Notes: everything is expressed with ``lax.top_k`` / sorts under a static
slot count S, batched over the task axis. Ties resolve deterministically by
lowest index (stable top_k) instead of the reference's RNG `_choose!`
(src/utilities.jl:444-458) — the "exactly k survivors" invariant is identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


_TOPK_BLOCK = 2048


def fast_top_k(x, K: int):
    """Exact top-K over the last axis via hierarchical (block-then-merge)
    selection — much cheaper than a global sort for p ~ 1e6 and K ~ tens,
    which is the per-iteration projection cost of IHT.

    Tie-break note: within equal values, indices are NOT guaranteed to be in
    ascending order across blocks (candidates are merged blockwise), but the
    selected value multiset equals lax.top_k's.
    """
    B, p = x.shape
    if K >= _TOPK_BLOCK or p <= 2 * _TOPK_BLOCK:
        return jax.lax.top_k(x, K)
    nb = -(-p // _TOPK_BLOCK)
    p_pad = nb * _TOPK_BLOCK
    if p_pad != p:
        x = jnp.pad(x, ((0, 0), (0, p_pad - p)),
                    constant_values=-jnp.inf)
    xr = x.reshape(B, nb, _TOPK_BLOCK)
    v, i = jax.lax.top_k(xr, K)                         # (B, nb, K)
    v2 = v.reshape(B, nb * K)
    i2 = (i + (jnp.arange(nb) * _TOPK_BLOCK)[None, :, None]).reshape(B, nb * K)
    vf, sel = jax.lax.top_k(v2, K)
    return vf, jnp.take_along_axis(i2, sel, axis=1)


def joint_magnitude(b, c, zkeep, weight=None):
    """|[b;c]| with weight scaling and +inf pinning of kept covariates.

    b (B,p), c (B,q), zkeep (q,) bool, weight (p+q,) or None -> (B, p+q).
    """
    full = jnp.concatenate([b, c], axis=1)
    mag = jnp.abs(full)
    if weight is not None:
        mag = mag * weight[None, :]
    pin = jnp.concatenate([jnp.zeros(b.shape[1], bool), zkeep])
    return jnp.where(pin[None, :], jnp.inf, mag)


def project_topk_joint(b, c, k_plus_keep, zkeep, S: int, weight=None):
    """Batched joint top-k projection.

    Keeps the ``k_plus_keep[t]`` largest entries (by pinned/weighted
    magnitude) of each task's ``[b; c]``; everything else is zeroed, except
    ``zkeep`` covariates which always keep their value.

    Returns (b_new, c_new, sel_idx (B,S), sel_val (B,S), sel_keep (B,S)).
    ``sel_idx`` indexes the concatenated vector; padding slots have
    ``sel_keep == 0``.
    """
    B, p = b.shape
    mag = joint_magnitude(b, c, zkeep, weight)
    _, topi = fast_top_k(mag, S)                                 # (B, S)
    full = jnp.concatenate([b, c], axis=1)
    vals = jnp.take_along_axis(full, topi, axis=1)
    rank = jnp.arange(S)[None, :]
    keep = rank < k_plus_keep[:, None]
    kept_vals = jnp.where(keep, vals, 0.0)
    new_full = jnp.zeros_like(full)
    new_full = new_full.at[jnp.arange(B)[:, None], topi].set(kept_vals)
    # zkeep covariates keep their original values unconditionally
    pin = jnp.concatenate([jnp.zeros(p, bool), zkeep])[None, :]
    new_full = jnp.where(pin, full, new_full)
    b_new, c_new = new_full[:, :p], new_full[:, p:]
    sel_keep = keep & (vals != 0)
    return b_new, c_new, topi, vals, sel_keep


def select_support(b, c, zkeep, S: int, weight=None):
    """Top-S support of an (already sparse) [b;c]: returns sel_idx, sel_valid.

    Valid = nonzero entry (matches reference idx = b .!= 0 / idc = c .!= 0)."""
    mag = joint_magnitude(b, c, zkeep, weight)
    # pinned entries rank first but validity still requires nonzero value
    _, topi = fast_top_k(mag, S)
    full = jnp.concatenate([b, c], axis=1)
    vals = jnp.take_along_axis(full, topi, axis=1)
    return topi, vals != 0


def project_k(x, k: int, weight=None):
    """Single-vector top-k hard threshold (reference src/utilities.jl:553-559).

    Unlike the reference's threshold-comparison (which can keep > k entries on
    ties before `_choose!`), keeps exactly min(k, nnz) entries, stable by index.
    """
    x = jnp.asarray(x)
    mag = jnp.abs(x) if weight is None else jnp.abs(x) * weight
    _, topi = jax.lax.top_k(mag, k)
    out = jnp.zeros_like(x)
    return out.at[topi].set(x[topi])


@functools.partial(jax.jit, static_argnames=("J", "n_groups"))
def _group_sparse_one(y, group0, ks_per_group, J: int, n_groups: int):
    """Doubly-sparse projection of one vector.

    y (p,), group0 (p,) int32 in [0, n_groups), ks_per_group (n_groups,) int32.
    """
    p = y.shape[0]
    order = jnp.argsort(-jnp.abs(y), stable=True)                # magnitude desc
    g_sorted = group0[order]
    # within-group occurrence index in magnitude order:
    ord2 = jnp.argsort(g_sorted, stable=True)
    g2 = g_sorted[ord2]
    pos = jnp.arange(p)
    is_start = jnp.concatenate([jnp.array([True]), g2[1:] != g2[:-1]])
    seg_start = jax.lax.associative_scan(jnp.maximum, jnp.where(is_start, pos, 0))
    occ2 = pos - seg_start
    occ_sorted = jnp.zeros(p, jnp.int32).at[ord2].set(occ2.astype(jnp.int32))
    rank_in_group = jnp.zeros(p, jnp.int32).at[order].set(occ_sorted)
    kg = ks_per_group[group0]
    in_topk = rank_in_group < kg
    # group norms from top-k contributions
    contrib = jnp.where(in_topk, y * y, 0.0)
    gnorm = jax.ops.segment_sum(contrib, group0, num_segments=n_groups)
    grank_order = jnp.argsort(-gnorm, stable=True)
    grank = jnp.zeros(n_groups, jnp.int32).at[grank_order].set(
        jnp.arange(n_groups, dtype=jnp.int32))
    keep_group = grank[group0] < J
    return jnp.where(in_topk & keep_group, y, 0.0)


def project_group_sparse_batched(y, group, J: int, ks, n_groups: int):
    """Batched doubly-sparse projection with static group count (used inside
    the jitted solver; `ks` is a (n_groups,) per-group-k vector)."""
    group0 = (jnp.asarray(group) - 1).astype(jnp.int32)
    ks = jnp.asarray(ks, jnp.int32)
    return jax.vmap(lambda v: _group_sparse_one(v, group0, ks, J, n_groups))(y)


def project_group_sparse_per_task(y, group, J: int, k_task, n_groups: int):
    """Batched doubly-sparse projection where every group's cap is the task's
    own scalar sparsity `k_task` (B,) — the reference's `v.k` semantics for
    scalar-k group IHT, which cross-validation varies per (fold, k) combo
    (reference src/cross_validation.jl:109 `v.k = sparsity`,
    src/utilities.jl:255 `k = length(v.ks) > 0 ? v.ks : v.k`)."""
    group0 = (jnp.asarray(group) - 1).astype(jnp.int32)
    k_task = jnp.asarray(k_task, jnp.int32)

    def one(v, kt):
        ks = jnp.broadcast_to(kt, (n_groups,))
        return _group_sparse_one(v, group0, ks, J, n_groups)

    return jax.vmap(one)(y, k_task)


def project_group_sparse(y, group, J: int, k):
    """Project onto <= J active groups with <= k (or k[g]) predictors each.

    y: (p,) or (B, p);  group: (p,) 1-based group ids (reference convention);
    k: scalar or per-group vector.
    """
    y = jnp.asarray(y)
    group = np.asarray(group) if not isinstance(group, jnp.ndarray) else group
    n_groups = int(np.max(np.asarray(group)))
    group = jnp.asarray(group)
    group0 = (group - 1).astype(jnp.int32)
    if jnp.ndim(jnp.asarray(k)) == 0:
        ks = jnp.full((n_groups,), int(k), jnp.int32)
    else:
        ks = jnp.asarray(k, jnp.int32)
    if y.ndim == 1:
        return _group_sparse_one(y, group0, ks, J, n_groups)
    return jax.vmap(lambda v: _group_sparse_one(v, group0, ks, J, n_groups))(y)
