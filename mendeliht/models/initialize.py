"""Solver-state initialization (reference `init_iht_indices!`,
src/utilities.jl:366-438, and `initialize_beta!`, :776-812).

Everything is batched over tasks; tasks may differ in sparsity k and in their
cross-validation sample mask, but share the phenotype / design data.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import glm
from ..ops.decode import DOT_PREC
from ..ops.projections import (project_group_sparse_batched,
                               project_group_sparse_per_task)
from .state import IHTState, FitConfig, FitData
from .univariate import _forward, _score, _proj_joint
import dataclasses


def _newton_intercept(link: str, ybar, n_iter: int = 20):
    """Solve linkinv(c) = ybar by damped Newton (reference
    src/utilities.jl:394-405). ybar (B,) -> (B,)."""
    def body(_, c):
        g1 = glm.linkinv(link, c)
        g2 = glm.mueta(link, c)
        step = jnp.clip((g1 - ybar) / g2, -1.0, 1.0)
        return jnp.where(jnp.abs(g1 - ybar) < 1e-10, c, c - step)
    return jax.lax.fori_loop(0, n_iter, body, jnp.zeros_like(ybar))


def _initialize_beta(op, data: FitData, cv_wts):
    """Univariate-regression warm start (reference src/utilities.jl:776-812):
    per SNP j, regress y on [1, x_j] over the training samples; collect slopes
    into b and average the intercepts into c[0]. Returns (b, c)."""
    W = cv_wts
    WY = cv_wts * data.y[None, :]
    Sx, Sxx, Sxy = op.col_moments(W, WY)
    N = jnp.sum(W, axis=1, keepdims=True)
    Sy = jnp.sum(WY, axis=1, keepdims=True)
    det = N * Sxx - Sx * Sx
    ok = det > 1e-12
    slope = jnp.where(ok, (N * Sxy - Sx * Sy) / jnp.where(ok, det, 1.0), Sxy)
    icept = jnp.where(ok, (Sy - Sx * slope) / N, Sy)
    b = jnp.clip(slope, -2.0, 2.0)

    q = data.z.shape[1]
    c = jnp.zeros((cv_wts.shape[0], q), b.dtype)
    icept_sum = jnp.sum(icept, axis=1)
    if q > 1:
        # non-genetic covariates (columns 2..q; column 1 is the intercept)
        zc_cols = data.z[:, 1:]                              # (n_pad, q-1)
        Szx = jnp.dot(W, zc_cols, precision=DOT_PREC)
        Szxx = jnp.dot(W, zc_cols * zc_cols, precision=DOT_PREC)
        Szxy = jnp.dot(WY, zc_cols, precision=DOT_PREC)
        detz = N * Szxx - Szx * Szx
        okz = detz > 1e-12
        slz = jnp.where(okz, (N * Szxy - Szx * Sy) / jnp.where(okz, detz, 1.0), Szxy)
        icz = jnp.where(okz, (Sy - Szx * slz) / N, Sy)
        c = c.at[:, 1:].set(jnp.clip(slz, -2.0, 2.0))
        icept_sum = icept_sum + jnp.sum(icz, axis=1)
    c = c.at[:, 0].set(jnp.clip(icept_sum / (op.p + q - 1), -2.0, 2.0))
    return b, c


@functools.partial(jax.jit, static_argnames=("cfg", "init_beta"))
def init_state(op, data: FitData, cfg: FitConfig, k, cv_wts,
               init_beta: bool = False) -> IHTState:
    """Build the initial IHTState for a batch of tasks.

    k: (B,) int32 per-task sparsity; cv_wts: (B, n_pad) 0/1 training masks
    (already zero at padding).
    """
    dtype = op.dtype
    B = cv_wts.shape[0]
    p, q, n_pad = op.p, data.z.shape[1], op.n_pad
    k = jnp.asarray(k, jnp.int32).reshape(B)

    b = jnp.zeros((B, p), dtype)
    c = jnp.zeros((B, q), dtype)
    # intercept by Newton on the training-sample mean
    ybar = jnp.sum(data.y[None, :] * cv_wts, axis=1) / \
        jnp.maximum(jnp.sum(cv_wts != 0, axis=1), 1)
    c = c.at[:, 0].set(_newton_intercept(cfg.link, ybar).astype(dtype))
    zc = jnp.dot(c, data.z.T, precision=DOT_PREC)
    xb = jnp.zeros((B, n_pad), dtype)
    mu = glm.linkinv(cfg.link, xb + zc)
    nb_r = jnp.ones((B,), dtype)

    st = IHTState(
        b=b, c=c, b0=jnp.zeros_like(b), c0=jnp.zeros_like(c),
        best_b=jnp.zeros_like(b), best_c=jnp.zeros_like(c),
        df=jnp.zeros_like(b), df2=jnp.zeros_like(c),
        sel_idx=jnp.zeros((B, cfg.S), jnp.int32),
        sel_valid=jnp.zeros((B, cfg.S), bool),
        idc=jnp.zeros((B, q), bool),
        xb=xb, zc=zc, mu=mu, nb_r=nb_r,
        logl=jnp.full((B,), -jnp.inf, dtype),
        best_logl=jnp.full((B,), -jnp.inf, dtype),
        k=k, cv_wts=cv_wts.astype(dtype),
        active=jnp.ones((B,), bool), failed=jnp.zeros((B,), bool),
        iters=jnp.zeros((B,), jnp.int32),
        eta=jnp.zeros((B,), dtype), backtracks=jnp.zeros((B,), jnp.int32),
        iteration=jnp.asarray(0, jnp.int32),
    )

    df, df2 = _score(op, data, cfg, st)
    st = dataclasses.replace(st, df=df, df2=df2)

    if init_beta:
        b, c = _initialize_beta(op, data, st.cv_wts)
        b = b.astype(dtype)
        c = c.astype(dtype)
        weight = data.weight if cfg.has_weight else None
        b, c, sel_idx, _, sel_valid = _proj_joint(
            op, b, c, k + cfg.zkeepn, data.zkeep, cfg.S, weight=weight)
        st = dataclasses.replace(
            st, b=b, c=c, b0=b, c0=c, sel_idx=sel_idx, sel_valid=sel_valid,
            idc=c != 0)
    elif cfg.use_group:
        # reference quirk (src/utilities.jl:427-429): group init projects the
        # score but computes the support from (all-zero) b -> empty support,
        # idc all true. First step then uses the eta = 1e-8 guard.
        if cfg.group_k_is_vector:
            df_p = project_group_sparse_batched(
                df, data.group, cfg.J, data.group_ks, cfg.n_groups)
        else:
            df_p = project_group_sparse_per_task(
                df, data.group, cfg.J, k, cfg.n_groups)
        st = dataclasses.replace(
            st, df=df_p,
            sel_valid=jnp.zeros_like(st.sel_valid),
            idc=jnp.ones((B, q), bool))
    else:
        # top-(k + zkeepn) of |score| defines the initial support; the score
        # itself is *replaced* by its projection, so the first gradient step
        # moves only the selected entries (reference src/utilities.jl:416-431)
        weight = data.weight if cfg.has_weight else None
        df_p, df2_p, sel_idx, _, sel_valid = _proj_joint(
            op, df, df2, k + cfg.zkeepn, data.zkeep, cfg.S, weight=weight)
        df2_p = jnp.where(data.zkeep[None, :], df2, df2_p)
        st = dataclasses.replace(
            st, df=df_p, df2=df2_p, sel_idx=sel_idx, sel_valid=sel_valid,
            idc=jnp.broadcast_to(data.zkeep[None, :], (B, q)))
    return st
