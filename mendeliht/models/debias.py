"""Debiasing: exact GLM refit on the current support
(reference src/utilities.jl:1014-1020 — note the reference refit uses only the
genetic columns, no intercept/covariates, and ignores cv weights; we replicate
both quirks for parity).

Implemented as batched IRLS on the gathered standardized columns: for Normal /
identity this is one weighted-least-squares solve (exact); otherwise a bounded
`lax.while_loop` that exits as soon as every task's coefficients stop moving
(GLM.jl's refit likewise converges and stops rather than spinning a fixed
iteration count — reference src/utilities.jl:1014-1020 delegates to GLM.fit,
whose IRLS has rtol-based early exit)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import glm
from ..ops.decode import DOT_PREC
from .state import FitConfig, FitData
from .univariate import _split_sel

_IRLS_MAX = 25
_IRLS_TOL = 1e-6


def debias_refit(op, data: FitData, cfg: FitConfig, st):
    gidx, gval = _split_sel(st.sel_idx, st.sel_valid, op.p)
    Xk = op.gather_cols(gidx, gval)                      # (B, S, n_pad)
    B, S, _ = Xk.shape
    beta0 = jnp.take_along_axis(st.b, gidx, axis=1) * gval

    m = data.sample_mask[None, :]
    eye = jnp.eye(S, dtype=Xk.dtype)[None]
    invalid_diag = eye * (~gval).astype(Xk.dtype)[:, :, None] * 1.0

    def irls_step(beta):
        eta = jnp.einsum("bsn,bs->bn", Xk, beta, precision=DOT_PREC)
        mu = glm.linkinv(cfg.link, eta)
        me = glm.mueta(cfg.link, eta)
        var = jnp.maximum(glm.glmvar(cfg.dist, mu, nb_r=st.nb_r[:, None]), 1e-30)
        w = (me * me / var) * m
        zw = eta + (data.y[None, :] - mu) / jnp.where(me == 0, 1.0, me)
        Xw = Xk * w[:, None, :]
        A = (jnp.einsum("bsn,btn->bst", Xw, Xk, precision=DOT_PREC)
             + invalid_diag + 1e-8 * eye)
        rhs = jnp.einsum("bsn,bn->bs", Xw, zw, precision=DOT_PREC)
        beta = jnp.linalg.solve(A, rhs[..., None])[..., 0]
        return beta * gval

    if cfg.dist == "normal" and cfg.link == "identity":
        beta = irls_step(beta0)        # exact in one weighted LS solve
    else:
        def body(carry):
            beta, _, i = carry
            return irls_step(beta), beta, i + 1

        def cond(carry):
            beta, prev, i = carry
            delta = jnp.max(jnp.abs(beta - prev))
            denom = jnp.max(jnp.abs(prev)) + 1.0
            return (i < 1) | ((i < _IRLS_MAX) & (delta / denom > _IRLS_TOL))

        beta, _, _ = jax.lax.while_loop(
            cond, body, (beta0, beta0, jnp.int32(0)))

    b_new = st.b.at[jnp.arange(B)[:, None], gidx].set(
        jnp.where(gval, beta, jnp.take_along_axis(st.b, gidx, axis=1)))
    return b_new
