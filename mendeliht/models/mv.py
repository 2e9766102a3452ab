"""Multivariate (multi-trait) Gaussian IHT (reference src/multivariate.jl).

Model: Y (r x n) ~ MatrixNormal(B X + C Z, Sigma); IHT maximizes
  n/2 logdet(Gamma) - 1/2 tr(Gamma (Y-BX-CZ)(Y-BX-CZ)')
jointly over a k-sparse B and the precision Gamma (block ascent; Gamma solved
exactly each iteration, reference solve_Σ!, src/multivariate.jl:276-282).

The design mirrors the univariate solver: a task batch axis (cv folds x
sparsity levels), static-size column support, one jitted while_loop.  Trait
dimension r rides along as a small inner axis; the heavy score
`Gamma R X'` is one (B*r)-RHS fused decode-matmul.
"""

from __future__ import annotations

import dataclasses
import time as _time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import glm
from ..ops.decode import DOT_PREC
from ..ops.projections import fast_top_k
from .state import FitConfig, _register
from .results import MIHTResult, print_cv_results
from .pve import masked_var

_GUARD = 1e-8


@_register
@dataclasses.dataclass(frozen=True)
class MIHTState:
    """Batched multivariate IHT state (reference mIHTVariable,
    src/data_structures.jl:140-180)."""
    B: jnp.ndarray          # (T, r, p) genetic effects
    C: jnp.ndarray          # (T, r, q) covariate effects
    B0: jnp.ndarray
    C0: jnp.ndarray
    best_B: jnp.ndarray
    best_C: jnp.ndarray
    Gamma: jnp.ndarray      # (T, r, r) precision
    Gamma0: jnp.ndarray
    df: jnp.ndarray         # (T, r, p) score
    df2: jnp.ndarray        # (T, r, q)
    sel_idx: jnp.ndarray    # (T, S) SNP column support
    sel_valid: jnp.ndarray  # (T, S)
    idc: jnp.ndarray        # (T, q)
    BX: jnp.ndarray         # (T, r, n_pad)
    CZ: jnp.ndarray         # (T, r, n_pad)
    mu: jnp.ndarray         # (T, r, n_pad)
    resid: jnp.ndarray      # (T, r, n_pad)   (Y - mu) * cv_wts
    logl: jnp.ndarray       # (T,)
    best_logl: jnp.ndarray
    k: jnp.ndarray          # (T,)
    cv_wts: jnp.ndarray     # (T, n_pad)
    active: jnp.ndarray
    failed: jnp.ndarray
    iters: jnp.ndarray
    eta: jnp.ndarray
    backtracks: jnp.ndarray
    iteration: jnp.ndarray  # ()


@dataclasses.dataclass(frozen=True)
class MvData:
    Y: jnp.ndarray            # (r, n_pad)
    z: jnp.ndarray            # (n_pad, q)
    zkeep: jnp.ndarray        # (q,)
    sample_mask: jnp.ndarray  # (n_pad,)
    n_true: int


jax.tree_util.register_dataclass(
    MvData, data_fields=["Y", "z", "zkeep", "sample_mask"],
    meta_fields=["n_true"])


def _where_t(mask, new, old):
    return jnp.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


# ---------------------------------------------------------------------------
# vectorize / project: julia-order flattening [vec(B); vec(C)] with per-SNP
# r-blocks (reference src/multivariate.jl:138-189)
# ---------------------------------------------------------------------------

def _flatten_bc(Bm, Cm):
    """TRAIT-major flattening [vec(B_t1); vec(B_t2); ...; vec(C)].

    The reference flattens per-SNP r-blocks (multivariate.jl:138-189), but
    the joint top-k is order-invariant, and a per-SNP order needs a
    (T, p, r) transpose copy of the state per intermediate.  Trait-major is
    a FREE reshape of the (T, r, p) state."""
    T = Bm.shape[0]
    fb = Bm.reshape(T, -1)
    fc = Cm.reshape(T, -1)
    return jnp.concatenate([fb, fc], axis=1)


def _unflatten_bc(full, r, p, q):
    T = full.shape[0]
    return (full[:, :p * r].reshape(T, r, p),
            full[:, p * r:].reshape(T, r, q))


def _project_joint_mv(Bm, Cm, k_plus_keep, zkeep, S_entries: int):
    """Top-k over the flattened [vec(B); vec(C)] with zkeep columns pinned
    (reference project_k!, src/multivariate.jl:108-127)."""
    T, r, p = Bm.shape
    q = Cm.shape[2]
    full = _flatten_bc(Bm, Cm)
    pin_c = jnp.tile(zkeep, r)                          # (r*q,) trait-major
    pin = jnp.concatenate([jnp.zeros(p * r, bool), pin_c])
    mag = jnp.where(pin[None, :], jnp.inf, jnp.abs(full))
    _, topi = fast_top_k(mag, S_entries)
    vals = jnp.take_along_axis(full, topi, axis=1)
    keep = jnp.arange(S_entries)[None, :] < k_plus_keep[:, None]
    new_full = jnp.zeros_like(full)
    new_full = new_full.at[jnp.arange(T)[:, None], topi].set(
        jnp.where(keep, vals, 0.0))
    new_full = jnp.where(pin[None, :], full, new_full)
    B_new, C_new = _unflatten_bc(new_full, r, p, q)
    return B_new, C_new


def _column_support(Bm, S: int):
    """Top-S SNP columns by max |B| over traits; valid = any nonzero."""
    colmag = jnp.max(jnp.abs(Bm), axis=1)               # (T, p)
    _, sel_idx = fast_top_k(colmag, S)
    vals = jnp.take_along_axis(colmag, sel_idx, axis=1)
    return sel_idx, vals != 0


# --- operator-routed projections / gathers ---------------------------------
# A sharded operator (parallel.ShardedPackedOp) overrides these so the
# (T, r, p) tensors never leave their shards (same design as the univariate
# _proj_joint/_sel_support/_take_b dispatchers, models/univariate.py:60-81):
# the default global top_k / take_along_axis on a sharded array would make
# XLA all-gather the full tensor every iteration.

def _proj_joint_mv_op(op, Bm, Cm, k_plus_keep, zkeep, S_entries: int):
    f = getattr(op, "project_joint_mv", None)
    if f is not None:
        return f(Bm, Cm, k_plus_keep, zkeep, S_entries)
    return _project_joint_mv(Bm, Cm, k_plus_keep, zkeep, S_entries)


def _col_support_op(op, Bm, S: int):
    f = getattr(op, "column_support_mv", None)
    if f is not None:
        return f(Bm, S)
    return _column_support(Bm, S)


def _take_b_multi(op, arr, gidx, gval):
    """Masked (T, r, S) gather from a (T, r, p) array along the SNP axis."""
    f = getattr(op, "take_b_multi", None)
    if f is not None:
        return f(arr, gidx, gval)
    v = jnp.take_along_axis(arr, gidx[:, None, :].repeat(arr.shape[1], 1),
                            axis=2)
    return v * gval[:, None, :]


# ---------------------------------------------------------------------------
# pieces of one step
# ---------------------------------------------------------------------------

def _forward_mv(op, data: MvData, st, Bm, Cm, sel_idx, sel_valid):
    Bsel = _take_b_multi(op, Bm, sel_idx, sel_valid)
    BX = op.forward_sel_multi(sel_idx, Bsel, sel_valid.astype(Bm.dtype))
    CZ = jnp.einsum("trq,nq->trn", Cm, data.z, precision=DOT_PREC)
    return BX, CZ


def _resid(data: MvData, mu, cv_wts):
    """(Y - mu) * cv_wts (reference update_resid!, src/multivariate.jl:50-58)."""
    return (data.Y[None] - mu) * cv_wts[:, None, :]


def _solve_gamma(resid, nsamples):
    """Gamma = (R R' / nsamples)^-1 (reference solve_Σ!, :276-282).

    Documented parity deviation: the reference inverts Sigma exactly via
    cholesky!+inv! (Float64); we add a 1e-8 ridge before inversion.  In
    float32 an exactly-singular Sigma (possible when a trait's residual is
    identically zero under the cv mask) would otherwise produce Inf/NaN and
    abort the whole batched program rather than one task.  The perturbation
    is ~1e-8/eigenvalue — below f32 resolution of any well-posed Sigma — and
    docs/man/FAQ.md records the deviation."""
    RRt = jnp.einsum("trn,tsn->trs", resid, resid, precision=DOT_PREC)
    Sig = RRt / nsamples[:, None, None]
    r = Sig.shape[-1]
    Sig = Sig + 1e-8 * jnp.eye(r)[None]
    return jnp.linalg.inv(Sig)


def _loglik_mv(st_gamma, resid, nsamples):
    """n/2 logdet(Gamma) - 1/2 tr(Gamma R R') (reference :9-13)."""
    sign, logdet = jnp.linalg.slogdet(st_gamma)
    RRt = jnp.einsum("trn,tsn->trs", resid, resid, precision=DOT_PREC)
    tr = jnp.einsum("trs,tsr->t", st_gamma, RRt, precision=DOT_PREC)
    ld = jnp.where(sign > 0, logdet, -jnp.inf)
    return nsamples / 2.0 * ld - 0.5 * tr


def _score_mv(op, data: MvData, gamma, resid):
    """df = (Gamma R) X', df2 = (Gamma R) Z' (reference score!, :66-70)."""
    GR = jnp.einsum("trs,tsn->trn", gamma, resid,
                    precision=DOT_PREC)                 # (T, r, n_pad)
    f = getattr(op, "xtr_multi", None)
    if f is not None:
        df = f(GR)           # sharded: the (T*r) reshape happens per shard
    else:
        T, r, n_pad = GR.shape
        df = op.xtr(GR.reshape(T * r, n_pad)).reshape(T, r, -1)
    df2 = jnp.einsum("trn,nq->trq", GR, data.z, precision=DOT_PREC)
    return df, df2


def _stepsize_full(op, data: MvData, st):
    """eta = ||df_supp||_F^2 / ||U df_supp X||_F^2, U = chol-upper of Gamma
    (reference iht_stepsize!, src/multivariate.jl:220-254; covariate terms
    intentionally excluded like the reference)."""
    df_sel = _take_b_multi(op, st.df, st.sel_idx, st.sel_valid)
    numer = jnp.sum(df_sel * df_sel, axis=(1, 2))
    dfX = op.forward_sel_multi(st.sel_idx, df_sel,
                               st.sel_valid.astype(st.df.dtype))
    dfX = dfX * st.cv_wts[:, None, :]
    U = jnp.linalg.cholesky(st.Gamma, upper=True)
    UdfX = jnp.einsum("trs,tsn->trn", U, dfX, precision=DOT_PREC)
    denom = jnp.sum(UdfX * UdfX, axis=(1, 2))
    eta = numer / denom
    bad = jnp.isinf(eta) | jnp.isnan(eta)
    return jnp.where(bad, jnp.asarray(_GUARD, eta.dtype), eta)


def _gradstep_mv(op, cfg, st, eta, zkeep):
    B1 = st.B0 + eta[:, None, None] * st.df
    C1 = st.C0 + eta[:, None, None] * st.df2
    B_new, C_new = _proj_joint_mv_op(op, B1, C1, st.k + cfg.zkeepn, zkeep,
                                     cfg.S_entries)
    sel_idx, sel_valid = _col_support_op(op, B_new, cfg.S)
    idc = jnp.any(C_new != 0, axis=1)
    return B_new, C_new, sel_idx, sel_valid, idc


# cfg.S_entries: we extend FitConfig via a wrapper dataclass
@dataclasses.dataclass(frozen=True)
class MvConfig(FitConfig):
    S_entries: int = 32     # slots for entry-level projection (k + zkeepn)


def _mv_save_prev(st: MIHTState) -> MIHTState:
    """save_prev (reference src/multivariate.jl:356-367)."""
    act = st.active
    improved = act & (st.logl > st.best_logl)
    return dataclasses.replace(
        st,
        best_B=_where_t(improved, st.B, st.best_B),
        best_C=_where_t(improved, st.C, st.best_C),
        best_logl=jnp.where(improved, st.logl, st.best_logl),
        B0=_where_t(act, st.B, st.B0), C0=_where_t(act, st.C, st.C0),
        Gamma0=_where_t(act, st.Gamma, st.Gamma0))


def _mv_take_step(op, data: MvData, cfg: MvConfig, st: MIHTState, eta_t,
                  nsamples):
    """One projected gradient step + model refresh at stepsize eta_t (the
    body of the backtracking line search, reference src/multivariate.jl)."""
    B, C, sel_idx, sel_valid, idc = _gradstep_mv(op, cfg, st, eta_t,
                                                 data.zkeep)
    BX, CZ = _forward_mv(op, data, st, B, C, sel_idx, sel_valid)
    mu = BX + CZ
    resid = _resid(data, mu, st.cv_wts)
    gamma = _solve_gamma(resid, nsamples)
    logl = _loglik_mv(gamma, resid, nsamples)
    return dict(B=B, C=C, sel_idx=sel_idx, sel_valid=sel_valid, idc=idc,
                BX=BX, CZ=CZ, mu=mu, resid=resid, Gamma=gamma, logl=logl)


def _mv_bt_need(act, old_logl, cur, n_bt, max_step):
    return act & (old_logl > cur["logl"]) & (n_bt < max_step)


def _iteration_mv(op, data: MvData, cfg: MvConfig, st: MIHTState) -> MIHTState:
    act = st.active
    nsamples = jnp.sum(st.cv_wts, axis=1)
    st = _mv_save_prev(st)

    eta = _stepsize_full(op, data, st)
    old_logl = st.logl

    cur = _mv_take_step(op, data, cfg, st, eta, nsamples)
    n_bt = jnp.zeros_like(eta, dtype=jnp.int32)

    def bt_body(carry):
        cur, eta, n_bt = carry
        need = _mv_bt_need(act, old_logl, cur, n_bt, cfg.max_step)
        eta2 = jnp.where(need, eta / 2, eta)
        nxt = _mv_take_step(op, data, cfg, st, eta2, nsamples)
        merged = {kk: _where_t(need, nxt[kk], cur[kk]) for kk in cur}
        return merged, eta2, n_bt + need.astype(jnp.int32)

    cur, eta, n_bt = jax.lax.while_loop(
        lambda c: jnp.any(_mv_bt_need(act, old_logl, c[0], c[2],
                                      cfg.max_step)),
        bt_body, (cur, eta, n_bt))

    return _mv_post_step(op, data, cfg, st, cur, eta, n_bt)


def _mv_post_step(op, data: MvData, cfg: MvConfig, st: MIHTState, cur, eta,
                  n_bt) -> MIHTState:
    """Accept the line-search result: score, NaN guard, convergence."""
    act = st.active
    new = dataclasses.replace(
        st,
        B=_where_t(act, cur["B"], st.B), C=_where_t(act, cur["C"], st.C),
        sel_idx=_where_t(act, cur["sel_idx"], st.sel_idx),
        sel_valid=_where_t(act, cur["sel_valid"], st.sel_valid),
        idc=_where_t(act, cur["idc"], st.idc),
        BX=_where_t(act, cur["BX"], st.BX), CZ=_where_t(act, cur["CZ"], st.CZ),
        mu=_where_t(act, cur["mu"], st.mu),
        resid=_where_t(act, cur["resid"], st.resid),
        Gamma=_where_t(act, cur["Gamma"], st.Gamma),
        logl=jnp.where(act, cur["logl"], st.logl),
        eta=jnp.where(act, eta, st.eta),
        backtracks=jnp.where(act, n_bt, st.backtracks))

    df, df2 = _score_mv(op, data, new.Gamma, new.resid)
    new = dataclasses.replace(new, df=_where_t(act, df, new.df),
                              df2=_where_t(act, df2, new.df2))

    bad = act & (jnp.isnan(new.logl) | jnp.isinf(new.logl))
    it = new.iteration + 1
    dB = jnp.max(jnp.abs(new.B - new.B0), axis=(1, 2))
    dC = jnp.max(jnp.abs(new.C - new.C0), axis=(1, 2))
    the_norm = jnp.maximum(dB, dC)
    denom = jnp.maximum(jnp.max(jnp.abs(new.B0), axis=(1, 2)),
                        jnp.max(jnp.abs(new.C0), axis=(1, 2))) + 1.0
    scaled = the_norm / denom
    done = act & (((it >= cfg.min_iter) & (scaled < cfg.tol)) | bad)
    return dataclasses.replace(
        new, active=act & ~done, failed=new.failed | bad,
        iters=jnp.where(done, it, new.iters), iteration=it)


@partial(jax.jit, static_argnames=("cfg",))
def run_mv_segment(op, data: MvData, cfg: MvConfig, st: MIHTState,
                   stop) -> MIHTState:
    """Advance until all tasks converge or `stop` iterations (traced) are
    reached — resumable, mirroring univariate.run_segment (checkpointed /
    progress-segmented mv cv drivers feed the state back in)."""
    limit = jnp.minimum(jnp.asarray(stop, jnp.int32), cfg.max_iter - 1)

    def cond(s):
        return jnp.any(s.active) & (s.iteration < limit)

    return jax.lax.while_loop(cond, lambda s: _iteration_mv(op, data, cfg, s),
                              st)


@partial(jax.jit, static_argnames=("cfg",))
def finalize_mv_iht(op, data: MvData, cfg: MvConfig,
                    st: MIHTState) -> MIHTState:
    iters = jnp.where(st.active, cfg.max_iter, st.iters)
    improved = st.logl > st.best_logl
    st = dataclasses.replace(
        st,
        best_B=_where_t(improved, st.B, st.best_B),
        best_C=_where_t(improved, st.C, st.best_C),
        best_logl=jnp.where(improved, st.logl, st.best_logl),
        iters=iters, active=jnp.zeros_like(st.active))
    # save_best_model! (reference src/multivariate.jl:485-496): mu = BX + CZ
    sel_idx, sel_valid = _col_support_op(op, st.best_B, cfg.S)
    BX, CZ = _forward_mv(op, data, st, st.best_B, st.best_C, sel_idx, sel_valid)
    mu = BX + CZ
    return dataclasses.replace(st, B=st.best_B, C=st.best_C, sel_idx=sel_idx,
                               sel_valid=sel_valid, BX=BX, CZ=CZ, mu=mu,
                               idc=jnp.any(st.best_C != 0, axis=1))


def run_mv_iht(op, data: MvData, cfg: MvConfig, st: MIHTState) -> MIHTState:
    """Full solve: loop to completion then restore the best model."""
    st = run_mv_segment(op, data, cfg, st, cfg.max_iter - 1)
    return finalize_mv_iht(op, data, cfg, st)


@partial(jax.jit, static_argnames=("cfg", "init_beta"))
def fit_mv_fused(op, data: MvData, cfg: MvConfig, ks, cv_wts,
                 init_beta: bool = False):
    """init + solve + per-trait pve in ONE compiled program (single host
    round-trip; see univariate.fit_fused)."""
    st = init_mv_state(op, data, cfg, ks, cv_wts, init_beta=init_beta)
    st = run_mv_iht(op, data, cfg, st)
    Sigma = jnp.linalg.inv(st.Gamma)
    vy = masked_var(data.Y, data.sample_mask[None, :], data.n_true)
    vm = jax.vmap(lambda mu: masked_var(mu, data.sample_mask[None, :],
                                        data.n_true))(st.mu)
    return st, Sigma, vm / vy[None]


@partial(jax.jit, static_argnames=("cfg", "init_beta"))
def cv_mv_fused(op, data: MvData, cfg: MvConfig, ks, train_wts, test_wts,
                init_beta: bool = False):
    st = init_mv_state(op, data, cfg, ks, train_wts, init_beta=init_beta)
    st = run_mv_iht(op, data, cfg, st)
    return predict_mse_mv(op, data, cfg, st, test_wts)


@partial(jax.jit, static_argnames=("cfg",))
def predict_mse_mv(op, data: MvData, cfg: MvConfig, st: MIHTState, test_wts):
    """sum_ij (Y - mu)^2 * wts_j (reference predict!,
    src/cross_validation.jl:288-299)."""
    d = data.Y[None] - st.mu
    return jnp.sum(d * d * test_wts[:, None, :], axis=(1, 2))


# ---------------------------------------------------------------------------
# init (reference init_iht_indices!, src/multivariate.jl:376-452)
# ---------------------------------------------------------------------------

def _initialize_beta_mv(op, data: MvData, cv_wts):
    """Per-(SNP, trait) univariate regressions (reference initialize_beta!,
    src/multivariate.jl:519-558)."""
    T = cv_wts.shape[0]
    r = data.Y.shape[0]
    Bs, Cs = [], []
    q = data.z.shape[1]
    for j in range(r):
        W = cv_wts
        WY = cv_wts * data.Y[j][None, :]
        Sx, Sxx, Sxy = op.col_moments(W, WY)
        N = jnp.sum(W, axis=1, keepdims=True)
        Sy = jnp.sum(WY, axis=1, keepdims=True)
        det = N * Sxx - Sx * Sx
        ok = det > 1e-12
        slope = jnp.where(ok, (N * Sxy - Sx * Sy) / jnp.where(ok, det, 1.0), Sxy)
        icept = jnp.where(ok, (Sy - Sx * slope) / N, Sy)
        b = jnp.clip(slope, -2.0, 2.0)
        c = jnp.zeros((T, q), b.dtype)
        isum = jnp.sum(icept, axis=1)
        if q > 1:
            zc = data.z[:, 1:]
            Szx = jnp.dot(W, zc, precision=DOT_PREC)
            Szxx = jnp.dot(W, zc * zc, precision=DOT_PREC)
            Szxy = jnp.dot(WY, zc, precision=DOT_PREC)
            detz = N * Szxx - Szx * Szx
            okz = detz > 1e-12
            slz = jnp.where(okz, (N * Szxy - Szx * Sy) / jnp.where(okz, detz, 1.0),
                            Szxy)
            icz = jnp.where(okz, (Sy - Szx * slz) / N, Sy)
            c = c.at[:, 1:].set(jnp.clip(slz, -2.0, 2.0))
            isum = isum + jnp.sum(icz, axis=1)
        c = c.at[:, 0].set(jnp.clip(isum / (op.p + q - 1), -2.0, 2.0))
        Bs.append(b)
        Cs.append(c)
    return jnp.stack(Bs, axis=1), jnp.stack(Cs, axis=1)   # (T,r,p), (T,r,q)


@partial(jax.jit, static_argnames=("cfg", "init_beta"))
def init_mv_state(op, data: MvData, cfg: MvConfig, k, cv_wts,
                  init_beta: bool = False) -> MIHTState:
    dtype = op.dtype
    T = cv_wts.shape[0]
    r = data.Y.shape[0]
    p, q, n_pad = op.p, data.z.shape[1], op.n_pad
    k = jnp.asarray(k, jnp.int32).reshape(T)
    cv_wts = cv_wts.astype(dtype)
    nsamples = jnp.sum(cv_wts, axis=1)

    Bm = jnp.zeros((T, r, p), dtype)
    Cm = jnp.zeros((T, r, q), dtype)
    # per-trait intercept = masked trait mean (reference :414-423)
    ybar = jnp.einsum("rn,tn->tr", data.Y, cv_wts,
                      precision=DOT_PREC) / nsamples[:, None]
    Cm = Cm.at[:, :, 0].set(ybar.astype(dtype))
    Gamma = jnp.broadcast_to(jnp.eye(r, dtype=dtype)[None], (T, r, r))

    st = MIHTState(
        B=Bm, C=Cm, B0=Bm, C0=Cm, best_B=Bm, best_C=Cm,
        Gamma=Gamma, Gamma0=Gamma,
        df=jnp.zeros((T, r, p), dtype), df2=jnp.zeros((T, r, q), dtype),
        sel_idx=jnp.zeros((T, cfg.S), jnp.int32),
        sel_valid=jnp.zeros((T, cfg.S), bool),
        idc=jnp.zeros((T, q), bool),
        BX=jnp.zeros((T, r, n_pad), dtype),
        CZ=jnp.zeros((T, r, n_pad), dtype),
        mu=jnp.zeros((T, r, n_pad), dtype),
        resid=jnp.zeros((T, r, n_pad), dtype),
        logl=jnp.full((T,), -jnp.inf, dtype),
        best_logl=jnp.full((T,), -jnp.inf, dtype),
        k=k, cv_wts=cv_wts,
        active=jnp.ones((T,), bool), failed=jnp.zeros((T,), bool),
        iters=jnp.zeros((T,), jnp.int32),
        eta=jnp.zeros((T,), dtype), backtracks=jnp.zeros((T,), jnp.int32),
        iteration=jnp.asarray(0, jnp.int32))

    if init_beta:
        Bm, Cm = _initialize_beta_mv(op, data, cv_wts)
        Bm, Cm = _proj_joint_mv_op(op, Bm.astype(dtype), Cm.astype(dtype),
                                   k + cfg.zkeepn, data.zkeep, cfg.S_entries)
        sel_idx, sel_valid = _col_support_op(op, Bm, cfg.S)
        st = dataclasses.replace(st, B=Bm, C=Cm, B0=Bm, C0=Cm,
                                 sel_idx=sel_idx, sel_valid=sel_valid,
                                 idc=jnp.any(Cm != 0, axis=1))

    BX, CZ = _forward_mv(op, data, st, st.B, st.C, st.sel_idx, st.sel_valid)
    mu = BX + CZ
    resid = _resid(data, mu, cv_wts)
    df, df2 = _score_mv(op, data, st.Gamma, resid)
    st = dataclasses.replace(st, BX=BX, CZ=CZ, mu=mu, resid=resid)

    if not init_beta:
        # initial support from projected score (reference :436-445); like the
        # univariate path the projected score replaces df so the first grad
        # step moves only selected entries
        df_p, df2_p = _proj_joint_mv_op(op, df, df2, k + cfg.zkeepn,
                                        data.zkeep, cfg.S_entries)
        df2_p = jnp.where(data.zkeep[None, None, :], df2, df2_p)
        sel_idx, sel_valid = _col_support_op(op, df_p, cfg.S)
        st = dataclasses.replace(
            st, df=df_p, df2=df2_p, sel_idx=sel_idx, sel_valid=sel_valid,
            idc=jnp.any(df2_p != 0, axis=1))
    else:
        st = dataclasses.replace(st, df=df, df2=df2)
    return st


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _prepare_mv(y, x, z, dtype):
    from ..ops.linalg import make_operator
    op = make_operator(x, dtype=dtype)
    n, n_pad = op.n, op.n_pad
    Y = np.asarray(y, np.float64)
    if Y.ndim != 2 or Y.shape[1] != n:
        raise ValueError(f"multivariate y must be (traits, n={n}); got {Y.shape}")
    r = Y.shape[0]
    if z is None:
        z = np.ones((1, n))
    z = np.asarray(z, np.float64)
    if z.ndim == 1:
        z = z[None, :]
    if z.shape[1] != n:
        raise ValueError(f"multivariate z must be (q, n={n}); got {z.shape}")
    q = z.shape[0]
    Y_pad = np.zeros((r, n_pad))
    Y_pad[:, :n] = Y
    z_pad = np.zeros((n_pad, q))
    z_pad[:n] = z.T
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    return op, jnp.asarray(Y_pad, dtype), jnp.asarray(z_pad, dtype), \
        jnp.asarray(mask, dtype)


def build_mv(y, x, z=None, *, k=10, zkeep=None, tol=1e-4, max_iter=200,
             min_iter=5, max_step=3, dtype=jnp.float32):
    op, Y_pad, z_pad, mask = _prepare_mv(y, x, z, dtype)
    r, q = Y_pad.shape[0], z_pad.shape[1]
    if zkeep is None:
        zkeep_arr = np.ones(q, bool)
    else:
        zkeep_arr = np.asarray(zkeep, bool)
        if zkeep_arr.shape != (q,):
            raise ValueError(f"zkeep must have length {q}")
    zkeepn = r * int(zkeep_arr.sum())    # reference: r * sum(zkeep)
    k_max = int(np.max(k))
    S_entries = min(k_max + zkeepn + r * (q - int(zkeep_arr.sum())),
                    r * (op.p + q))
    S = min(k_max + q, op.p)             # at most k entries -> at most k columns
    data = MvData(Y=Y_pad, z=z_pad, zkeep=jnp.asarray(zkeep_arr),
                  sample_mask=mask, n_true=op.n)
    cfg = MvConfig(dist="mvnormal", link="identity", S=int(S), zkeepn=zkeepn,
                   max_iter=int(max_iter), min_iter=int(min_iter),
                   max_step=int(max_step), tol=float(tol),
                   dtype=str(np.dtype(dtype)), S_entries=int(S_entries))
    return op, data, cfg


def fit_mv_iht(y, x, z=None, k=10, d=None, l=None, verbose=True, tol=1e-4,
               max_iter=200, min_iter=5, max_step=3, zkeep=None, io=None,
               init_beta=False, debias=False, dtype=jnp.float32,
               checkpoint_dir=None, checkpoint_every=20, **kwargs):
    """Multivariate IHT fit (reference fit_iht with MvNormal, src/fit.jl:60).

    y: (r, n) trait-major; x: PackedGenotypes, HostStreamedGenotypes (out-of-
    core, host-stepped) or dense (n, p); z: (q, n)."""
    if int(np.min(k)) < 1:
        raise ValueError("Multivariate IHT requires k >= 1!")
    if debias:
        raise ValueError("Currently the debiasing routine for multivariate "
                         "IHT is broken, sorry!")  # reference multivariate.jl:570
    op, data, cfg, = build_mv(y, x, z, k=k, zkeep=zkeep, tol=tol,
                              max_iter=max_iter, min_iter=min_iter,
                              max_step=max_step, dtype=dtype)
    if verbose:
        from ..utils.printing import print_iht_signature, print_parameters
        print_iht_signature(io)
        print_parameters(io, k, "mvnormal", "identity", False, None, debias,
                         tol, max_iter, min_iter)
    t0 = _time.time()
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    from ..ops.streaming import StreamedPackedOp
    if isinstance(op, StreamedPackedOp):
        # out-of-core matrix: host-stepped driver (the jitted while_loop
        # cannot stream blocks from inside the trace)
        from .mv_streamed import fit_mv_host
        st, Sigma_b, pve_b = fit_mv_host(
            op, data, cfg, jnp.asarray([int(k)]), cv_wts,
            init_beta=init_beta, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, verbose=verbose)
    else:
        st, Sigma_b, pve_b = fit_mv_fused(op, data, cfg, jnp.asarray([int(k)]),
                                          cv_wts, init_beta=init_beta)
    # per-trait PVE (reference pve(v::mIHTVariable), src/pve.jl:36-38);
    # single host round-trip for everything the result needs
    B_h, C_h, logl_h, iters_h, failed_h, Sigma_h, sg_h = jax.device_get(
        (st.B[0], st.C[0], st.best_logl[0], st.iters[0], st.failed[0],
         Sigma_b[0], pve_b[0]))
    tot = _time.time() - t0
    if bool(failed_h):
        raise FloatingPointError("Loglikelihood function is NaN/Inf, aborting...")

    r = data.Y.shape[0]
    result = MIHTResult(
        time=tot, logl=float(logl_h), iter=int(iters_h),
        beta=np.asarray(B_h), c=np.asarray(C_h), k=int(k), traits=r,
        Sigma=np.asarray(Sigma_h), sigma_g=np.asarray(sg_h))
    if verbose:
        # the result block goes to stdout; callers that tee to a file append
        # it themselves (reference wrapper.jl:85 `show(io, result)`)
        print(result)
    return result


def cv_mv_iht(y, x, z=None, path=None, q=5, folds=None, zkeep=None,
              debias=False, verbose=True, max_iter=100, min_iter=5,
              init_beta=False, dtype=jnp.float32, rng=None,
              checkpoint_dir=None, checkpoint_every=20, show_progress=False,
              task_chunk=None, **kwargs):
    """Multivariate cross-validation (reference cv_iht with MvNormal;
    the reference treats uni/mv cv uniformly, src/cross_validation.jl:60 —
    so `checkpoint_dir` / `show_progress` work here like univariate cv)."""
    import sys
    from .cv import allocate_fold_and_k, meanloss
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg = build_mv(y, x, z, k=max(path), zkeep=zkeep,
                             max_iter=max_iter, min_iter=min_iter, dtype=dtype)
    if max(path) > op.p * data.Y.shape[0]:
        raise ValueError("Sparsity level in `path` cannot be larger than "
                         "total number of variables")
    n = op.n
    if folds is None:
        rng = np.random.default_rng() if rng is None else rng
        folds = rng.integers(1, q + 1, size=n)
    folds = np.asarray(folds)
    combos = allocate_fold_and_k(q, path)
    T = len(combos)
    ks = jnp.asarray([kk for _, kk in combos], jnp.int32)
    train = np.zeros((T, op.n_pad), np.float32)
    test = np.zeros((T, op.n_pad), np.float32)
    for i, (fold, _) in enumerate(combos):
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold
    # (fold, k) tasks are independent, so chunking the task batch is exact —
    # it bounds device memory for big grids: each task holds ~32 (r, p) f32
    # arrays live (state quadruple + projection/sort intermediates + XLA
    # live ranges).  Chunks take up to 40% of what the device reports; the
    # CPU backend reports no limit and runs the grid as one chunk.
    T_all = T
    if task_chunk is None:
        from ..utils.device import memory_limit_bytes
        limit = memory_limit_bytes()
        per_task = 32.0 * data.Y.shape[0] * op.p * 4.0
        task_chunk = (T_all if limit is None else
                      max(1, int(0.4 * limit / max(per_task, 1.0))))
    if task_chunk < T_all:
        parts = []
        for lo in range(0, T_all, task_chunk):
            hi = min(lo + task_chunk, T_all)
            if verbose:
                print(f"cv tasks {lo + 1}-{hi} of {T_all}...")
            parts.append(_cv_mv_run(
                op, data, cfg, ks[lo:hi],
                jnp.asarray(train[lo:hi], op.dtype),
                jnp.asarray(test[lo:hi], op.dtype), init_beta,
                checkpoint_dir=(None if checkpoint_dir is None else
                                f"{checkpoint_dir}/chunk{lo}"),
                checkpoint_every=checkpoint_every,
                show_progress=show_progress, verbose=verbose))
        mses = np.concatenate(parts)
    else:
        mses = _cv_mv_run(op, data, cfg, ks, jnp.asarray(train, op.dtype),
                          jnp.asarray(test, op.dtype), init_beta,
                          checkpoint_dir, checkpoint_every, show_progress,
                          verbose)
    mse = meanloss(mses, q, folds)
    best_k = path[int(np.argmin(mse))]
    if verbose:
        print_cv_results(sys.stdout, mse, path, best_k)
    return mse


def _cv_mv_run(op, data, cfg, ks, train, test, init_beta, checkpoint_dir,
               checkpoint_every, show_progress, verbose):
    """One fused (or segmented, when checkpointing/progress is on) solve of
    a task batch; returns the per-task holdout MSEs as numpy."""
    from ..ops.streaming import StreamedPackedOp
    if isinstance(op, StreamedPackedOp):
        from .mv_streamed import cv_mv_host
        return np.asarray(cv_mv_host(
            op, data, cfg, ks, train, test, init_beta=init_beta,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            show_progress=show_progress, verbose=verbose))
    if checkpoint_dir is not None or show_progress:
        return _cv_mv_segmented(op, data, cfg, ks, train, test, init_beta,
                                checkpoint_dir, checkpoint_every,
                                show_progress, verbose)
    return np.asarray(cv_mv_fused(op, data, cfg, ks, train, test,
                                  init_beta=init_beta))


def _cv_mv_segmented(op, data, cfg, ks, train, test, init_beta,
                     checkpoint_dir, checkpoint_every, show_progress,
                     verbose, step=5):
    """Segmented mv cv driver: checkpoints every `checkpoint_every`
    iterations and/or a live converged-task progress display (mirrors the
    univariate _cv_checkpointed/_cv_progress drivers in models/cv.py)."""
    import sys as _sys

    st = init_mv_state(op, data, cfg, ks, train, init_beta=init_beta)
    if checkpoint_dir is not None:
        from ..utils.checkpoint import save_state, restore_state
        restored = restore_state(checkpoint_dir, st)
        if restored is not None:
            st, stp = restored
            if verbose:
                print(f"resuming cross validation from checkpoint step {stp}")

    T = int(ks.shape[0])
    tty = getattr(_sys.stderr, "isatty", lambda: False)()
    seg = checkpoint_every if checkpoint_dir is not None else step
    while True:
        it = int(st.iteration)
        if it >= cfg.max_iter - 1:
            break
        st = run_mv_segment(op, data, cfg, st,
                            min(it + seg, cfg.max_iter - 1))
        n_active = int(np.asarray(jnp.sum(st.active)))
        if checkpoint_dir is not None:
            jax.block_until_ready(st.B)
            save_state(checkpoint_dir, st, int(st.iteration))
            if verbose:
                print(f"checkpoint at iteration {int(st.iteration)}; "
                      f"{n_active} tasks still active")
        if show_progress:
            msg = (f"Cross-validating: iteration {int(st.iteration):4d}, "
                   f"{T - n_active}/{T} models converged")
            if tty:
                print("\r" + msg, end="", file=_sys.stderr, flush=True)
            else:
                print(msg, file=_sys.stderr, flush=True)
        if n_active == 0:
            break
    if show_progress and tty:
        print(file=_sys.stderr)
    st = finalize_mv_iht(op, data, cfg, st)
    return np.asarray(predict_mse_mv(op, data, cfg, st, test))
