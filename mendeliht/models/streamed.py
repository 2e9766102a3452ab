"""Host-stepped IHT driver for out-of-core (streamed) genotype operators.

The production solver is ONE jitted `lax.while_loop` (univariate.py) — it
cannot call host code from inside the trace, so an operator whose `X'R`
streams SNP blocks host->device (ops/streaming.py) needs the iteration
driven from the host.  This driver reuses the SAME step math
(`_save_prev` / `_take_step` / `_post_step` / `finalize_iht`) executed
eagerly, with the bounded backtracking line search as a host loop — the
algorithm is bit-for-bit the reference's (src/fit.jl:145-263), identical to
the fused path up to float reduction order.

Supports the full univariate feature set (all GLMs, NB nuisance, group /
doubly-sparse projection, weights, zkeep, debias) — those pieces are
op-free or use only the operator contract.  Multivariate traits have their
own host-stepped twin in models/mv_streamed.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .state import FitConfig, FitData, IHTState
from . import univariate as U


def _iteration_host(op, data: FitData, cfg: FitConfig, st: IHTState) -> IHTState:
    """One IHT iteration with a host-level backtracking loop (mirrors
    univariate._iteration; the lax.while_loop becomes `while np.any(...)`)."""
    act = st.active
    st = U._save_prev(st)

    eta = U._stepsize(op, data, cfg, st)
    old_logl = st.logl

    cur = U._take_step(op, data, cfg, st, eta)
    n_bt = jnp.zeros_like(eta, dtype=jnp.int32)
    while True:
        need = U._bt_need(act, old_logl, cur, n_bt, cfg.max_step)
        if not bool(np.any(np.asarray(need))):
            break
        eta = jnp.where(need, eta / 2, eta)
        nxt = U._take_step(op, data, cfg, st, eta)
        cur = {k: U._where_b(need, nxt[k], cur[k]) for k in cur}
        n_bt = n_bt + need.astype(jnp.int32)

    return U._post_step(op, data, cfg, st, cur, eta, n_bt)


def run_iht_host(op, data: FitData, cfg: FitConfig, st: IHTState,
                 on_iteration=None) -> IHTState:
    """Loop to completion then restore the best model (streamed analog of
    univariate.run_iht).  ``on_iteration(st)`` — if given — runs after every
    accepted iteration (progress lines, checkpoints); the driver steps
    eagerly so host observation is free."""
    while (bool(np.asarray(jnp.any(st.active)))
           and int(st.iteration) < cfg.max_iter - 1):
        st = _iteration_host(op, data, cfg, st)
        if on_iteration is not None:
            on_iteration(st)
    return U.finalize_iht.__wrapped__(op, data, cfg, st)


def fit_fused_sparse_host(op, data: FitData, cfg: FitConfig, ks, cv_wts,
                          init_beta: bool = False, io=None,
                          checkpoint_dir=None, checkpoint_every: int = 20,
                          verbose: bool = False):
    """Streamed equivalent of univariate.fit_fused_sparse: init + solve +
    finalize + pve + sparse extraction, driven from the host.  When ``io`` is
    given, per-iteration progress lines tee to it AND stdout — same format as
    the resident teed path (reference src/fit.jl:194-196).

    A final fit beyond device memory can run for hours over a slow host
    link, so ``checkpoint_dir`` gives it the same
    kill-and-resume safety as cv_fused_host — a restored state continues
    bit-exactly (the host driver is deterministic given the state)."""
    import jax as _jax
    from .initialize import init_state
    from .pve import pve as _pve

    tee = None
    if io is not None:
        def tee(s):
            logl, bt, tol, _ = _jax.device_get(
                U.progress_stats.__wrapped__(cfg, s))
            line = (f"Iteration {int(s.iteration)}: loglikelihood = "
                    f"{float(logl[0])}, backtracks = {int(bt[0])}, "
                    f"tol = {float(tol[0])}")
            print(line, file=io)
            print(line)

    st = init_state.__wrapped__(op, data, cfg, ks, cv_wts,
                                init_beta=init_beta)
    if checkpoint_dir is not None:
        from ..utils.checkpoint import restore_state
        restored = restore_state(checkpoint_dir, st)
        if restored is not None:
            st, step = restored
            if verbose:
                print(f"resuming streamed fit from checkpoint step {step}")

    def on_iteration(s):
        if tee is not None:
            tee(s)
        it = int(s.iteration)
        if checkpoint_dir is not None and it % checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            _jax.block_until_ready(s.b)
            save_state(checkpoint_dir, s, it)
            if verbose:
                print(f"checkpoint at iteration {it}")

    st = run_iht_host(op, data, cfg, st, on_iteration=on_iteration)
    sigma_g = jnp.stack([_pve(data.y, st.mu[b], data.sample_mask, data.n_true)
                         for b in range(st.mu.shape[0])])
    return U._sparse_extract(st, sigma_g)


def cv_fused_host(op, data: FitData, cfg: FitConfig, ks, train_wts, test_wts,
                  init_beta: bool = False, checkpoint_dir=None,
                  checkpoint_every: int = 20, show_progress: bool = False,
                  verbose: bool = False):
    """Streamed equivalent of univariate.cv_fused: the whole (fold, k) grid
    still advances as ONE batch — every streamed X'R pass serves the full
    grid — with holdout deviance scoring at the end.

    Out-of-core cv runs are exactly where resumability matters (UKB-scale
    grids run for hours), so ``checkpoint_dir``/``show_progress`` work here
    like the resident segmented drivers (models/cv.py)."""
    import sys as _sys
    import jax as _jax
    from .initialize import init_state

    st = init_state.__wrapped__(op, data, cfg, ks, train_wts,
                                init_beta=init_beta)
    if checkpoint_dir is not None:
        from ..utils.checkpoint import save_state, restore_state
        restored = restore_state(checkpoint_dir, st)
        if restored is not None:
            st, step = restored
            if verbose:
                print(f"resuming cross validation from checkpoint step {step}")

    B = int(ks.shape[0])
    tty = getattr(_sys.stderr, "isatty", lambda: False)()

    def on_iteration(s):
        it = int(s.iteration)
        if show_progress:
            n_active = int(np.asarray(jnp.sum(s.active)))
            msg = (f"Cross-validating (streamed): iteration {it:4d}, "
                   f"{B - n_active}/{B} models converged")
            if tty:
                print("\r" + msg, end="", file=_sys.stderr, flush=True)
            else:
                print(msg, file=_sys.stderr, flush=True)
        if checkpoint_dir is not None and it % checkpoint_every == 0:
            _jax.block_until_ready(s.b)
            save_state(checkpoint_dir, s, it)
            if verbose:
                print(f"checkpoint at iteration {it}; "
                      f"{int(jnp.sum(s.active))} tasks still active")

    st = run_iht_host(op, data, cfg, st, on_iteration=on_iteration)
    if show_progress and tty:
        print(file=_sys.stderr)
    return U.predict_deviance.__wrapped__(op, data, cfg, st, test_wts)
