"""Host-stepped multivariate IHT driver for out-of-core (streamed) genotype
operators.

Multivariate fits beyond device memory: the reference's
flagship workloads are multivariate at biobank scale (UKBB 3-trait and
18-trait cv, manuscript/UKBB_hyptertension, UKBB_metabolomic) and its mmap
design handles them at any scale on one node
(reference docs/src/man/FAQ.md:31-33).  Here the packed words stay in
host RAM (ops/streaming.py) and the mv iteration is driven from the host,
reusing the SAME step math as the fused mv solver
(`_mv_save_prev` / `_mv_take_step` / `_mv_post_step` / `finalize_mv_iht`) —
identical to the fused path up to float reduction order.  The first-choice
answer at this scale is still the (task, snp) mesh (parallel/); this is the
single-device fallback.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import mv as MV


def _iteration_mv_host(op, data, cfg, st):
    """One mv IHT iteration with a host-level backtracking loop (mirrors
    mv._iteration_mv; the lax.while_loop becomes `while np.any(...)`)."""
    act = st.active
    nsamples = jnp.sum(st.cv_wts, axis=1)
    st = MV._mv_save_prev(st)

    eta = MV._stepsize_full(op, data, st)
    old_logl = st.logl

    cur = MV._mv_take_step(op, data, cfg, st, eta, nsamples)
    n_bt = jnp.zeros_like(eta, dtype=jnp.int32)
    while True:
        need = MV._mv_bt_need(act, old_logl, cur, n_bt, cfg.max_step)
        if not bool(np.any(np.asarray(need))):
            break
        eta = jnp.where(need, eta / 2, eta)
        nxt = MV._mv_take_step(op, data, cfg, st, eta, nsamples)
        cur = {k: MV._where_t(need, nxt[k], cur[k]) for k in cur}
        n_bt = n_bt + need.astype(jnp.int32)

    return MV._mv_post_step(op, data, cfg, st, cur, eta, n_bt)


def run_mv_iht_host(op, data, cfg, st, on_iteration=None):
    """Loop to completion then restore the best model (streamed analog of
    mv.run_mv_iht)."""
    while (bool(np.asarray(jnp.any(st.active)))
           and int(st.iteration) < cfg.max_iter - 1):
        st = _iteration_mv_host(op, data, cfg, st)
        if on_iteration is not None:
            on_iteration(st)
    return MV.finalize_mv_iht.__wrapped__(op, data, cfg, st)


def fit_mv_host(op, data, cfg, ks, cv_wts, init_beta: bool = False,
                checkpoint_dir=None, checkpoint_every: int = 20,
                verbose: bool = False):
    """Streamed equivalent of mv.fit_mv_fused: init + solve + Sigma + pve,
    driven from the host.  A >HBM mv *final fit* on a slow link is hours
    long, so checkpoint/resume works here like the cv drivers."""
    from .pve import masked_var

    st = MV.init_mv_state.__wrapped__(op, data, cfg, ks, cv_wts,
                                      init_beta=init_beta)
    st = _with_checkpointing(op, data, cfg, st, checkpoint_dir,
                             checkpoint_every, verbose, run_mv_iht_host)
    Sigma = jnp.linalg.inv(st.Gamma)
    vy = masked_var(data.Y, data.sample_mask[None, :], data.n_true)
    vm = jnp.stack([masked_var(st.mu[t], data.sample_mask[None, :],
                               data.n_true) for t in range(st.mu.shape[0])])
    return st, Sigma, vm / vy[None]


def cv_mv_host(op, data, cfg, ks, train_wts, test_wts,
               init_beta: bool = False, checkpoint_dir=None,
               checkpoint_every: int = 20, show_progress: bool = False,
               verbose: bool = False):
    """Streamed equivalent of mv.cv_mv_fused with checkpoint/progress (the
    whole (fold, k) grid advances as ONE batch — every streamed X'R pass
    serves the full grid)."""
    import sys as _sys

    st = MV.init_mv_state.__wrapped__(op, data, cfg, ks, train_wts,
                                      init_beta=init_beta)
    T = int(ks.shape[0])
    tty = getattr(_sys.stderr, "isatty", lambda: False)()

    def progress(s):
        if show_progress:
            n_active = int(np.asarray(jnp.sum(s.active)))
            msg = (f"Cross-validating (streamed mv): iteration "
                   f"{int(s.iteration):4d}, {T - n_active}/{T} models "
                   f"converged")
            if tty:
                print("\r" + msg, end="", file=_sys.stderr, flush=True)
            else:
                print(msg, file=_sys.stderr, flush=True)

    st = _with_checkpointing(op, data, cfg, st, checkpoint_dir,
                             checkpoint_every, verbose, run_mv_iht_host,
                             progress=progress)
    if show_progress and tty:
        print(file=_sys.stderr)
    return MV.predict_mse_mv.__wrapped__(op, data, cfg, st, test_wts)


def _with_checkpointing(op, data, cfg, st, checkpoint_dir, checkpoint_every,
                        verbose, runner, progress=None):
    """Shared checkpoint/resume plumbing around a host-stepped solve."""
    if checkpoint_dir is not None:
        from ..utils.checkpoint import save_state, restore_state
        restored = restore_state(checkpoint_dir, st)
        if restored is not None:
            st, step = restored
            if verbose:
                print(f"resuming from checkpoint step {step}")

    def on_iteration(s):
        if progress is not None:
            progress(s)
        it = int(s.iteration)
        if checkpoint_dir is not None and it % checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            jax.block_until_ready(s.B)
            save_state(checkpoint_dir, s, it)
            if verbose:
                print(f"checkpoint at iteration {it}; "
                      f"{int(jnp.sum(s.active))} tasks still active")

    return runner(op, data, cfg, st, on_iteration=on_iteration)
