"""Cross-validation over (fold, sparsity) combinations
(reference src/cross_validation.jl:60-131, :217-223, :279-320).

Design: the reference fans (fold, k) combinations out to CPU threads with
per-thread preallocated state; here the combinations form the *batch axis* of
one jitted solver — every score pass is a single multi-RHS decode-matmul for
all combinations at once, and fold masking uses the reference's own 0/1
`cv_wts` trick so no genotype data ever moves."""

from __future__ import annotations

import time as _time
import sys

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import glm
from .fit import build_fit, is_multivariate, cfg_est_r_requested
from .initialize import init_state
from .univariate import run_iht, predict_deviance, cv_fused
from .results import print_cv_results, print_a_bunch_of_path_results


def allocate_fold_and_k(q: int, path):
    """All (fold, k) combinations (reference src/cross_validation.jl:217-223)."""
    return [(fold, k) for fold in range(1, q + 1) for k in path]


def meanloss(fitloss, q, folds):
    """Fold-size weighted average of per-combination losses
    (reference src/cross_validation.jl:304-320)."""
    fitloss = np.asarray(fitloss, np.float64)
    folds = np.asarray(folds)
    ninfold = np.bincount(folds, minlength=q + 1)[1:]
    pathsize = len(fitloss) // q
    loss = np.zeros(pathsize)
    for j in range(q):
        w = ninfold[j] / len(folds)
        loss += fitloss[j * pathsize:(j + 1) * pathsize] * w
    return loss


def cv_iht(y, x, z=None, d=None, l=None, path=None, q=5, est_r="none",
           group=None, weight=None, zkeep=None, folds=None, debias=False,
           verbose=True, max_iter=100, min_iter=5, init_beta=False,
           memory_efficient=True, dtype=jnp.float32, rng=None,
           checkpoint_dir=None, checkpoint_every=20, show_progress=False):
    """q-fold cross validation over a path of sparsity levels; returns the
    vector of fold-size-weighted holdout deviances per k (reference
    src/cross_validation.jl:60-131)."""
    if is_multivariate(y):
        from .mv import cv_mv_iht
        return cv_mv_iht(y, x, z, path=path, q=q, folds=folds, zkeep=zkeep,
                         debias=debias, verbose=verbose, max_iter=max_iter,
                         min_iter=min_iter, init_beta=init_beta, dtype=dtype,
                         rng=rng, checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every,
                         show_progress=show_progress)

    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(
        y, x, z, k=max(path), J=1, d=d, l=l, group=group, weight=weight,
        zkeep=zkeep, est_r=est_r, debias=debias, max_iter=max_iter,
        min_iter=min_iter, dtype=dtype)
    if max(path) > op.p:
        raise ValueError("Sparsity level in `path` cannot be larger than "
                         "total number of variables")

    n = op.n
    if folds is None:
        rng = np.random.default_rng() if rng is None else rng
        folds = rng.integers(1, q + 1, size=n)
    folds = np.asarray(folds)

    combos = allocate_fold_and_k(q, path)
    B = len(combos)
    ks = jnp.asarray([k for _, k in combos], jnp.int32)
    train = np.zeros((B, op.n_pad), np.float32)
    test = np.zeros((B, op.n_pad), np.float32)
    for i, (fold, _) in enumerate(combos):
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold

    t0 = _time.time()
    from ..ops.streaming import StreamedPackedOp
    if isinstance(op, StreamedPackedOp):
        # out-of-core matrix: host-stepped grid solve (every streamed X'R
        # pass still serves the whole (fold, k) batch); checkpointing and
        # progress run inside the host-stepped loop
        from .streamed import cv_fused_host
        mses = np.asarray(cv_fused_host(op, data, cfg, ks,
                                        jnp.asarray(train, op.dtype),
                                        jnp.asarray(test, op.dtype),
                                        init_beta=init_beta,
                                        checkpoint_dir=checkpoint_dir,
                                        checkpoint_every=checkpoint_every,
                                        show_progress=show_progress,
                                        verbose=verbose))
    elif checkpoint_dir is not None:
        mses = _cv_checkpointed(op, data, cfg, ks, train, test, init_beta,
                                checkpoint_dir, checkpoint_every, verbose)
    elif show_progress:
        mses = _cv_progress(op, data, cfg, ks, train, test, init_beta)
    else:
        mses = np.asarray(cv_fused(op, data, cfg, ks,
                                   jnp.asarray(train, op.dtype),
                                   jnp.asarray(test, op.dtype),
                                   init_beta=init_beta))
    elapsed = _time.time() - t0

    mse = meanloss(mses, q, folds)
    best_k = path[int(np.argmin(mse))]
    if verbose:
        print_cv_results(sys.stdout, mse, path, best_k)
        print(f"Cross validation took {elapsed:.3f} seconds")
    return mse


def _cv_progress(op, data, cfg, ks, train, test, init_beta, step=5):
    """Segmented solve with a live progress display to stderr (the reference's
    ProgressMeter over (fold, k) fits, src/cross_validation.jl:95; here tasks
    converge in lockstep so progress = converged-task count per iteration)."""
    from .univariate import run_segment, finalize_iht, predict_deviance

    B = int(ks.shape[0])
    # \r-style live updates only on an interactive terminal; when stderr is
    # redirected to a logfile emit plain lines instead (the reference's
    # ProgressMeter degrades the same way, src/cross_validation.jl:95)
    tty = getattr(sys.stderr, "isatty", lambda: False)()
    st = init_state(op, data, cfg, ks, jnp.asarray(train, op.dtype),
                    init_beta=init_beta)
    while True:
        it = int(st.iteration)
        if it >= cfg.max_iter - 1:
            break
        st = run_segment(op, data, cfg, st, min(it + step, cfg.max_iter - 1))
        n_active = int(np.asarray(jnp.sum(st.active)))
        msg = (f"Cross-validating: iteration {int(st.iteration):4d}, "
               f"{B - n_active}/{B} models converged")
        if tty:
            print("\r" + msg, end="", file=sys.stderr, flush=True)
        else:
            print(msg, file=sys.stderr, flush=True)
        if n_active == 0:
            break
    if tty:
        print(file=sys.stderr)
    st = finalize_iht(op, data, cfg, st)
    return np.asarray(predict_deviance(op, data, cfg, st,
                                       jnp.asarray(test, op.dtype)))


def _cv_checkpointed(op, data, cfg, ks, train, test, init_beta,
                     checkpoint_dir, checkpoint_every, verbose):
    """Segmented solve with checkpoints every `checkpoint_every`
    iterations; resumes from the latest checkpoint if one exists."""
    from .initialize import init_state
    from .univariate import run_segment, finalize_iht, predict_deviance
    from ..utils.checkpoint import save_state, restore_state

    st = init_state(op, data, cfg, ks, jnp.asarray(train, op.dtype),
                    init_beta=init_beta)
    restored = restore_state(checkpoint_dir, st)
    if restored is not None:
        st, step = restored
        if verbose:
            print(f"resuming cross validation from checkpoint step {step}")
    while bool(jnp.any(st.active)) and int(st.iteration) < cfg.max_iter - 1:
        stop = min(int(st.iteration) + checkpoint_every, cfg.max_iter - 1)
        st = run_segment(op, data, cfg, st, stop)
        jax.block_until_ready(st.b)
        save_state(checkpoint_dir, st, int(st.iteration))
        if verbose:
            n_active = int(jnp.sum(st.active))
            print(f"checkpoint at iteration {int(st.iteration)}; "
                  f"{n_active} tasks still active")
    st = finalize_iht(op, data, cfg, st)
    return np.asarray(predict_deviance(op, data, cfg, st,
                                       jnp.asarray(test, op.dtype)))


def iht_run_many_models(y, x, z=None, d=None, l=None, path=None, est_r="none",
                        group=None, weight=None, use_maf=False, debias=False,
                        verbose=True, parallel=True, max_iter=100,
                        dtype=jnp.float32):
    """Fit every k in `path` on the full data (no holdout) and return the
    loglikelihoods (reference src/cross_validation.jl:232-277). All models run
    as one batch."""
    if not parallel:
        import warnings
        warnings.warn(
            "iht_run_many_models(parallel=False) is ignored: all path models "
            "run as one batched device program (inherently parallel); there is "
            "no serial mode.", stacklevel=2)
    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(
        y, x, z, k=max(path), J=1, d=d, l=l, group=group, weight=weight,
        est_r=est_r, debias=debias, max_iter=max_iter, dtype=dtype)

    B = len(path)
    ks = jnp.asarray(path, jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (B, op.n_pad))
    st = init_state(op, data, cfg, ks, cv_wts)
    st = run_iht(op, data, cfg, st)
    logls = np.asarray(st.best_logl, np.float64)
    if verbose:
        print_a_bunch_of_path_results(sys.stdout, logls, path)
    return logls
