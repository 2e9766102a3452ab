"""User-facing functional equivalents of reference exports that operate on
plain arrays (reference src/MendelIHT.jl:27-36 export list).

The reference exposes its internal mutating kernels (`loglikelihood`,
`deviance`, `mle_for_r`, `initialize_beta`, ...) on `IHTVariable`; here the
same quantities are pure functions of (distribution, y, mu) so they compose
with jit/vmap.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from .ops import glm
from .ops.negbin import mle_for_r as _mle_for_r


def _prep(d, y, mu):
    dist = glm.dist_name(d)
    y = jnp.asarray(y, jnp.float64 if jnp.asarray(mu).dtype == jnp.float64
                    else jnp.float32).reshape(-1)
    mu = jnp.asarray(mu).reshape(-1)
    nb_r = getattr(d, "r", None)
    return dist, y, mu, nb_r


def loglikelihood(d, y, mu, wts=None):
    """Total loglikelihood of `y` under mean `mu` for distribution `d`
    (reference src/utilities.jl:9-20; dispersion = deviance/n as there)."""
    dist, y, mu, nb_r = _prep(d, y, mu)
    w = jnp.ones_like(y) if wts is None else jnp.asarray(wts, y.dtype)
    return float(glm.loglikelihood(dist, y, mu, w, y.shape[0], nb_r=nb_r))


def deviance(d, y, mu, wts=None):
    """Sum of squared deviance residuals (reference src/utilities.jl:52-61)."""
    dist, y, mu, nb_r = _prep(d, y, mu)
    w = jnp.ones_like(y) if wts is None else jnp.asarray(wts, y.dtype)
    return float(glm.deviance(dist, y, mu, w, nb_r=nb_r))


def score(d, l, y, mu, eta, wts=None):
    """Weighted working residual `W(y - mu)` whose X-projection is the IHT
    gradient (reference score!, src/utilities.jl:126-135)."""
    dist = glm.dist_name(d)
    link = glm.link_name(l)
    y = jnp.asarray(y)
    w = jnp.ones_like(y) if wts is None else jnp.asarray(wts, y.dtype)
    nb_r = getattr(d, "r", None)
    return glm.score_residual(dist, link, y, jnp.asarray(mu),
                              jnp.asarray(eta), w, nb_r=nb_r)


def mle_for_r(y, mu, r=1.0, est_r="Newton"):
    """Maximum-likelihood update of the negative-binomial nuisance `r`
    (reference src/utilities.jl:141-247; `:MM` update_r_MM :158-173,
    `:Newton` update_r_newton :180-247)."""
    y = jnp.asarray(y, jnp.float32).reshape(-1)
    mu = jnp.asarray(mu, jnp.float32).reshape(1, -1)
    mask = jnp.ones_like(y)
    r0 = jnp.full((1,), float(r), jnp.float32)
    method = str(est_r).lower().strip(":")
    out = _mle_for_r(method, y, mu, r0, mask, mask[None, :], y.shape[0])
    return float(out[0])


def initialize_beta(y, x, z=None, dtype=jnp.float32):
    """Marginal univariate-regression warm start: per SNP j, regress y on
    [1, x_j]; returns (b, c) slopes/intercept estimates (reference
    initialize_beta!, src/utilities.jl:776-812)."""
    from .models.fit import build_fit
    from .models.initialize import _initialize_beta

    op, data, cfg, _ = build_fit(y, x, z, k=1, dtype=dtype)
    cv_wts = data.sample_mask[None, :].astype(op.dtype)
    b, c = _initialize_beta(op, data, cv_wts)
    return np.asarray(b[0]), np.asarray(c[0])


def cv_iht_distribute_fold(d, l, x, z, y, J, path, q, *, destin="./",
                           folds=None, debias=False, parallel=True,
                           showinfo=False, max_iter=100, dtype=jnp.float32,
                           rng=None):
    """Legacy distributed-CV entry point (reference exports it at
    src/MendelIHT.jl:28; used by figures/ukbiobank/distribute_folds.jl:91,130
    with per-fold scratch files).

    Realisation here: all (fold, k) tasks run as one batched solve (they
    fan out over the device mesh's task axis rather than over worker
    processes); per-fold MSE vectors are additionally written to
    `destin/cviht_fold{i}.txt` to mirror the legacy scatter-gather workflow.
    Returns the fold-size-weighted mean-loss vector like `cv_iht`."""
    from .models.cv import cv_iht, meanloss, allocate_fold_and_k
    from .models.fit import build_fit
    from .models.initialize import init_state
    from .models.univariate import run_iht, predict_deviance

    path = list(path)
    op, data, cfg, _ = build_fit(y, x, z, k=max(path), J=J, d=d, l=l,
                                 debias=debias, max_iter=max_iter, dtype=dtype)
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

    st = init_state(op, data, cfg, ks, jnp.asarray(train, op.dtype))
    st = run_iht(op, data, cfg, st)
    mses = np.asarray(predict_deviance(op, data, cfg, st,
                                       jnp.asarray(test, op.dtype)),
                      np.float64)

    os.makedirs(destin, exist_ok=True)
    per_fold = mses.reshape(q, len(path))
    for i in range(q):
        np.savetxt(os.path.join(destin, f"cviht_fold{i + 1}.txt"),
                   np.column_stack([path, per_fold[i]]),
                   header="k\tmse", comments="", delimiter="\t")
    return meanloss(mses, q, folds)
