"""Public `fit_iht` (reference src/fit.jl:60-127) plus the batched entry used
by cross-validation."""

from __future__ import annotations

import time as _time

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import glm
from ..ops.linalg import make_operator, PackedOp
from ..genotype.snparray import PackedGenotypes
from .state import FitConfig, FitData
from .initialize import init_state
from .univariate import run_iht, fit_fused, fit_fused_sparse
from .pve import pve as _pve, masked_var
from .results import IHTResult


def is_multivariate(y) -> bool:
    """Reference src/multivariate.jl:481-483."""
    y = np.asarray(y)
    return y.ndim == 2 and y.shape[0] > 1 and y.shape[1] > 1


def checky(y, dist: str):
    """Response-range validation (the reference imports GLM.checky)."""
    y = np.asarray(y)
    if dist == "bernoulli" and not np.all((y == 0) | (y == 1)):
        raise ValueError("Bernoulli responses must be 0 or 1")
    if dist in ("poisson", "negativebinomial") and np.any(y < 0):
        raise ValueError(f"{dist} responses must be nonnegative")
    if dist in ("gamma", "inversegaussian") and np.any(y <= 0):
        raise ValueError(f"{dist} responses must be positive")


def check_group(k, group):
    """Reference src/utilities.jl:902-915."""
    if isinstance(k, (list, tuple, np.ndarray)):
        group = np.asarray(group)
        if group.size <= 1:
            raise ValueError("Doubly sparse projection specified (k is a "
                             "vector) but there is no group information.")
        for i, ki in enumerate(np.asarray(k), start=1):
            members = int((group == i).sum())
            if members < ki:
                raise ValueError(f"Maximum predictors for group {i} was {ki} "
                                 f"but the group has only {members} predictors.")
    else:
        if k < 0:
            raise ValueError("Value of k (max predictors per group) must be nonnegative!")


def _prepare_univariate(y, x, z, dtype):
    """Build operator + padded per-sample arrays."""
    op = make_operator(x, dtype=dtype)
    n, n_pad = op.n, op.n_pad
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if len(y) != n:
        raise ValueError(f"length(y)={len(y)} but x has {n} samples")
    if z is None:
        z = np.ones((n, 1))
    z = np.asarray(z, dtype=np.float64)
    if z.ndim == 1:
        z = z[:, None]
    if z.shape[0] != n:
        raise ValueError(f"z has {z.shape[0]} rows but x has {n} samples")
    y_pad = np.zeros(n_pad)
    y_pad[:n] = y
    z_pad = np.zeros((n_pad, z.shape[1]))
    z_pad[:n] = z
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    # host arrays: build_fit packs them into ONE device transfer
    return op, y_pad, z_pad, mask


# Re-fitting the same problem (hyperparameter sweeps, repeated API calls on
# one dataset) should not pay host prep + device transfers every time: the
# built (op, data, cfg) is cached keyed on the genotype object IDENTITY plus
# content hashes of the small arrays.  Identity is checked with `is` against
# a kept strong reference, so a recycled id() can never alias.
_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 4


def _content_key(a):
    if a is None:
        return None
    import hashlib
    a = np.ascontiguousarray(np.asarray(a))
    return (a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest())


def build_fit(y, x, z=None, *, k=10, J=1, d=None, l=None, group=None,
              weight=None, zkeep=None, est_r="none", debias=False,
              tol=1e-4, max_iter=200, min_iter=5, max_step=3,
              S=None, dtype=jnp.float32):
    """Shared setup: returns (op, data, cfg, ks_default)."""
    d = d if d is not None else glm.Normal()
    try:
        key = (id(x), _content_key(y), _content_key(z), _content_key(group),
               _content_key(weight), _content_key(zkeep),
               tuple(np.asarray(k).reshape(-1).tolist()), J,
               glm.dist_name(d), glm.link_name(l) if l is not None else None,
               str(est_r), bool(debias), float(tol), int(max_iter),
               int(min_iter), int(max_step), S, str(np.dtype(dtype)))
    except Exception:
        key = None
    if key is not None and key in _BUILD_CACHE:
        x_ref, cached = _BUILD_CACHE[key]
        if x_ref is x:
            return cached
    out = _build_fit_uncached(y, x, z, k=k, J=J, d=d, l=l, group=group,
                              weight=weight, zkeep=zkeep, est_r=est_r,
                              debias=debias, tol=tol, max_iter=max_iter,
                              min_iter=min_iter, max_step=max_step, S=S,
                              dtype=dtype)
    if key is not None:
        if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
            _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
        _BUILD_CACHE[key] = (x, out)
    return out


def _build_fit_uncached(y, x, z=None, *, k=10, J=1, d=None, l=None,
                        group=None, weight=None, zkeep=None, est_r="none",
                        debias=False, tol=1e-4, max_iter=200, min_iter=5,
                        max_step=3, S=None, dtype=jnp.float32):
    dist = glm.dist_name(d)
    link = glm.link_name(l) if l is not None else glm._CANONICAL[dist]
    checky(y, dist)

    op, y_pad, z_pad, mask = _prepare_univariate(y, x, z, dtype)
    p, q = op.p, z_pad.shape[1]

    if zkeep is None:
        zkeep_arr = np.ones(q, bool)
    else:
        zkeep_arr = np.asarray(zkeep, bool)
        if zkeep_arr.shape != (q,):
            raise ValueError(f"zkeep must have length {q}")
    zkeepn = int(zkeep_arr.sum())

    use_group = group is not None and np.asarray(group).size > 0
    group_k_is_vector = isinstance(k, (list, tuple, np.ndarray))
    if use_group or group_k_is_vector:
        check_group(k, group if group is not None else np.asarray([]))
    if use_group:
        group_arr = np.asarray(group, np.int32)
        if group_arr.shape != (p,):
            raise ValueError(f"group must have length {p}")
        n_groups = int(group_arr.max())
        if group_k_is_vector:
            gks = np.asarray(k, np.int32)
            k_scalar = int(np.sum(gks))
            # sharded-projection candidate budget: a shard-local per-group
            # top-k keeps at most sum(ks) entries
            group_cand = min(p, int(np.sum(gks)))
        else:
            gks = np.full(n_groups, int(k), np.int32)
            k_scalar = int(J) * int(k)
            group_cand = min(p, n_groups * int(k))
    else:
        # placeholder: data.group is only read when cfg.use_group (static), so
        # skip shipping a p-length array to the device on every fit
        group_arr = np.ones(1, np.int32)
        n_groups = 1
        gks = np.asarray([0], np.int32)
        k_scalar = int(k)
        group_cand = 0

    has_weight = weight is not None and np.asarray(weight).size > 0
    if has_weight:
        w = np.asarray(weight, np.float64).reshape(-1)
        if w.shape[0] == p:
            w = np.concatenate([w, np.ones(q)])
        if w.shape[0] != p + q:
            raise ValueError(f"weight must have length {p} or {p + q}")
    else:
        # placeholder like `group`: data.weight is only read when
        # cfg.has_weight (static) — don't ship a (p+q) ones array per fit
        w = np.ones(1)

    if S is None:
        S = min(k_scalar + zkeepn + (q - zkeepn), p + q)
        S = max(S, 1)

    # single host->device transfer for all per-sample arrays + one for the
    # small aux vectors: per-transfer latency otherwise dominates warm
    # small-fit wall time
    np_dtype = np.dtype(dtype)
    stack = np.concatenate([np.asarray(y_pad)[:, None],
                            np.asarray(mask)[:, None],
                            np.asarray(z_pad)], axis=1).astype(np_dtype)
    dstack = jnp.asarray(stack)
    y_d, mask_d, z_d = dstack[:, 0], dstack[:, 1], dstack[:, 2:]
    if use_group or has_weight:
        # real group ids / user weights ship in their native dtypes: f32
        # packing would corrupt group ids >= 2^24 and silently truncate
        # float64 weights (changing projection tie-breaks)
        daux = jnp.asarray(zkeep_arr.astype(np.float32))
        group_d = jnp.asarray(group_arr.astype(np.int32))
        gks_d = jnp.asarray(gks.astype(np.int32))
        w_d = jnp.asarray(w.astype(np_dtype))
    else:
        # placeholder case (the common path): zkeep bools plus the three
        # size-1 placeholders are exactly representable in f32, so one
        # packed transfer saves two host->device RPC round-trips
        aux = np.concatenate([zkeep_arr.astype(np.float32),
                              group_arr.astype(np.float32),
                              gks.astype(np.float32),
                              w.astype(np.float32)])
        daux_all = jnp.asarray(aux)
        o2 = q + group_arr.shape[0]
        o3 = o2 + gks.shape[0]
        daux = daux_all[:q]
        group_d = daux_all[q:o2].astype(jnp.int32)
        gks_d = daux_all[o2:o3].astype(jnp.int32)
        w_d = daux_all[o3:].astype(dtype)
    data = FitData(
        y=y_d, z=z_d, zkeep=daux.astype(bool),
        weight=w_d, group=group_d, group_ks=gks_d,
        sample_mask=mask_d, n_true=op.n,
    )
    cfg = FitConfig(
        dist=dist, link=link, S=int(S), zkeepn=zkeepn, max_iter=int(max_iter),
        min_iter=int(min_iter), max_step=int(max_step), tol=float(tol),
        est_r=("none" if est_r in (None, "none", ":None") else
               str(est_r).lower().strip(":")),
        debias=bool(debias), use_group=bool(use_group), J=int(J),
        n_groups=n_groups, group_k_is_vector=group_k_is_vector,
        group_cand=group_cand,
        has_weight=bool(has_weight), dtype=str(np.dtype(dtype)),
    )
    return op, data, cfg, k_scalar


def fit_iht(y, x, z=None, k=10, J=1, d=None, l=None, group=None, weight=None,
            zkeep=None, est_r="none", use_maf=False, debias=False,
            verbose=True, tol=1e-4, max_iter=200, min_iter=5, max_step=3,
            io=None, init_beta=False, memory_efficient=True,
            dtype=jnp.float32, checkpoint_dir=None, checkpoint_every=20):
    """Fit one IHT model at sparsity k (reference src/fit.jl:60-118).

    `x` may be a PackedGenotypes (standardization + mean-imputation applied on
    the fly) or a dense (n, p) matrix used verbatim.  For multivariate traits
    pass y with shape (r, n) and x/z with samples as columns — see
    `models.mv`. ``memory_efficient`` is accepted for API parity (all code
    paths here are memory-efficient by construction).

    ``checkpoint_dir`` / ``checkpoint_every`` apply to out-of-core (streamed)
    fits, which on a slow host link can run for hours: a killed fit resumes
    from the last checkpoint (the resident fused path is a single compiled
    program — seconds, not hours — and ignores them)."""
    if is_multivariate(y):
        # out-of-core (HostStreamedGenotypes) matrices route to the
        # host-stepped mv driver inside fit_mv_iht (models/mv_streamed.py)
        from .mv import fit_mv_iht
        return fit_mv_iht(y, x, z, k=k, d=d, verbose=verbose, tol=tol,
                          max_iter=max_iter, min_iter=min_iter,
                          max_step=max_step, zkeep=zkeep, io=io,
                          init_beta=init_beta, debias=debias, dtype=dtype,
                          checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every)

    d = d if d is not None else glm.Normal()
    if glm.dist_name(d) != "negativebinomial" and cfg_est_r_requested(est_r):
        raise ValueError("Only negative binomial regression supports "
                         "nuisance parameter estimation")
    op, data, cfg, k_scalar = build_fit(
        y, x, z, k=k, J=J, d=d, l=l, group=group, weight=weight, zkeep=zkeep,
        est_r=est_r, debias=debias, tol=tol, max_iter=max_iter,
        min_iter=min_iter, max_step=max_step, dtype=dtype)
    if init_beta and cfg.dist != "normal":
        raise ValueError("Initializing beta values only works for Gaussian "
                         "phenotypes! Sorry!")
    if verbose:
        import dataclasses as _dc
        from ..utils.printing import print_iht_signature, print_parameters
        print_iht_signature(io)
        print_parameters(io, k, cfg.dist, cfg.link, use_maf, group, debias,
                         tol, max_iter, min_iter)
        if io is None:
            # live per-iteration lines stream from the device (jax.debug.print)
            cfg = _dc.replace(cfg, log_iters=True)

    t0 = _time.time()
    # per-task k carries the reference's `v.k` semantics: the per-group cap in
    # scalar-k group mode, the total sparsity otherwise (utilities.jl:255)
    if cfg.group_k_is_vector:
        k_task = 0
    elif cfg.use_group:
        k_task = int(k)
    else:
        k_task = k_scalar
    ks = jnp.asarray([k_task], jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    from ..ops.streaming import StreamedPackedOp
    if isinstance(op, StreamedPackedOp):
        # out-of-core matrix: host-stepped driver (the jitted while_loop
        # cannot stream blocks from inside the trace); per-iteration lines
        # print via cfg.log_iters, and tee to `io` when given (same as the
        # resident teed path below)
        from .streamed import fit_fused_sparse_host
        sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg = \
            fit_fused_sparse_host(op, data, cfg, ks, cv_wts,
                                  init_beta=init_beta,
                                  io=(io if verbose else None),
                                  checkpoint_dir=checkpoint_dir,
                                  checkpoint_every=checkpoint_every,
                                  verbose=verbose)
    elif verbose and io is not None:
        # teed mode (reference fit.jl:194-196 writes the progress lines to
        # `io` AND stdout): step the solver one iteration at a time so the
        # host can write each line. `stop` is traced — no recompiles.
        sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg = \
            _fit_teed(op, data, cfg, ks, cv_wts, init_beta, io)
    else:
        sel_idx, sel_valid, sel_bc, c, logl, iters, failed, sg = \
            fit_fused_sparse(op, data, cfg, ks, cv_wts, init_beta=init_beta)
    # single host round-trip, sparse: ~S floats instead of the dense (p,) beta
    (sel_idx_h, sel_valid_h, sel_bc_h, c_h, logl_h, iters_h, failed_h,
     sg_h) = jax.device_get((sel_idx[0], sel_valid[0], sel_bc[0], c[0],
                             logl[0], iters[0], failed[0], sg[0]))
    b_h = np.zeros(op.p, np.asarray(sel_bc_h).dtype)
    is_g = sel_valid_h & (sel_idx_h < op.p)
    b_h[sel_idx_h[is_g]] = sel_bc_h[is_g]
    tot_time = _time.time() - t0

    if bool(failed_h):
        raise FloatingPointError("Loglikelihood function is NaN/Inf, aborting...")

    result = IHTResult(
        time=tot_time, logl=float(logl_h), iter=int(iters_h),
        beta=np.asarray(b_h), c=np.asarray(c_h), J=J,
        k=(list(np.asarray(k)) if cfg.group_k_is_vector else int(k)),
        group=(np.asarray(group) if group is not None else np.array([], int)),
        d=d, sigma_g=float(sg_h))
    if verbose:
        # the result block goes to stdout; callers that tee to a file append
        # it themselves (reference wrapper.jl:85 `show(io, result)`)
        print(result)
    return result


def _fit_teed(op, data, cfg, ks, cv_wts, init_beta, io):
    """Segmented solve with per-iteration progress lines written to `io` and
    stdout (reference fit.jl:194-196); returns fit_fused_sparse's tuple."""
    from .univariate import run_segment, progress_stats, finalize_sparse

    st = init_state(op, data, cfg, ks, cv_wts, init_beta=init_beta)
    for it in range(1, cfg.max_iter):
        st = run_segment(op, data, cfg, st, it)
        logl, bt, tol, any_active = jax.device_get(progress_stats(cfg, st))
        line = (f"Iteration {it}: loglikelihood = {float(logl[0])}, "
                f"backtracks = {int(bt[0])}, tol = {float(tol[0])}")
        print(line, file=io)
        print(line)
        if not bool(any_active):
            break
    return jax.device_get(finalize_sparse(op, data, cfg, st))


def cfg_est_r_requested(est_r):
    return est_r not in (None, "none", ":None", "None")
