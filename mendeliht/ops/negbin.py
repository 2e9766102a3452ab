"""Negative-binomial nuisance parameter (r) estimation: MM and Newton.

Reference: src/utilities.jl:141-247 (`mle_for_r`, `update_r_MM`,
`update_r_newton`).  Batched over the task axis; the inner counting sum
``sum_{j=0}^{y-1} r/(r+j)`` is evaluated in closed form via digamma:
``r * (psi(r+y) - psi(r))`` instead of a data-dependent loop (static shapes).

Reference quirks replicated on purpose:
  * derivative sums ignore the cross-validation mask (the reference loops over
    all samples) — only the linesearch loglikelihood is cv-weighted;
  * the Newton linesearch step size persists across outer iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, polygamma

from . import glm


def update_r_mm(y, mu, r, sample_mask):
    """One MM update of r (reference src/utilities.jl:158-173).

    y (n_pad,), mu (B, n_pad), r (B,), sample_mask (n_pad,) -> (B,).
    """
    yb = y[None, :]
    num = r[:, None] * (digamma(r[:, None] + yb) - digamma(r[:, None]))
    num = jnp.sum(num * sample_mask[None, :], axis=1)
    den = jnp.sum(jnp.log(r[:, None] / (r[:, None] + mu)) * sample_mask[None, :],
                  axis=1)
    return -num / den


def _d1(y, mu, r, mask):
    t = (-(y + r) / (mu + r) - jnp.log(mu + r) + 1.0 + jnp.log(r)
         + digamma(r + y) - digamma(r))
    return jnp.sum(t * mask, axis=-1)


def _d2(y, mu, r, mask):
    t = ((y + r) / (mu + r) ** 2 - 2.0 / (mu + r) + 1.0 / r
         + polygamma(1, r + y) - polygamma(1, r))
    return jnp.sum(t * mask, axis=-1)


def update_r_newton(y, mu, r, sample_mask, cv_wts, n_true,
                    max_iter=100, conv_tol=1e-6):
    """Newton update with backtracking linesearch
    (reference src/utilities.jl:180-247). All args batched (B, ...)."""
    yb = y[None, :]
    mask = sample_mask[None, :]

    def nb_logl(rv):
        return glm.loglikelihood("negativebinomial", yb, mu, cv_wts, n_true,
                                 nb_r=rv[:, None], axis=1)

    def body(carry):
        r_cur, step, it, done = carry
        rc = r_cur[:, None]
        dx = _d1(yb, mu, rc, mask)
        dx2 = _d2(yb, mu, rc, mask)
        inc = jnp.where(dx2 < 0, dx / dx2, dx)
        new_r = r_cur - step * inc
        old_logl = nb_logl(r_cur)

        # emulate break: run the 20 halvings but stop shrinking after accept —
        # reference breaks out, so subsequent js are no-ops once accepted.
        def ls_scan(ls, _):
            new_r_j, step_j, accepted = ls
            bad_r = new_r_j <= 0
            new_logl = nb_logl(jnp.maximum(new_r_j, 1e-8))
            accept_now = (~bad_r) & (old_logl < new_logl)
            shrink = (~accepted) & (~accept_now)
            step2 = jnp.where(shrink, step_j / 2, step_j)
            nr2 = jnp.where(shrink, r_cur - step2 * inc, new_r_j)
            return (nr2, step2, accepted | accept_now), None

        (new_r, step, _), _ = jax.lax.scan(
            ls_scan, (new_r, step, jnp.zeros_like(done)), None, length=20)

        conv = jnp.abs(r_cur - new_r) <= conv_tol
        r_next = jnp.where(done, r_cur, new_r)
        return (r_next, step, it + 1, done | conv)

    def cond(carry):
        _, _, it, done = carry
        return (it < max_iter) & (~jnp.all(done))

    init = (r, jnp.ones_like(r), jnp.asarray(0), jnp.zeros(r.shape, bool))
    r_out, _, _, _ = jax.lax.while_loop(cond, body, init)
    return r_out


def mle_for_r(est_r: str, y, mu, r, sample_mask, cv_wts, n_true):
    if est_r == "mm":
        return update_r_mm(y, mu, r, sample_mask)
    if est_r == "newton":
        return update_r_newton(y, mu, r, sample_mask, cv_wts, n_true)
    raise ValueError(f"est_r must be 'mm' or 'newton', got {est_r}")
