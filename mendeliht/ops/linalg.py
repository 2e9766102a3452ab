"""Genotype operator abstraction: standardized matvec/matmul products.

Two interchangeable backends:
  * :class:`PackedOp` — 2-bit packed genotypes decoded on the fly
    (the fused GPU kernel in score_kernel.py; the XLA path in decode.py).
  * :class:`DenseOp` — plain dense design matrix, used verbatim (matches the
    reference's ``Matrix{Float64}`` path where the user pre-standardizes,
    e.g. test/L0_reg_test.jl:269-297).

All batched ops use a leading task axis B (cross-validation (fold, k) tasks,
or 1 for a single fit): B tasks share one pass over X (SURVEY.md §3.3
masking trick), so the score product is one multi-RHS matmul.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import decode
from ..genotype.snparray import PackedGenotypes

_KERNEL_BACKEND = "auto"  # "auto" | "xla" | "kernel"


def set_kernel_backend(name: str):
    """Choose the score-pass implementation: ``"auto"`` (the fused kernel on
    a GPU, the XLA decode path elsewhere), ``"xla"`` (always the XLA decode
    path, ops/decode.py — the reference the kernel is checked against) or
    ``"kernel"`` (the GPU kernel; an error on any other platform).  Clears
    JAX's compiled-function caches, since the choice is read at trace time."""
    global _KERNEL_BACKEND
    if name not in ("auto", "xla", "kernel"):
        raise ValueError(f"unknown kernel backend {name!r}")
    if name == "kernel" and jax.default_backend() != "gpu":
        raise RuntimeError("the fused score kernel runs only on a GPU; this "
                           f"process runs on {jax.default_backend()!r}")
    _KERNEL_BACKEND = name
    jax.clear_caches()


def use_kernel() -> bool:
    """True when the score pass runs the fused GPU kernel (ops/score_kernel)."""
    if _KERNEL_BACKEND == "xla":
        return False
    return jax.default_backend() == "gpu"


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PackedOp:
    geno: PackedGenotypes

    def tree_flatten(self):
        return (self.geno,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def n(self):
        return self.geno.n

    @property
    def p(self):
        return self.geno.p

    @property
    def n_pad(self):
        return self.geno.n_pad

    @property
    def dtype(self):
        return self.geno.mu.dtype

    def _xt_dots(self, RT, want_sq=False):
        """Dispatch the full-width raw dots to the active backend.

        The GPU kernel consumes the canonical int32 words directly; the XLA
        path derives the byte view first (a transpose copy of the matrix)."""
        g = self.geno
        if use_kernel():
            from . import score_kernel
            return score_kernel.xt_dots_words(
                g.words, RT, want_missing=g.has_missing, want_sq=want_sq,
                p=g.p)
        return decode.xt_dots(g.packed, RT, want_missing=g.has_missing,
                              want_sq=want_sq)

    def xtr(self, R: jnp.ndarray) -> jnp.ndarray:
        """Standardized X' R for R (B, n_pad) -> (B, p)."""
        g = self.geno
        A, M, _ = self._xt_dots(R.T, want_sq=False)
        colsum = jnp.sum(R, axis=1)                       # (B,)
        corr = M - colsum[None, :] if g.has_missing else -colsum[None, :]
        out = g.inv_sd[:, None] * (A + g.mu[:, None] * corr)
        return out.T

    def forward_sel(self, idx: jnp.ndarray, coef: jnp.ndarray,
                    valid: jnp.ndarray) -> jnp.ndarray:
        """Standardized X[:, idx] @ coef -> (B, n_pad).

        idx (B, S) SNP indices; coef (B, S); valid (B, S) 0/1. Invalid slots
        are ignored regardless of index value.
        """
        g = self.geno
        coef_s = coef * g.inv_sd[idx] * valid
        rows = decode.take_rows_bytes(g.words, idx)
        raw = decode.sparse_forward_rows(rows, idx, coef_s, g.mu,
                                         want_missing=g.has_missing)
        const = jnp.sum(coef_s * g.mu[idx], axis=1)       # (B,)
        return raw - const[:, None]

    def forward_sel_multi(self, idx: jnp.ndarray, coef: jnp.ndarray,
                          valid: jnp.ndarray) -> jnp.ndarray:
        """Multi-trait standardized forward product: idx (B,S), coef (B,R,S),
        valid (B,S) -> (B, R, n_pad)."""
        g = self.geno
        coef_s = coef * (g.inv_sd[idx] * valid)[:, None, :]
        rows = decode.take_rows_bytes(g.words, idx)
        raw = decode.sparse_forward_rows_multi(rows, idx, coef_s, g.mu,
                                               want_missing=g.has_missing)
        const = jnp.sum(coef_s * g.mu[idx][:, None, :], axis=2)   # (B, R)
        return raw - const[:, :, None]

    def gather_cols(self, idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
        """Materialize standardized columns X[:, idx] -> (B, S, n_pad);
        invalid slots are zeroed. Used by the (small-S) debias refit."""
        g = self.geno
        rows = decode.take_rows_bytes(g.words, idx)
        val, miss = decode.gather_decode_rows(rows, self.dtype,
                                              want_missing=g.has_missing)
        mu = g.mu[idx][:, :, None]
        inv = g.inv_sd[idx][:, :, None]
        if g.has_missing:
            val = val + mu * miss
        out = (val - mu) * inv
        return out * valid[:, :, None]

    def col_moments(self, W: jnp.ndarray, WY: jnp.ndarray):
        """Per-SNP weighted moments of standardized columns.

        W, WY: (B, n_pad).  Returns Sx, Sxx, Sxy each (B, p):
          Sx = sum_i w_i x_ij,  Sxx = sum_i w_i x_ij^2,  Sxy = sum_i w_i y_i x_ij
        """
        g = self.geno
        R = jnp.stack([W, WY], axis=0).reshape(2 * W.shape[0], -1)  # (2B, n_pad)
        A, M, Sq = self._xt_dots(R.T, want_sq=True)
        B = W.shape[0]
        A = A.T.reshape(2, B, -1)
        Sq = Sq.T.reshape(2, B, -1)
        if g.has_missing:
            M = M.T.reshape(2, B, -1)
        else:
            M = jnp.zeros_like(A)
        mu, inv = g.mu[None, :], g.inv_sd[None, :]
        sumW = jnp.sum(W, axis=1)[:, None]
        sumWY = jnp.sum(WY, axis=1)[:, None]
        # Sx = inv*(A_w + mu*(M_w - sumW));  Sxy likewise with WY
        Sx = inv * (A[0] + mu * (M[0] - sumW))
        Sxy = inv * (A[1] + mu * (M[1] - sumWY))
        # Sxx = inv^2 * (Sq_w - 2 mu A_w - mu^2 M_w + mu^2 sumW)
        Sxx = inv * inv * (Sq[0] - 2.0 * mu * A[0] - mu * mu * M[0] + mu * mu * sumW)
        return Sx, Sxx, Sxy


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseOp:
    x: jnp.ndarray  # (n, p), used verbatim (caller standardizes)

    def tree_flatten(self):
        return (self.x,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def p(self):
        return self.x.shape[1]

    @property
    def n_pad(self):
        return self.x.shape[0]

    @property
    def dtype(self):
        return self.x.dtype

    def xtr(self, R: jnp.ndarray) -> jnp.ndarray:
        return jnp.dot(R, self.x, precision=decode.DOT_PREC)

    def forward_sel(self, idx, coef, valid):
        cols = jnp.take(self.x.T, idx, axis=0)            # (B, S, n)
        return jnp.einsum("bjn,bj->bn", cols, coef * valid,
                          precision=decode.DOT_PREC)

    def forward_sel_multi(self, idx, coef, valid):
        cols = jnp.take(self.x.T, idx, axis=0)            # (B, S, n)
        return jnp.einsum("bsn,brs->brn", cols, coef * valid[:, None, :],
                          precision=decode.DOT_PREC)

    def gather_cols(self, idx, valid):
        cols = jnp.take(self.x.T, idx, axis=0)            # (B, S, n)
        return cols * valid[:, :, None]

    def col_moments(self, W, WY):
        Sx = jnp.dot(W, self.x, precision=decode.DOT_PREC)
        Sxx = jnp.dot(W, self.x * self.x, precision=decode.DOT_PREC)
        Sxy = jnp.dot(WY, self.x, precision=decode.DOT_PREC)
        return Sx, Sxx, Sxy


def make_operator(x, dtype=jnp.float32):
    """Dispatch an input design matrix to its operator."""
    if isinstance(x, (PackedOp, DenseOp)) or hasattr(x, "xtr"):
        return x  # already an operator (incl. parallel.ShardedPackedOp)
    if isinstance(x, PackedGenotypes):
        return PackedOp(x)
    from .streaming import HostStreamedGenotypes, StreamedPackedOp
    if isinstance(x, HostStreamedGenotypes):
        return StreamedPackedOp(x)
    if isinstance(x, (np.ndarray, jnp.ndarray)):
        return DenseOp(jnp.asarray(x, dtype=dtype))
    raise TypeError(f"unsupported design matrix type {type(x)}")
