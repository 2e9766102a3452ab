"""2-bit genotype decode + fused matmul ops — XLA path.

These are the compute kernels replacing SnpArrays.jl's threaded SpMV/SpMM
(reference: SnpLinAlg mul! used at src/utilities.jl:133-134, :729-739,
src/multivariate.jl:85; see SURVEY.md §2.10).

Layout contract (see genotype/snparray.py): packed is (p, n4) uint8 with crumb
``s`` of byte ``b`` = sample ``s*n4 + b``, so shift-plane ``s`` is the
contiguous sample block ``[s*n4, (s+1)*n4)``.

Decode algebra per crumb code c (hi = c>>1, lo = c&1):
    raw value (missing -> 0):  v  = hi + (hi & lo)      in {0,1,2}
    missing indicator:         m  = lo & ~hi
    squared value:             v² = hi + 3*(hi & lo)    in {0,1,4}

Standardized ops are assembled from raw-plane dots + per-SNP (mu, 1/sd)
corrections *outside* the heavy pass:
    X_std' R = inv_sd ∘ (A + mu ∘ M - mu · colsum(R)),   A = Vraw'R, M = Miss'R

The fused GPU kernel in score_kernel.py implements the same contract; this
module is the XLA path (every other platform) and the correctness oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

DOT_PREC = jax.lax.Precision.HIGHEST


def _plane_crumbs(chunk: jnp.ndarray, s: int) -> jnp.ndarray:
    """(c, n4) uint8 codes of shift-plane s."""
    return (chunk >> jnp.uint8(2 * s)) & jnp.uint8(0x3)


def plane_val_miss(crumbs: jnp.ndarray, dtype, want_missing: bool):
    hi = (crumbs >> jnp.uint8(1)).astype(dtype)
    hl = ((crumbs >> jnp.uint8(1)) & crumbs & jnp.uint8(1)).astype(dtype)
    val = hi + hl
    miss = None
    if want_missing:
        miss = ((crumbs & jnp.uint8(1)).astype(dtype) - hl)  # lo & ~hi
    return val, miss, hi, hl


@functools.partial(jax.jit, static_argnames=("want_missing", "want_sq", "chunk"))
def xt_dots(packed: jnp.ndarray, rhs: jnp.ndarray, *, want_missing: bool,
            want_sq: bool = False, chunk: int = 512):
    """Raw-plane dots against the full packed matrix.

    packed: (p, n4) uint8;  rhs: (n_pad, m) float with n_pad = 4*n4.
    Returns (A, M, S): value-dot (p, m), missing-dot (p, m) or None,
    squared-value-dot (p, m) or None.
    """
    p, n4 = packed.shape
    m = rhs.shape[1]
    dtype = rhs.dtype
    p_pad = -(-p // chunk) * chunk
    if p_pad != p:
        packed = jnp.pad(packed, ((0, p_pad - p), (0, 0)))
    blocks = packed.reshape(p_pad // chunk, chunk, n4)
    rhs_planes = rhs.reshape(4, n4, m)

    def one_chunk(blk):
        A = jnp.zeros((chunk, m), dtype)
        M = jnp.zeros((chunk, m), dtype) if want_missing else None
        S = jnp.zeros((chunk, m), dtype) if want_sq else None
        for s in range(4):
            crumbs = _plane_crumbs(blk, s)
            val, miss, hi, hl = plane_val_miss(crumbs, dtype, want_missing)
            A = A + jnp.dot(val, rhs_planes[s], precision=DOT_PREC)
            if want_missing:
                M = M + jnp.dot(miss, rhs_planes[s], precision=DOT_PREC)
            if want_sq:
                S = S + jnp.dot(hi + 3.0 * hl, rhs_planes[s], precision=DOT_PREC)
        return (A, M, S)

    A, M, S = jax.lax.map(one_chunk, blocks)
    A = A.reshape(p_pad, m)[:p]
    M = M.reshape(p_pad, m)[:p] if want_missing else None
    S = S.reshape(p_pad, m)[:p] if want_sq else None
    return A, M, S


def take_rows_bytes(words: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather SNP rows from the canonical quad-word storage -> (B, S, n4) u8.

    SNP j lives in byte ``j % 4`` of quad-word row ``j // 4``
    (genotype/snparray.py): the gather is a contiguous row gather on the
    int32 array followed by a per-row byte select —
    only the small (B*S, n4) gathered block is ever decoded.  Deriving the
    full byte view first (PackedGenotypes.packed) would transpose-copy the
    whole matrix."""
    B, S = idx.shape
    flat = idx.reshape(-1)
    g = words[flat // 4]                                    # (B*S, n4) int32
    shift = ((flat % 4) * 8).astype(jnp.int32)[:, None]
    return (((g >> shift) & 0xFF).astype(jnp.uint8)
            ).reshape(B, S, words.shape[1])


@functools.partial(jax.jit, static_argnames=("want_missing", "dtype"))
def gather_decode_rows(rows: jnp.ndarray, dtype, *, want_missing: bool):
    """Decode pre-gathered SNP rows (B, S, n4) u8 -> (B, S, 4*n4) raw values
    + missing planes.  Returns (val, miss); miss is None when want_missing is
    False."""
    g = rows
    vals, misses = [], []
    for s in range(4):
        crumbs = _plane_crumbs(g, s)
        val, miss, _, _ = plane_val_miss(crumbs, dtype, want_missing)
        vals.append(val)
        misses.append(miss)
    val = jnp.concatenate(vals, axis=2)
    miss = jnp.concatenate(misses, axis=2) if want_missing else None
    return val, miss


def gather_decode_raw(packed: jnp.ndarray, idx: jnp.ndarray, dtype,
                      *, want_missing: bool):
    """Byte-storage wrapper for :func:`gather_decode_rows` (tests/oracle)."""
    B, S = idx.shape
    rows = packed[idx.reshape(-1)].reshape(B, S, packed.shape[1])
    return gather_decode_rows(rows, dtype, want_missing=want_missing)


@functools.partial(jax.jit, static_argnames=("want_missing",))
def sparse_forward_rows_multi(rows: jnp.ndarray, idx: jnp.ndarray,
                              coef: jnp.ndarray, mu: jnp.ndarray,
                              *, want_missing: bool):
    """Multi-trait raw sparse forward product (multivariate IHT).

    rows: (B, S, n4) pre-gathered packed rows; idx: (B, S) SNP indices shared
    across traits; coef: (B, R, S) per-trait coefficients already scaled by
    inv_sd and masked. Returns (B, R, 4*n4).  Gathers each selected SNP row
    once and contracts against all traits (reference analog: update_xb!
    BX = B[:,idx] * X[idx,:], src/multivariate.jl:21-31)."""
    g = rows
    dtype = coef.dtype
    mus = mu[idx][:, None, :] * coef                  # (B, R, S)
    out = []
    for s in range(4):
        crumbs = _plane_crumbs(g, s)
        val, miss, _, _ = plane_val_miss(crumbs, dtype, want_missing)
        xb_s = jnp.einsum("bsn,brs->brn", val, coef, precision=DOT_PREC)
        if want_missing:
            xb_s = xb_s + jnp.einsum("bsn,brs->brn", miss, mus,
                                     precision=DOT_PREC)
        out.append(xb_s)
    return jnp.concatenate(out, axis=2)


def sparse_forward_raw_multi(packed: jnp.ndarray, idx: jnp.ndarray,
                             coef: jnp.ndarray, mu: jnp.ndarray,
                             *, want_missing: bool):
    """Byte-storage wrapper for :func:`sparse_forward_rows_multi`."""
    B, S = idx.shape
    rows = packed[idx.reshape(-1)].reshape(B, S, packed.shape[1])
    return sparse_forward_rows_multi(rows, idx, coef, mu,
                                     want_missing=want_missing)


@functools.partial(jax.jit, static_argnames=("want_missing",))
def sparse_forward_rows(rows: jnp.ndarray, idx: jnp.ndarray,
                        coef: jnp.ndarray, mu: jnp.ndarray,
                        *, want_missing: bool):
    """Raw sparse forward product plus missing correction.

    rows: (B, S, n4) pre-gathered packed rows; idx: (B, S) row indices;
    coef: (B, S) already scaled by inv_sd and masked (invalid slots must
    carry coef == 0).
    Returns (B, 4*n4):  sum_j coef[b,j] * (v_raw[:, idx] + mu*miss[:, idx]).
    The caller subtracts the constant  sum_j coef[b,j]*mu[idx[b,j]].
    """
    g = rows
    dtype = coef.dtype
    mus = mu[idx] * coef                              # (B, S)
    out = []
    for s in range(4):
        crumbs = _plane_crumbs(g, s)
        val, miss, _, _ = plane_val_miss(crumbs, dtype, want_missing)
        xb_s = jnp.einsum("bjn,bj->bn", val, coef, precision=DOT_PREC)
        if want_missing:
            xb_s = xb_s + jnp.einsum("bjn,bj->bn", miss, mus, precision=DOT_PREC)
        out.append(xb_s)
    return jnp.concatenate(out, axis=1)


def sparse_forward_raw(packed: jnp.ndarray, idx: jnp.ndarray,
                       coef: jnp.ndarray, mu: jnp.ndarray,
                       *, want_missing: bool):
    """Byte-storage wrapper for :func:`sparse_forward_rows`."""
    B, S = idx.shape
    rows = packed[idx.reshape(-1)].reshape(B, S, packed.shape[1])
    return sparse_forward_rows(rows, idx, coef, mu, want_missing=want_missing)
