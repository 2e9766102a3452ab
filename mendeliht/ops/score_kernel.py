"""Fused 2-bit decode + multi-RHS score product for NVIDIA GPUs (Pallas
through Triton).

The hot op of IHT is the full-width score product ``X' R`` (reference's
SnpLinAlg mul!, SURVEY.md §2.10): every iteration reads the whole packed
matrix once.  This kernel reads the canonical SNP-quad words
(genotype/snparray.py) straight from device memory, decodes the 2-bit codes
in registers and feeds them to the int8 tensor cores, so no byte-view copy
and no decoded float plane is ever written:

    (p4, n4) i32 quad words --masked tile load--> shift/mask decode
        --> int8 {0,1,2} --int8 dot--> int32 sums per RHS digit plane
        --> (outside the kernel) f32 digit combine

Layout: byte ``k`` of ``words[i, w]`` is byte ``w`` of SNP ``4i+k``, and
crumb ``q`` of that byte is sample ``q*n4 + w``.  One ``(w >> (8k + 2q)) & 3``
therefore yields the value plane of SNP ``4i+k`` over the contiguous sample
block ``[q*n4 + j*bw, q*n4 + (j+1)*bw)`` — each of the 16 (k, q) extracts is
one (bp4, bw) int8 operand of a (bp4, bw) x (bw, bn) dot.

Crumb decode (per byte, all four crumbs at once): PLINK crumb c (hi = c>>1,
lo = c&1) has additive value hi + (hi&lo) and missing = lo&~hi; the
word-level recode ``w = h + (h & t)`` with ``h = (t >> 1) & 0x55...5``
value-codes all 16 crumbs of a word in four integer ops.

RHS digits: the decoded values are exact in int8, and the RHS is quantized
to three int8 digit planes ``r ~= scale * (hi*16384 + mid*128 + lo)`` with
per-column scale = max|r| / 2^20 and every digit in [-64, 64].  The dots
accumulate exactly in int32 (|acc| <= 2*64*n < 2^31 up to n = 16M samples)
and one f32 combine per output reconstructs the value: 21 significant bits
relative to each column's max (tests/test_pallas.py pins 2e-5 against the
f32 XLA oracle in ops/decode.py).

Blocks run in parallel in no order, so each program owns ``bp4`` quad rows
(4*bp4 SNPs) x ``bn`` digit columns and loops over the whole n4 reduction
itself; the column tail of a block (p4 % bp4 rows) is masked on load and
store, so the words array is never padded or copied.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_DIGITS = (16384.0, 128.0, 1.0)
# software-pipelining depth of the reduction loop's tile loads (a sweep on
# an H100 SXM at 400 W found 2, 3 and 4 within 2% of each other at m = 1)
_NUM_STAGES = 3


def _cdiv(a, b):
    return -(-a // b)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def pick_tiles(m: int, n_out: int):
    """(bp4, bw, bn, num_warps) for RHS width ``m`` and ``n_out`` outputs.

    bn is the padded digit width 3m (at least 16, the tensor-core minimum)
    capped at 64.  Each program keeps ``4 * n_out`` int32 accumulators of
    (bp4, bn) in registers, so bp4 shrinks as outputs are added.  From a
    sweep on an H100 SXM (400 W limit) at 10k x 1M: bp4 = 64 at m = 1
    (2.2 ms/pass against 4.1 ms at bp4 = 32) and bp4 = 128 with 8 warps at
    m = 100 (20 ms against 37 ms)."""
    bn = min(64, max(16, _next_pow2(3 * m)))
    if bn == 16:
        return (64 if n_out < 3 else 32), 64, bn, 4
    return 128 // _next_pow2(n_out), 64, bn, 8


def quantize_rhs(rhs):
    """f32 (n_pad, m) -> ((n_pad, 3m) int8 digit planes [hi|mid|lo],
    (m,) f32 per-column scale).

    r ~= scale * (hi*16384 + mid*128 + lo), every digit in [-64, 64]
    (|R| <= 2^20 so hi = round(R/2^14) <= 64, and each remainder is at most
    half the next digit's weight).  All-zero columns get scale 2^-20 and
    zero digits.  NaN/Inf columns produce garbage digits — the caller
    re-poisons the output (see xt_dots_words)."""
    rhs = rhs.astype(jnp.float32)
    mx = jnp.max(jnp.abs(rhs), axis=0)
    scale = jnp.where(mx > 0, mx, 1.0) / (1 << 20)
    R = jnp.round(rhs / scale[None, :]).astype(jnp.int32)
    rh = jnp.round(R.astype(jnp.float32) * (1.0 / 16384.0)).astype(jnp.int32)
    rm = jnp.round((R - rh * 16384).astype(jnp.float32) * (1.0 / 128.0)
                   ).astype(jnp.int32)
    rl = R - rh * 16384 - rm * 128
    digits = jnp.concatenate([rh, rm, rl], axis=1).astype(jnp.int8)
    return digits, scale


def _kernel(words_ref, rhs_ref, *out_refs, p4, n4, bp4, bw, bn,
            want_missing, want_sq):
    """One program: quad rows [i*bp4, (i+1)*bp4) x digit columns
    [c*bn, (c+1)*bn).  out_refs = [A, M?, H?], each (p4, 4, n_cols) int32;
    H is the dot of the hi-bit plane [v >= 1], from which the caller forms
    the squared-value dot as 3A - 2H (v^2 = 3v - 2[v>=1] for v in {0,1,2})."""
    i = pl.program_id(0)
    c = pl.program_id(1)
    rows = i * bp4 + jnp.arange(bp4)
    load_ok = jnp.broadcast_to((rows < p4)[:, None], (bp4, bw))
    store_ok = jnp.broadcast_to((rows < p4)[:, None], (bp4, bn))
    n_out = len(out_refs)

    def body(j, accs):
        t = plgpu.load(words_ref.at[pl.ds(i * bp4, bp4), pl.ds(j * bw, bw)],
                       mask=load_ok, other=0)
        h = (t >> 1) & 0x55555555
        planes = [(h + (h & t), 3)]           # value-coded crumbs {0,1,2}
        if want_missing:
            lo = t & 0x55555555
            planes.append((lo - (lo & h), 1))  # lo & ~hi
        if want_sq:
            planes.append((h, 1))
        accs = list(accs)
        for q in range(4):
            r = plgpu.load(rhs_ref.at[q, pl.ds(j * bw, bw), pl.ds(c * bn, bn)])
            for o, (plane, mask) in enumerate(planes):
                x = (plane >> (2 * q)) & (mask * 0x01010101)
                for k in range(4):
                    v = (x >> (8 * k)).astype(jnp.int8)
                    accs[4 * o + k] = accs[4 * o + k] + jax.lax.dot(
                        v, r, preferred_element_type=jnp.int32)
        return tuple(accs)

    init = tuple(jnp.zeros((bp4, bn), jnp.int32) for _ in range(4 * n_out))
    accs = jax.lax.fori_loop(0, n4 // bw, body, init)
    for o, ref in enumerate(out_refs):
        for k in range(4):
            plgpu.store(ref.at[pl.ds(i * bp4, bp4), k, pl.ds(c * bn, bn)],
                        accs[4 * o + k], mask=store_ok)


def _digit_sums(words, rhs_digits, *, want_missing, want_sq, bp4, bw, bn,
                num_warps, interpret):
    """words (p4, n4) i32, rhs_digits (4, n4, n_cols) i8 with n_cols a
    multiple of bn -> list of (4*p4, n_cols) int32 digit sums."""
    p4, n4 = words.shape
    n_cols = rhs_digits.shape[2]
    if n4 % bw or n_cols % bn:
        raise ValueError(f"n4={n4} / n_cols={n_cols} not multiples of the "
                         f"tile ({bw}, {bn})")
    n_out = 1 + int(want_missing) + int(want_sq)
    kern = functools.partial(_kernel, p4=p4, n4=n4, bp4=bp4, bw=bw, bn=bn,
                             want_missing=want_missing, want_sq=want_sq)
    outs = pl.pallas_call(
        kern,
        grid=(_cdiv(p4, bp4), n_cols // bn),
        out_shape=[jax.ShapeDtypeStruct((p4, 4, n_cols), jnp.int32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="score_xt_dots",
    )(words, rhs_digits)
    return [o.reshape(4 * p4, n_cols) for o in outs]


@functools.partial(jax.jit, static_argnames=(
    "want_missing", "want_sq", "p", "tiles", "interpret"))
def xt_dots_words(words: jnp.ndarray, rhs: jnp.ndarray, *, want_missing: bool,
                  want_sq: bool = False, p: int | None = None,
                  tiles: tuple | None = None, interpret: bool = False):
    """Fused decode + multi-RHS dots over the canonical quad-word storage.

    words (p4, n4) int32 (= PackedGenotypes.words); rhs (4*n4, m) float.
    Returns (A, M, S) with the decode.xt_dots contract: value dot, missing
    dot (or None), squared-value dot (or None), all f32 with leading dim
    ``p`` (default 4*p4; rows past the true p are inert zeros).

    ``tiles`` = (bp4, bw, bn, num_warps) overrides :func:`pick_tiles`.
    NaN/Inf RHS columns (a failed cv task's residual) would quantize to
    finite garbage and silently un-fail the task; ``0 * colsum`` re-poisons
    every output row so NaN propagates exactly like the f32 oracle."""
    p4, n4 = words.shape
    m = rhs.shape[1]
    n_out = 1 + int(want_missing) + int(want_sq)
    bp4, bw, bn, num_warps = tiles or pick_tiles(m, n_out)
    digits, scale = quantize_rhs(rhs)                    # (n_pad, 3m)
    n_cols = _cdiv(3 * m, bn) * bn
    digits = jnp.pad(digits, ((0, 0), (0, n_cols - 3 * m)))
    sums = _digit_sums(words, digits.reshape(4, n4, n_cols),
                       want_missing=want_missing, want_sq=want_sq, bp4=bp4,
                       bw=bw, bn=bn, num_warps=num_warps,
                       interpret=interpret)
    nan_guard = (jnp.sum(rhs, axis=0) * 0.0).astype(jnp.float32)   # (m,)
    rows = 4 * p4 if p is None else p

    def combine(s):
        s = s[:rows].astype(jnp.float32)
        out = sum(d * s[:, j * m:(j + 1) * m] for j, d in enumerate(_DIGITS))
        return out * scale[None, :] + nan_guard[None, :]

    outs = iter(sums)
    A = combine(next(outs))
    M = combine(next(outs)) if want_missing else None
    S = 3.0 * A - 2.0 * combine(next(outs)) if want_sq else None
    return A, M, S


def xt_dots(packed: jnp.ndarray, rhs: jnp.ndarray, *, want_missing: bool,
            want_sq: bool = False, tiles: tuple | None = None,
            interpret: bool = False):
    """Byte-view adapter with the decode.xt_dots contract (tests/oracles):
    packed (p, n4) uint8 crumb-transposed rows, quad-packed on device."""
    p, n4 = packed.shape
    p4 = _cdiv(p, 4)
    if 4 * p4 != p:
        packed = jnp.pad(packed, ((0, 4 * p4 - p), (0, 0)))
    quad = jnp.transpose(packed.reshape(p4, 4, n4), (0, 2, 1))
    words = jax.lax.bitcast_convert_type(quad, jnp.int32)    # (p4, n4)
    return xt_dots_words(words, rhs, want_missing=want_missing,
                         want_sq=want_sq, p=p, tiles=tiles,
                         interpret=interpret)
