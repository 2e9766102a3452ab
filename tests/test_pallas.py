"""Parity tests for the fused GPU score kernel (ops/score_kernel.py).

The suite runs on CPU via `pl.pallas_call(..., interpret=True)`, so the
kernel's decode algebra, sample mapping, int8 digit-plane precision, edge
masking and column blocking are exercised everywhere; on a GPU the same
kernel is compared at full size by tests/test_chip.py.  Reference analog:
the reference trusts SnpArrays' tested linalg (SURVEY.md §2.10); ours is
local.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mendeliht.genotype.snparray import PackedGenotypes, pack_codes
from mendeliht.ops import decode, linalg
from mendeliht.ops import score_kernel as sk


def _random_codes(rng, n, p, missing=True):
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    return rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)


def _small_tiles(m):
    """Tiles small enough that a tiny problem spans several blocks."""
    return (16, 64, 16 if 3 * m <= 16 else 32, 4)


@pytest.mark.parametrize("want_missing", [False, True])
@pytest.mark.parametrize("want_sq", [False, True])
def test_xt_dots_parity_planes(rng, want_missing, want_sq):
    """Kernel (interpret) == XLA oracle for every output plane."""
    n, p, m = 200, 40, 3
    codes = _random_codes(rng, n, p, missing=want_missing)
    packed = jnp.asarray(pack_codes(codes))          # (p, n4=512)
    n4 = packed.shape[1]
    rhs = jnp.asarray(rng.standard_normal((4 * n4, m)), jnp.float32)

    A0, M0, S0 = decode.xt_dots(packed, rhs, want_missing=want_missing,
                                want_sq=want_sq)
    A1, M1, S1 = sk.xt_dots(packed, rhs, want_missing=want_missing,
                            want_sq=want_sq, tiles=_small_tiles(m),
                            interpret=True)
    scale = max(1.0, float(np.abs(np.asarray(A0)).max()))
    assert np.max(np.abs(np.asarray(A1) - np.asarray(A0))) / scale < 2e-5
    if want_missing:
        assert np.max(np.abs(np.asarray(M1) - np.asarray(M0))) / scale < 2e-5
    else:
        assert M1 is None
    if want_sq:
        sscale = max(1.0, float(np.abs(np.asarray(S0)).max()))
        assert np.max(np.abs(np.asarray(S1) - np.asarray(S0))) / sscale < 2e-5
    else:
        assert S1 is None


def test_xt_dots_padding_and_chunking(rng):
    """p not a multiple of 4 nor of the row tile (masked edge block), and m
    wide enough that the digit columns span several column blocks."""
    n, p, m = 130, 37, 15
    codes = _random_codes(rng, n, p)
    packed = jnp.asarray(pack_codes(codes))
    n4 = packed.shape[1]
    rhs = jnp.asarray(rng.standard_normal((4 * n4, m)), jnp.float32)

    A0, M0, _ = decode.xt_dots(packed, rhs, want_missing=True)
    A1, M1, _ = sk.xt_dots(packed, rhs, want_missing=True,
                           tiles=(16, 64, 16, 4), interpret=True)
    assert A1.shape == (p, m)
    scale = max(1.0, float(np.abs(np.asarray(A0)).max()))
    assert np.max(np.abs(np.asarray(A1) - np.asarray(A0))) / scale < 2e-5
    assert np.max(np.abs(np.asarray(M1) - np.asarray(M0))) / scale < 2e-5


def test_xt_dots_quantization_precision(rng):
    """The 3-digit int8 quantization (21 significant bits per column) must
    reach near-f32 accuracy even on an adversarial wide-dynamic-range rhs,
    far beyond plain bf16 (~4e-3) or a single int8 plane (~1e-2)."""
    n, p = 512, 16
    codes = _random_codes(rng, n, p, missing=False)
    packed = jnp.asarray(pack_codes(codes))
    n4 = packed.shape[1]
    # adversarial rhs with wide dynamic range
    rhs = jnp.asarray(
        rng.standard_normal((4 * n4, 1)) * 10.0 ** rng.integers(
            -3, 4, size=(4 * n4, 1)), jnp.float32)
    A0, _, _ = decode.xt_dots(packed, rhs, want_missing=False)
    A1, _, _ = sk.xt_dots(packed, rhs, want_missing=False,
                          tiles=_small_tiles(1), interpret=True)
    scale = float(np.abs(np.asarray(A0)).max())
    assert np.max(np.abs(np.asarray(A1) - np.asarray(A0))) / scale < 2e-5


def test_xt_dots_nan_propagation(rng):
    """A NaN anywhere in an rhs column must poison that column's outputs
    (quantization would otherwise turn a failed task's residual into finite
    garbage and silently un-fail it)."""
    n, p = 100, 20
    codes = _random_codes(rng, n, p, missing=True)
    packed = jnp.asarray(pack_codes(codes))
    n4 = packed.shape[1]
    rhs = np.asarray(rng.standard_normal((4 * n4, 3)), np.float32)
    rhs[7, 1] = np.nan
    A1, M1, S1 = sk.xt_dots(packed, jnp.asarray(rhs), want_missing=True,
                            want_sq=True, tiles=_small_tiles(3),
                            interpret=True)
    for out in (A1, M1, S1):
        arr = np.asarray(out)
        assert np.all(np.isnan(arr[:, 1]))
        assert np.all(np.isfinite(arr[:, [0, 2]]))


def test_standardized_xtr_through_operator(rng):
    """Standardized X'R from the kernel's raw dots (interpret) plus the
    operator's standardization algebra == dense-matrix oracle, including
    missing imputation, and == the operator's own (XLA) xtr."""
    from mendeliht.ops.linalg import PackedOp

    n, p = 100, 30
    codes = _random_codes(rng, n, p)
    g = PackedGenotypes.from_codes(codes, sample_major=False)
    op = PackedOp(g)
    R = jnp.asarray(rng.standard_normal((2, op.n_pad)), jnp.float32)
    R = R * jnp.asarray(
        np.concatenate([np.ones(n), np.zeros(op.n_pad - n)]), jnp.float32)

    want = np.asarray(R)[:, :n] @ g.to_dense_standardized()

    A, M, _ = sk.xt_dots_words(g.words, R.T, want_missing=g.has_missing,
                               p=g.p, tiles=_small_tiles(2), interpret=True)
    colsum = jnp.sum(R, axis=1)
    corr = (M - colsum[None, :]) if g.has_missing else -colsum[None, :]
    got = np.asarray((g.inv_sd[:, None] * (A + g.mu[:, None] * corr)).T)
    scale = max(1.0, np.abs(want).max())
    assert np.max(np.abs(got - want)) / scale < 2e-5
    assert np.max(np.abs(np.asarray(op.xtr(R)) - got)) / scale < 2e-5


def test_words_lane_alignment_every_n():
    """The canonical words layout pads n4 to a multiple of 512 for EVERY n,
    so the kernel's power-of-two reduction tile divides it and the
    reduction loop has no tail (genotype/snparray.py _LANE)."""
    from mendeliht.genotype.snparray import _ceil_to, _LANE

    for n in (1, 96, 200, 10_000, 12_345, 50_000, 120_000, 500_000):
        n4 = _ceil_to(-(-n // 4), _LANE)
        assert n4 % 512 == 0 and n4 >= -(-n // 4), n
        assert n4 % sk.pick_tiles(1, 1)[1] == 0


def test_cv_scale_m100_chunking(rng):
    """Reference-shaped cv batch (m = q*|path| = 100 rhs columns) through the
    interpret-mode kernel with its default tile choice == XLA oracle: 300
    digit columns padded to 320 = 5 column blocks of 64."""
    n, p, m = 130, 40, 100
    codes = _random_codes(rng, n, p)
    packed = jnp.asarray(pack_codes(codes))
    n4 = packed.shape[1]
    rhs = jnp.asarray(rng.standard_normal((4 * n4, m)), jnp.float32)
    assert sk.pick_tiles(m, 2)[2] == 64
    A0, M0, _ = decode.xt_dots(packed, rhs, want_missing=True)
    A1, M1, _ = sk.xt_dots(packed, rhs, want_missing=True, interpret=True)
    scale = max(1.0, float(np.abs(np.asarray(A0)).max()))
    assert np.max(np.abs(np.asarray(A1) - np.asarray(A0))) / scale < 2e-5
    assert np.max(np.abs(np.asarray(M1) - np.asarray(M0))) / scale < 2e-5


@pytest.mark.parametrize("m,n_out", [(1, 1), (1, 3), (2, 2), (6, 1),
                                     (100, 1), (100, 2), (200, 3)])
def test_pick_tiles(m, n_out):
    """Tiles are powers of two, at least the tensor-core minimum of 16 on
    every dot dimension, and the register-held accumulators (4 * n_out of
    (bp4, bn) int32) take at most 128 of the 255 registers a thread has."""
    bp4, bw, bn, warps = sk.pick_tiles(m, n_out)
    for t in (bp4, bw, bn, warps):
        assert t & (t - 1) == 0
    assert min(bp4, bw, bn) >= 16
    assert bn >= min(64, 3 * m)
    assert 4 * n_out * bp4 * bn / (32 * warps) <= 128


def test_tiles_must_divide_the_reduction(rng):
    """A reduction tile that does not divide n4 is refused, not read past
    the end of the words."""
    codes = _random_codes(rng, 64, 8)
    words = PackedGenotypes.from_codes(codes, sample_major=False).words
    rhs = jnp.ones((4 * words.shape[1], 1), jnp.float32)
    with pytest.raises(ValueError, match="multiples of the tile"):
        sk.xt_dots_words(words, rhs, want_missing=False,
                         tiles=(16, 384, 16, 4), interpret=True)


def test_quantize_rhs_digits(rng):
    """Digits are int8 in [-64, 64] and reconstruct the column to 2^-20 of
    its max; an all-zero column gets zero digits."""
    rhs = np.asarray(rng.standard_normal((256, 3)), np.float32)
    rhs[:, 2] = 0.0
    digits, scale = sk.quantize_rhs(jnp.asarray(rhs))
    assert digits.dtype == jnp.int8
    d = np.asarray(digits).astype(np.int64)
    assert np.abs(d).max() <= 64
    m = rhs.shape[1]
    recon = (16384 * d[:, :m] + 128 * d[:, m:2 * m] + d[:, 2 * m:]) * \
        np.asarray(scale, np.float64)[None, :]
    err = np.abs(recon - rhs).max(axis=0) / np.maximum(
        np.abs(rhs).max(axis=0), 1e-30)
    assert err[:2].max() <= 2.0 ** -20
    assert not d[:, [2, 5, 8]].any()


class TestDispatch:
    """The score path is chosen by platform: the kernel only on a GPU, the
    XLA decode path everywhere else; forcing the kernel where it cannot run
    is an error, never a silent interpret-mode run."""

    def test_xla_on_cpu(self):
        assert jax.default_backend() == "cpu"
        try:
            linalg.set_kernel_backend("auto")
            assert not linalg.use_kernel()
        finally:
            linalg.set_kernel_backend("xla")
        assert not linalg.use_kernel()

    def test_forcing_kernel_off_gpu_raises(self):
        with pytest.raises(RuntimeError, match="only on a GPU"):
            linalg.set_kernel_backend("kernel")
        assert not linalg.use_kernel()

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError):
            linalg.set_kernel_backend("pallas")

    def test_kernel_on_gpu(self, rng, monkeypatch):
        """On a GPU the operator calls the kernel on the quad words (no
        byte-view copy); 'xla' selects the decode path there."""
        codes = _random_codes(rng, 64, 12)
        g = PackedGenotypes.from_codes(codes, sample_major=False)
        op = linalg.PackedOp(g)
        calls = []

        def spy(words, RT, **kw):
            calls.append((words.shape, kw))
            return decode.xt_dots(g.packed, RT, want_missing=kw[
                "want_missing"], want_sq=kw["want_sq"])

        monkeypatch.setattr(sk, "xt_dots_words", spy)
        monkeypatch.setattr(linalg.jax, "default_backend", lambda: "gpu")
        try:
            linalg.set_kernel_backend("auto")
            assert linalg.use_kernel()
            op.xtr(jnp.ones((1, op.n_pad), jnp.float32))
            assert calls and calls[0][0] == g.words.shape
            assert calls[0][1]["p"] == g.p
            linalg.set_kernel_backend("xla")
            assert not linalg.use_kernel()
        finally:
            linalg.set_kernel_backend("xla")

    def test_sharded_kernel_path(self, rng, monkeypatch):
        """The shard_map'ed operator runs the kernel on each shard's own
        quad rows (interpret mode on 4 virtual CPU devices) and equals the
        plain XLA operator: xtr and col_moments."""
        import functools
        from mendeliht.parallel.mesh import make_mesh, shard_geno_op

        codes = _random_codes(rng, 100, 64)
        g = PackedGenotypes.from_codes(codes, sample_major=False)
        op = linalg.PackedOp(g)
        R = jnp.asarray(rng.standard_normal((4, op.n_pad)), jnp.float32)
        W = jnp.asarray(rng.random((4, op.n_pad)), jnp.float32)
        WY = W * jnp.asarray(rng.standard_normal(op.n_pad), jnp.float32)
        want = [op.xtr(R), *op.col_moments(W, WY)]

        mesh = make_mesh(n_task=2, n_snp=2, devices=jax.devices()[:4])
        op_s = shard_geno_op(op, mesh)
        monkeypatch.setattr(sk, "xt_dots_words", functools.partial(
            sk.xt_dots_words, interpret=True))
        monkeypatch.setattr(linalg, "use_kernel", lambda: True)
        got = [op_s.xtr(R), *op_s.col_moments(W, WY)]
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert np.max(np.abs(a - b)) / np.abs(b).max() < 2e-5
