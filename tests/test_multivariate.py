"""Multivariate IHT tests (reference analog: test/multivariate_test.jl)."""

import numpy as np
import pytest

import mendeliht as m


@pytest.fixture(scope="module")
def mv_sim():
    rng = np.random.default_rng(77)   # own stream: independent of test order
    x, _ = m.simulate_random_snparray(None, 500, 800, rng=rng)
    Y, Sigma, true_b, cpos = m.simulate_random_multivariate_response(
        x, 10, 2, overlap=2, rng=rng)
    return x, Y, Sigma, true_b


def test_mv_fit_recovery(mv_sim):
    x, Y, Sigma, true_b = mv_sim
    res = m.fit_iht(np.ascontiguousarray(Y.T), x, k=10, d=m.MvNormal(),
                    verbose=False)
    assert res.traits == 2
    assert int((res.beta != 0).sum()) <= 10
    found = set(zip(*np.nonzero(res.beta.T)))
    big = set(zip(*np.nonzero(np.abs(true_b) > 0.5)))
    assert len(big & found) >= len(big) - 1
    # residual covariance should be near the simulation Sigma (genetic effects
    # removed, so estimated ~= Sigma up to missed small effects)
    assert res.Sigma.shape == (2, 2)
    assert np.all(np.isfinite(res.Sigma))
    assert np.sign(res.Sigma[0, 1]) == np.sign(Sigma[0, 1])


def test_mv_exact_k(mv_sim):
    x, Y, Sigma, true_b = mv_sim
    res = m.fit_iht(np.ascontiguousarray(Y.T), x, k=6, d=m.MvNormal(),
                    verbose=False)
    assert int((res.beta != 0).sum()) <= 6


def test_mv_dense_matches_packed(mv_sim):
    """Exact-equivalence oracle between genotype backends."""
    x, Y, Sigma, true_b = mv_sim
    Yt = np.ascontiguousarray(Y.T)
    Xd = x.to_dense_standardized(dtype=np.float32)
    r1 = m.fit_iht(Yt, x, k=6, d=m.MvNormal(), verbose=False)
    r2 = m.fit_iht(Yt, Xd, k=6, d=m.MvNormal(), verbose=False)
    np.testing.assert_allclose(r1.beta, r2.beta, atol=2e-3)


def test_mv_requires_k(mv_sim):
    x, Y, *_ = mv_sim
    with pytest.raises(ValueError):
        m.fit_iht(np.ascontiguousarray(Y.T), x, k=0, d=m.MvNormal(),
                  verbose=False)


def test_mv_debias_unsupported(mv_sim):
    x, Y, *_ = mv_sim
    with pytest.raises(ValueError):
        m.fit_iht(np.ascontiguousarray(Y.T), x, k=5, d=m.MvNormal(),
                  debias=True, verbose=False)


def test_mv_cv(mv_sim):
    x, Y, *_ = mv_sim
    path = [2, 4, 6, 8, 10, 12, 16, 20]
    mse = m.cv_iht(np.ascontiguousarray(Y.T), x, path=path, q=3,
                   d=m.MvNormal(), verbose=False,
                   rng=np.random.default_rng(4))
    assert len(mse) == len(path) and np.all(mse > 0)
    # U-shaped: interior minimum near the effective model size (the sim has
    # 10 causal effects, ~3 of them tiny), clear overfitting penalty at k=20
    best = int(np.argmin(mse))
    assert 1 <= best <= 5
    assert mse[-1] > mse[best]


def test_mv_init_beta(mv_sim):
    x, Y, *_ = mv_sim
    res = m.fit_iht(np.ascontiguousarray(Y.T), x, k=8, d=m.MvNormal(),
                    init_beta=True, verbose=False)
    assert int((res.beta != 0).sum()) <= 8
    assert np.isfinite(res.logl)


def test_mv_zkeep(mv_sim, rng):
    x, Y, *_ = mv_sim
    n = 500
    z = np.vstack([np.ones(n), rng.standard_normal(n)])
    res = m.fit_iht(np.ascontiguousarray(Y.T), x, z, k=5, d=m.MvNormal(),
                    zkeep=np.array([True, False]), verbose=False)
    # kept intercept column present for both traits; total entries <= k + r*keep
    assert np.all(res.c[:, 0] != 0)
    assert int((res.beta != 0).sum() + (res.c[:, 1] != 0).sum()) <= 5


def test_mv_cv_checkpoint_and_progress(mv_sim, tmp_path):
    """mv cv supports checkpoint_dir / show_progress like univariate cv (the
    reference treats uni/mv cv uniformly, src/cross_validation.jl:60)."""
    x, Y, *_ = mv_sim
    Yt = np.ascontiguousarray(Y.T)
    path = [2, 6, 10]
    folds = np.random.default_rng(9).integers(1, 4, size=500)
    mse0 = m.cv_iht(Yt, x, path=path, q=3, d=m.MvNormal(), folds=folds,
                    verbose=False)
    ck = tmp_path / "mvck"
    mse1 = m.cv_iht(Yt, x, path=path, q=3, d=m.MvNormal(), folds=folds,
                    verbose=False, checkpoint_dir=str(ck), checkpoint_every=5,
                    show_progress=True)
    np.testing.assert_allclose(np.asarray(mse1), np.asarray(mse0), rtol=1e-4)
    assert ck.is_dir()


def test_mv_cv_streamed_matches(mv_sim):
    """Out-of-core mv cv through the public cv_iht == resident grid (the
    round-4 NotImplementedError gap is closed by models/mv_streamed.py)."""
    from mendeliht.ops.streaming import HostStreamedGenotypes

    x, Y, *_ = mv_sim
    s = HostStreamedGenotypes.from_snparray(x, block_bytes=4096)
    Yt = np.ascontiguousarray(Y.T)
    folds = np.random.default_rng(31).integers(1, 3, size=x.n)
    mse0 = m.cv_iht(Yt, x=x, path=[2, 4], q=2, folds=folds,
                    d=m.MvNormal(), verbose=False)
    mse1 = m.cv_iht(Yt, x=s, path=[2, 4], q=2, folds=folds,
                    d=m.MvNormal(), verbose=False)
    np.testing.assert_allclose(np.asarray(mse1), np.asarray(mse0), rtol=1e-4)


def test_mv_cv_task_chunking_exact(mv_sim):
    """Chunked task batches must reproduce the single-batch grid
    ((fold, k) tasks are independent; a different batch size changes XLA's
    float reduction order, so agreement is ~1e-5 relative, not bitwise);
    chunking bounds HBM for big grids."""
    x, Y, *_ = mv_sim
    Yt = np.ascontiguousarray(Y.T)
    path = [2, 6, 10, 14]
    folds = np.random.default_rng(21).integers(1, 3, size=500)
    from mendeliht.models.mv import cv_mv_iht
    m0 = cv_mv_iht(Yt, x, path=path, q=2, folds=folds, verbose=False)
    m1 = cv_mv_iht(Yt, x, path=path, q=2, folds=folds, verbose=False,
                   task_chunk=3)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), rtol=1e-4)
