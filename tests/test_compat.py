"""Top-level functional API parity (reference export list,
src/MendelIHT.jl:27-36): loglikelihood / deviance / score / mle_for_r /
initialize_beta / naive_impute / cv_iht_distribute_fold as pure functions."""

import numpy as np
import pytest

import mendeliht as m


def test_loglikelihood_matches_normal_logpdf():
    rng = np.random.default_rng(101)
    n = 200
    mu = rng.standard_normal(n)
    y = mu + rng.standard_normal(n)
    ll = m.loglikelihood(m.Normal(), y, mu)
    # reference parameterization: sigma2 = deviance / n (utilities_test.jl:20-51)
    s2 = np.mean((y - mu) ** 2)
    expect = np.sum(-0.5 * (np.log(2 * np.pi * s2) + (y - mu) ** 2 / s2))
    assert ll == pytest.approx(expect, rel=1e-5)


def test_loglikelihood_poisson():
    rng = np.random.default_rng(102)
    from scipy import stats
    n = 150
    mu = np.exp(rng.standard_normal(n) * 0.3)
    y = rng.poisson(mu).astype(float)
    ll = m.loglikelihood(m.Poisson(), y, mu)
    expect = stats.poisson.logpmf(y, mu).sum()
    assert ll == pytest.approx(expect, rel=1e-5)


def test_deviance_bernoulli():
    rng = np.random.default_rng(103)
    n = 100
    mu = 1.0 / (1.0 + np.exp(-rng.standard_normal(n)))
    y = (rng.random(n) < mu).astype(float)
    dev = m.deviance(m.Bernoulli(), y, mu)
    expect = -2.0 * np.sum(y * np.log(mu) + (1 - y) * np.log1p(-mu))
    assert dev == pytest.approx(expect, rel=1e-5)


def test_score_residual_identity():
    rng = np.random.default_rng(104)
    n = 50
    eta = rng.standard_normal(n)
    y = eta + rng.standard_normal(n)
    s = np.asarray(m.score(m.Normal(), m.IdentityLink(), y, eta, eta))
    np.testing.assert_allclose(s, y - eta, rtol=1e-5, atol=1e-6)


def test_mle_for_r_recovers_nuisance():
    rng = np.random.default_rng(105)
    n, r_true = 4000, 3.0
    mu = np.exp(rng.standard_normal(n) * 0.2 + 0.5)
    p = r_true / (mu + r_true)
    y = rng.negative_binomial(r_true, p).astype(float)
    r_hat = m.mle_for_r(y, mu, r=1.0, est_r="Newton")
    assert abs(r_hat - r_true) / r_true < 0.25, r_hat
    # MM is a single fixed-point update per call (reference
    # src/utilities.jl:158-173, applied once per IHT iteration) — iterate it
    r_mm = 1.0
    for _ in range(40):
        r_mm = m.mle_for_r(y, mu, r=r_mm, est_r="MM")
    assert abs(r_mm - r_true) / r_true < 0.25, r_mm


def test_initialize_beta_marginal_regression(small_sim):
    x, y, true_b, pos = small_sim
    b, c = m.initialize_beta(y, x)
    Xd = x.to_dense_standardized()
    # spot-check a few SNPs against the closed-form [1, x_j] regression
    for j in [0, 7, int(pos[0])]:
        A = np.column_stack([np.ones(len(y)), Xd[:, j]])
        coef = np.linalg.lstsq(A, y, rcond=None)[0]
        assert b[j] == pytest.approx(np.clip(coef[1], -2, 2), abs=1e-3)
    # large-effect causal SNPs should rank high
    big = pos[np.abs(true_b[pos]) > 0.5]
    topq = np.argsort(-np.abs(b))[: max(20, len(big) * 4)]
    assert len(set(big.tolist()) & set(topq.tolist())) >= len(big) // 2


def test_cv_iht_distribute_fold_files(tmp_path, small_sim):
    rng = np.random.default_rng(106)
    x, y, true_b, pos = small_sim
    path = [1, 3, 5, 7]
    q = 3
    folds = rng.integers(1, q + 1, size=len(y))
    mse = m.cv_iht_distribute_fold(m.Normal(), m.IdentityLink(), x, None, y,
                                   1, path, q, destin=str(tmp_path),
                                   folds=folds)
    assert mse.shape == (len(path),)
    assert np.all(mse > 0)
    for i in range(1, q + 1):
        f = tmp_path / f"cviht_fold{i}.txt"
        assert f.exists()
        tab = np.loadtxt(f, skiprows=1)
        assert tab.shape == (len(path), 2)
    # consistency with cv_iht on the same folds
    mse2 = m.cv_iht(y, x, path=path, q=q, folds=folds, verbose=False)
    np.testing.assert_allclose(mse, mse2, rtol=1e-4)


def test_naive_impute_roundtrip():
    rng = np.random.default_rng(107)
    import mendeliht as m
    codes = rng.choice([0, 1, 2, 3], size=(60, 40),
                       p=[0.4, 0.1, 0.3, 0.2]).astype(np.uint8)
    x = m.PackedGenotypes.from_codes(codes)
    xi = m.naive_impute(x)
    out = xi.to_codes()
    assert not np.any(out == 1)          # no missing left
    keep = codes != 1
    np.testing.assert_array_equal(out[keep], codes[keep])
