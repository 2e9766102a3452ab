"""Extra end-to-end fits: experimental Gamma / inverse-Gaussian traits
(reference docs/src/index.md:26-34 lists them as experimental), the MM
nuisance estimator end-to-end, and LD-correlated simulation properties
(reference test/L0_reg_test.jl:176-243 uses correlated genotypes)."""

import numpy as np
import pytest

import mendeliht as m


def test_gamma_fit():
    rng = np.random.default_rng(301)
    x, _ = m.simulate_random_snparray(None, 500, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 3, m.Gamma(), m.LogLink(),
                                                rng=rng)
    res = m.fit_iht(y, x, k=3, d=m.Gamma(), l=m.LogLink(), verbose=False)
    assert np.count_nonzero(res.beta) <= 3
    assert np.isfinite(res.logl)


def test_inverse_gaussian_fit():
    rng = np.random.default_rng(302)
    x, _ = m.simulate_random_snparray(None, 500, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 3, m.InverseGaussian(),
                                                m.LogLink(), rng=rng)
    res = m.fit_iht(y, x, k=3, d=m.InverseGaussian(), l=m.LogLink(),
                    verbose=False)
    assert np.count_nonzero(res.beta) <= 3
    assert np.isfinite(res.logl)


def test_negbin_mm_fit():
    rng = np.random.default_rng(303)
    x, _ = m.simulate_random_snparray(None, 500, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(
        x, 3, m.NegativeBinomial(), m.LogLink(), r=10, rng=rng)
    res = m.fit_iht(y, x, k=3, d=m.NegativeBinomial(), l=m.LogLink(),
                    est_r="MM", verbose=False)
    assert np.count_nonzero(res.beta) <= 3
    assert np.isfinite(res.logl)


def test_probit_link_fit():
    rng = np.random.default_rng(304)
    x, _ = m.simulate_random_snparray(None, 500, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 4, m.Bernoulli(),
                                                m.ProbitLink(), rng=rng)
    res = m.fit_iht(y, x, k=4, d=m.Bernoulli(), l=m.ProbitLink(),
                    verbose=False)
    assert np.count_nonzero(res.beta) <= 4
    assert np.isfinite(res.logl)


def test_cloglog_link_fit():
    rng = np.random.default_rng(305)
    x, _ = m.simulate_random_snparray(None, 500, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 4, m.Bernoulli(),
                                                m.CloglogLink(), rng=rng)
    res = m.fit_iht(y, x, k=4, d=m.Bernoulli(), l=m.CloglogLink(),
                    verbose=False)
    assert np.count_nonzero(res.beta) <= 4
    assert np.isfinite(res.logl)


def test_correlated_snparray_properties():
    rng = np.random.default_rng(306)
    n, p, bl = 600, 200, 20
    x = m.simulate_correlated_snparray(None, n, p, block_length=bl,
                                       prob=0.9, rng=rng)
    codes = x.to_codes()
    assert codes.shape == (n, p)
    assert set(np.unique(codes)).issubset({0, 2, 3})
    Xd = x.to_dense_standardized()
    C = np.corrcoef(Xd.T)
    # within-block pairs much more correlated than cross-block pairs
    within, cross = [], []
    for b in range(p // bl - 1):
        i = b * bl
        within.append(abs(C[i, i + 1]))
        cross.append(abs(C[i, i + bl]))
    assert np.nanmean(within) > np.nanmean(cross) + 0.2


def test_correlated_group_recovery():
    # doubly-sparse IHT on LD blocks (reference test/L0_reg_test.jl:176-243)
    rng = np.random.default_rng(307)
    n, p, bl = 800, 200, 20
    x = m.simulate_correlated_snparray(None, n, p, block_length=bl,
                                       prob=0.75, rng=rng)
    Xd = x.to_dense_standardized()
    group = np.repeat(np.arange(1, p // bl + 1), bl)
    btrue = np.zeros(p)
    causal = [5, 45, 105]                      # 3 groups, 1 SNP each
    btrue[causal] = [2.0, -1.5, 2.5]
    y = Xd @ btrue + 0.3 * rng.standard_normal(n)
    res = m.fit_iht(y, x, k=2, J=3, group=group, verbose=False)
    groups_found = set(group[np.flatnonzero(res.beta)])
    assert len(groups_found) <= 3
    true_groups = set(group[causal])
    assert len(groups_found & true_groups) >= 2


class TestBuildCache:
    def test_cache_hits_and_content_invalidation(self, rng):
        """build_fit's problem cache returns the SAME built tuple for a
        repeated identical problem, and must miss when y changes content or
        the genotype object is different (identity check, models/fit.py)."""
        from mendeliht.models.fit import build_fit

        x, _ = m.simulate_random_snparray(None, 120, 200, rng=rng)
        y, _, _ = m.simulate_random_response(x, 3, m.Normal(), rng=rng)
        a = build_fit(y, x, k=3)
        b = build_fit(y, x, k=3)
        assert a is b                       # cache hit
        c = build_fit(y + 1.0, x, k=3)
        assert c is not a                   # content miss
        d = build_fit(y, x, k=4)
        assert d is not a                   # config miss
        # different genotype OBJECT with identical content must miss (id
        # check guards against recycled ids via the kept strong reference)
        x2, _ = m.simulate_random_snparray(None, 120, 200,
                                           rng=np.random.default_rng(1))
        e = build_fit(y, x2, k=3)
        assert e is not a
        # cached and fresh builds produce identical fits
        r1 = m.fit_iht(y, x, k=3, verbose=False)
        r2 = m.fit_iht(y, x, k=3, verbose=False)
        np.testing.assert_array_equal(r1.beta, r2.beta)
