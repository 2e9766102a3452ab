"""Kernel-level tests: decode matmuls vs dense oracles, GLM functions vs
closed forms, projections (reference analog: test/utilities_test.jl)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.stats as sps

from mendeliht.genotype.snparray import PackedGenotypes
from mendeliht.ops.linalg import make_operator
from mendeliht.ops import glm, projections as proj


@pytest.fixture(scope="module")
def packed_oracle(rng):
    n, p = 237, 513
    codes = rng.choice([0, 1, 2, 3], size=(n, p),
                       p=[.35, .05, .35, .25]).astype(np.uint8)
    g = PackedGenotypes.from_codes(codes)
    return g, g.to_dense_standardized(), n, p


class TestPackedOps:
    def test_xtr(self, packed_oracle, rng):
        g, X, n, p = packed_oracle
        op = make_operator(g)
        B = 3
        R = np.zeros((B, op.n_pad))
        R[:, :n] = rng.standard_normal((B, n))
        out = np.asarray(op.xtr(jnp.asarray(R, jnp.float32)))
        ref = R[:, :n] @ X
        assert np.abs(out - ref).max() < 1e-3 * np.abs(ref).max()

    def test_forward_sel(self, packed_oracle, rng):
        g, X, n, p = packed_oracle
        op = make_operator(g)
        B, S = 3, 7
        idx = rng.integers(0, p, size=(B, S))
        coef = rng.standard_normal((B, S))
        valid = rng.random((B, S)) > .3
        fwd = np.asarray(op.forward_sel(
            jnp.asarray(idx), jnp.asarray(coef, jnp.float32),
            jnp.asarray(valid, jnp.float32)))
        ref = np.stack([X[:, idx[b]] @ (coef[b] * valid[b]) for b in range(3)])
        assert np.abs(fwd[:, :n] - ref).max() < 1e-4

    def test_col_moments(self, packed_oracle, rng):
        g, X, n, p = packed_oracle
        op = make_operator(g)
        B = 2
        W = np.zeros((B, op.n_pad))
        W[:, :n] = rng.random((B, n)) > 0.4
        Y = np.zeros((B, op.n_pad))
        Y[:, :n] = rng.standard_normal((B, n))
        Sx, Sxx, Sxy = [np.asarray(a) for a in op.col_moments(
            jnp.asarray(W, jnp.float32), jnp.asarray(W * Y, jnp.float32))]
        np.testing.assert_allclose(Sx, W[:, :n] @ X, atol=2e-3)
        np.testing.assert_allclose(Sxx, W[:, :n] @ (X * X), atol=5e-3)
        np.testing.assert_allclose(Sxy, (W * Y)[:, :n] @ X, atol=2e-3)

    def test_gather_cols(self, packed_oracle, rng):
        g, X, n, p = packed_oracle
        op = make_operator(g)
        idx = rng.integers(0, p, size=(2, 5))
        valid = np.ones((2, 5), bool)
        cols = np.asarray(op.gather_cols(jnp.asarray(idx), jnp.asarray(valid)))
        for b in range(2):
            np.testing.assert_allclose(cols[b, :, :n], X[:, idx[b]].T, atol=1e-5)


class TestGLM:
    """loglikelihood vs scipy logpdfs (reference test/utilities_test.jl:20-51)."""

    def test_normal(self, rng):
        y = rng.standard_normal(50)
        mu = rng.standard_normal(50)
        wts = np.ones(50)
        phi = float(np.sum((y - mu) ** 2) / 50)
        ours = float(glm.loglikelihood("normal", y, mu, wts, 50))
        ref = sps.norm.logpdf(y, mu, np.sqrt(phi)).sum()
        assert abs(ours - ref) < max(1e-2, abs(ref) * 2e-4)

    def test_bernoulli(self, rng):
        y = (rng.random(60) > .5).astype(float)
        mu = rng.uniform(.05, .95, 60)
        ours = float(glm.loglikelihood("bernoulli", y, mu, np.ones(60), 60))
        ref = sps.bernoulli.logpmf(y.astype(int), mu).sum()
        assert abs(ours - ref) < max(1e-2, abs(ref) * 2e-4)

    def test_poisson(self, rng):
        y = rng.poisson(3.0, 60).astype(float)
        mu = rng.uniform(.5, 5., 60)
        ours = float(glm.loglikelihood("poisson", y, mu, np.ones(60), 60))
        ref = sps.poisson.logpmf(y.astype(int), mu).sum()
        assert abs(ours - ref) < max(1e-2, abs(ref) * 2e-4)

    def test_negative_binomial(self, rng):
        r = 7.0
        y = rng.poisson(3.0, 60).astype(float)
        mu = rng.uniform(.5, 5., 60)
        ours = float(glm.loglikelihood("negativebinomial", y, mu,
                                       np.ones(60), 60, nb_r=r))
        # scipy nbinom: n=r, p=r/(mu+r)
        ref = sps.nbinom.logpmf(y.astype(int), r, r / (mu + r)).sum()
        assert abs(ours - ref) < max(1e-2, abs(ref) * 2e-4)

    def test_gamma(self, rng):
        y = rng.gamma(2.0, 1.0, 60)
        mu = rng.uniform(.5, 3., 60)
        wts = np.ones(60)
        phi = float(glm.deviance("gamma", y, mu, wts)) / 60
        ours = float(glm.loglikelihood("gamma", y, mu, wts, 60))
        ref = sps.gamma.logpdf(y, 1 / phi, scale=mu * phi).sum()
        assert abs(ours - ref) < 1e-2

    def test_inverse_gaussian(self, rng):
        y = rng.wald(2.0, 1.0, 60)
        mu = rng.uniform(.5, 3., 60)
        wts = np.ones(60)
        phi = float(glm.deviance("inversegaussian", y, mu, wts)) / 60
        ours = float(glm.loglikelihood("inversegaussian", y, mu, wts, 60))
        ref = sps.invgauss.logpdf(y, mu * phi, scale=1 / phi).sum()
        assert abs(ours - ref) < 1e-2

    def test_deviance_normal(self, rng):
        y = rng.standard_normal(30)
        mu = rng.standard_normal(30)
        wts = (rng.random(30) > .5).astype(float)
        ours = float(glm.deviance("normal", y, mu, wts))
        assert abs(ours - (wts * (y - mu) ** 2).sum()) < 1e-5

    def test_linkinv_closed_forms(self, rng):
        """update_mu! vs closed-form inverse links
        (reference test/utilities_test.jl:63-92)."""
        eta = rng.standard_normal(40)
        np.testing.assert_allclose(np.asarray(glm.linkinv("identity", eta)), eta)
        np.testing.assert_allclose(np.asarray(glm.linkinv("logit", eta)),
                                   1 / (1 + np.exp(-eta)), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(glm.linkinv("log", eta)),
                                   np.exp(eta), rtol=1e-5)
        pos = np.abs(eta) + .1
        np.testing.assert_allclose(np.asarray(glm.linkinv("inverse", pos)),
                                   1 / pos, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(glm.linkinv("sqrt", eta)),
                                   eta ** 2, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(glm.linkinv("cloglog", eta)),
                                   1 - np.exp(-np.exp(eta)), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(glm.linkinv("probit", eta)),
                                   sps.norm.cdf(eta), rtol=1e-4, atol=1e-6)

    def test_canonical_links(self):
        assert glm.canonicallink(glm.Normal()).name == "identity"
        assert glm.canonicallink(glm.Bernoulli()).name == "logit"
        assert glm.canonicallink(glm.Poisson()).name == "log"
        assert glm.canonicallink(glm.Gamma()).name == "inverse"


class TestProjections:
    def test_project_k_exactness(self, rng):
        """top-k equals sortperm selection (reference test/utilities_test.jl:166-176)."""
        x = rng.standard_normal(200)
        out = np.asarray(proj.project_k(x, 10))
        keep = np.argsort(-np.abs(x))[:10]
        expected = np.zeros(200)
        expected[keep] = x[keep]
        np.testing.assert_allclose(out, expected)

    def test_joint_projection_counts(self, rng):
        b = jnp.asarray(rng.standard_normal((2, 50)), jnp.float32)
        c = jnp.asarray(rng.standard_normal((2, 4)), jnp.float32)
        zkeep = jnp.asarray([True, False, False, True])
        bn, cn, ti, tv, tk = proj.project_topk_joint(
            b, c, jnp.asarray([7, 5]), zkeep, S=10)
        nnz = (np.asarray(bn) != 0).sum(1) + (np.asarray(cn) != 0).sum(1)
        assert list(nnz) == [7, 5]
        # kept covariates survive with original values
        np.testing.assert_allclose(np.asarray(cn)[:, [0, 3]],
                                   np.asarray(c)[:, [0, 3]])

    def test_weighted_projection(self, rng):
        """selection by |w*x|, surviving values unscaled."""
        x = rng.standard_normal(30)
        w = rng.uniform(.5, 2., 30)
        out = np.asarray(proj.project_k(x, 5, weight=w))
        keep = np.argsort(-np.abs(x * w))[:5]
        expected = np.zeros(30)
        expected[keep] = x[keep]
        np.testing.assert_allclose(out, expected)

    def test_group_sparse_equals_topk_single_group(self, rng):
        """(reference test/utilities_test.jl:180-213)"""
        y = rng.standard_normal(100)
        g1 = np.asarray(proj.project_group_sparse(y, np.ones(100, int), 1, 10))
        g2 = np.asarray(proj.project_k(y, 10))
        np.testing.assert_allclose(g1, g2)

    def test_group_sparse_properties(self, rng):
        y = rng.standard_normal(200)
        grp = rng.integers(1, 8, 200)
        J, k = 3, 4
        out = np.asarray(proj.project_group_sparse(y, grp, J, k))
        active = np.unique(grp[out != 0])
        assert len(active) <= J
        for g in active:
            assert (out != 0)[grp == g].sum() <= k
        # kept values unchanged
        nz = out != 0
        np.testing.assert_allclose(out[nz], y[nz])

    def test_group_sparse_vector_k(self, rng):
        y = rng.standard_normal(100)
        grp = rng.integers(1, 5, 100)
        ks = np.array([1, 2, 3, 4])
        out = np.asarray(proj.project_group_sparse(y, grp, 2, ks))
        active = np.unique(grp[out != 0])
        assert len(active) <= 2
        for g in active:
            assert (out != 0)[grp == g].sum() <= ks[g - 1]


class TestWeights:
    def test_maf_weights(self, rng):
        """(reference test/utilities_test.jl:215-229)"""
        from mendeliht import maf_weights, maf
        codes = rng.choice([0, 2, 3], size=(100, 30),
                           p=[.5, .3, .2]).astype(np.uint8)
        g = PackedGenotypes.from_codes(codes)
        w = maf_weights(g)
        m = maf(g)
        expected = np.clip(1 / (2 * np.sqrt(m * (1 - m))), 1.0, np.inf)
        np.testing.assert_allclose(w, expected, rtol=1e-10)


class TestStandardize:
    def test_standardize(self, rng):
        from mendeliht import standardize
        z = rng.standard_normal((50, 3)) * 5 + 2
        out = standardize(z.copy())
        np.testing.assert_allclose(out.mean(0), 0, atol=1e-12)
        np.testing.assert_allclose(out.std(0, ddof=1), 1, rtol=1e-12)
