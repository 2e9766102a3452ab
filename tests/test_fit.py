"""End-to-end univariate fit tests (reference analog: test/L0_reg_test.jl).

The strongest oracle: the reference repo ships the exact fit result of its
example data (data/iht.summary.txt, produced by `iht("normal", 8-ish...)`);
we assert our solver reproduces the same support and coefficients."""

import numpy as np
import pytest

import mendeliht as m

# reference data/iht.summary.txt (k=8 fit with intercept + sex covariates)
REF_POSITIONS = [3136, 3137, 4246, 4717, 6290, 7755, 8375, 9415]
REF_BETAS = [-0.118964, 0.422123, 0.521803, 0.928709, -0.673318, -0.544042,
             -0.788316, -2.17957]
REF_C = [0.951727, 1.49986]
REF_LOGL = -1390.3003586022403
REF_PVE = 0.7056046687054848


class TestReferenceParity:
    def test_normal_k8_matches_reference(self, normal_data):
        snp, y, z = normal_data
        res = m.fit_iht(y, snp.snparray, z, k=8, d=m.Normal(),
                        l=m.IdentityLink(), verbose=False)
        nz = np.flatnonzero(res.beta)
        assert (nz + 1).tolist() == REF_POSITIONS
        np.testing.assert_allclose(res.beta[nz], REF_BETAS, atol=2e-3)
        np.testing.assert_allclose(res.c, REF_C, atol=2e-3)
        assert abs(res.logl - REF_LOGL) < 0.5
        assert abs(res.sigma_g - REF_PVE) < 1e-3

    def test_true_beta_recovery(self, normal_data):
        truth = {}
        with open("/root/reference/data/normal_true_beta.txt") as f:
            next(f)
            for line in f:
                s, v = line.strip().split(",")
                truth[int(s[3:])] = float(v)
        snp, y, z = normal_data
        res = m.fit_iht(y, snp.snparray, z, k=10, d=m.Normal(), verbose=False)
        found = set(np.flatnonzero(res.beta) + 1)
        big_true = {p for p, v in truth.items() if abs(v) > 0.1}
        assert big_true <= found  # all non-tiny causal SNPs recovered


class TestSimulatedFits:
    def test_normal_support_size(self, small_sim):
        x, y, true_b, pos = small_sim
        k = 5
        res = m.fit_iht(y, x, k=k, d=m.Normal(), verbose=False)
        # support size == k and intercept estimated
        # (reference test/L0_reg_test.jl:1-25: nonzero count <= k, intercept != 0)
        assert np.count_nonzero(res.beta) <= k
        assert res.c[0] != 0
        # recovers most causal SNPs with large effects
        big = pos[np.abs(true_b[pos]) > 0.5]
        found = np.flatnonzero(res.beta)
        assert len(np.intersect1d(big, found)) >= max(1, len(big) - 1)

    def test_dense_matches_packed(self, small_sim):
        """Exact-equivalence oracle: packed decode path vs dense matmul path
        (reference analog: memory_efficient=true ≡ false,
        test/L0_reg_test.jl:323-371)."""
        x, y, true_b, pos = small_sim
        Xd = x.to_dense_standardized(dtype=np.float32)
        r1 = m.fit_iht(y, x, k=5, d=m.Normal(), verbose=False)
        r2 = m.fit_iht(y, Xd, k=5, d=m.Normal(), verbose=False)
        np.testing.assert_allclose(r1.beta, r2.beta, atol=5e-4)
        np.testing.assert_allclose(r1.c, r2.c, atol=5e-4)

    def test_bernoulli(self, rng):
        x, _ = m.simulate_random_snparray(None, 400, 500, rng=rng)
        y, true_b, pos = m.simulate_random_response(
            x, 4, m.Bernoulli(), m.LogitLink(), rng=rng)
        res = m.fit_iht(y, x, k=4, d=m.Bernoulli(), l=m.LogitLink(),
                        verbose=False)
        assert np.count_nonzero(res.beta) <= 4
        assert np.isfinite(res.logl)
        big = pos[np.abs(true_b[pos]) > 1.0]
        found = np.flatnonzero(res.beta)
        assert len(np.intersect1d(big, found)) >= len(big) // 2

    def test_poisson(self, rng):
        x, _ = m.simulate_random_snparray(None, 400, 500, rng=rng)
        y, true_b, pos = m.simulate_random_response(
            x, 4, m.Poisson(), m.LogLink(), rng=rng)
        res = m.fit_iht(y, x, k=4, d=m.Poisson(), l=m.LogLink(), verbose=False)
        assert np.count_nonzero(res.beta) <= 4
        assert np.isfinite(res.logl)

    def test_negbin_newton(self, rng):
        x, _ = m.simulate_random_snparray(None, 400, 500, rng=rng)
        y, true_b, pos = m.simulate_random_response(
            x, 3, m.NegativeBinomial(), m.LogLink(), r=10, rng=rng)
        res = m.fit_iht(y, x, k=3, d=m.NegativeBinomial(), l=m.LogLink(),
                        est_r="newton", verbose=False)
        assert np.count_nonzero(res.beta) <= 3
        assert np.isfinite(res.logl)

    def test_zkeep(self, rng):
        """Covariate selection via zkeep (reference test/L0_reg_test.jl:140-174):
        non-kept covariates compete for sparsity slots."""
        x, _ = m.simulate_random_snparray(None, 300, 400, rng=rng)
        n = 300
        z = np.column_stack([np.ones(n), rng.standard_normal((n, 3))])
        true_c = np.array([1.0, 2.0, 0.0, 0.0])
        y, true_b, pos = m.simulate_random_response(
            x, 3, m.Normal(), Zu=np.asarray(z @ true_c), rng=rng)
        zkeep = np.array([True, False, False, False])
        res = m.fit_iht(y, x, z, k=4, d=m.Normal(), zkeep=zkeep, verbose=False)
        total_nnz = np.count_nonzero(res.beta) + np.count_nonzero(res.c)
        assert total_nnz <= 4 + 1   # k + zkeepn
        assert res.c[0] != 0        # kept intercept always in model
        assert res.c[1] != 0        # strong covariate effect selected

    def test_init_beta(self, small_sim):
        """(reference test/L0_reg_test.jl:299-321)"""
        x, y, true_b, pos = small_sim
        res = m.fit_iht(y, x, k=5, d=m.Normal(), init_beta=True, verbose=False)
        assert np.count_nonzero(res.beta) <= 5
        assert np.isfinite(res.logl)

    def test_debias(self, small_sim):
        x, y, true_b, pos = small_sim
        res = m.fit_iht(y, x, k=5, d=m.Normal(), debias=True, verbose=False)
        assert np.count_nonzero(res.beta) <= 5
        assert np.isfinite(res.logl)

    def test_group_iht(self, rng):
        """Doubly-sparse group IHT (reference test/L0_reg_test.jl:176-243)."""
        x, _ = m.simulate_random_snparray(None, 300, 400, rng=rng)
        group = np.repeat(np.arange(1, 11), 40)   # 10 groups of 40
        y, true_b, pos = m.simulate_random_response(x, 4, m.Normal(), rng=rng)
        res = m.fit_iht(y, x, k=2, J=2, d=m.Normal(), group=group,
                        verbose=False)
        nz = np.flatnonzero(res.beta)
        active_groups = np.unique(group[nz])
        assert len(active_groups) <= 2
        for g in active_groups:
            assert (res.beta != 0)[group == g].sum() <= 2

    def test_weighted_iht(self, small_sim):
        x, y, true_b, pos = small_sim
        w = np.ones(x.p)
        w[:10] = 2.0
        res = m.fit_iht(y, x, k=5, d=m.Normal(), weight=w, verbose=False)
        assert np.count_nonzero(res.beta) <= 5

    def test_float64(self):
        """Full f64 solve in a subprocess under JAX_ENABLE_X64=1 (the parent
        process already initialized jax in f32): reference-data oracle at
        tightened tolerance + packed == dense at 1e-10 (reference
        src/MendelIHT.jl:39 `Float = Union{Float64,Float32}`)."""
        import os
        import subprocess
        import sys

        worker = os.path.join(os.path.dirname(__file__), "x64_worker.py")
        env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, worker], env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "X64-OK" in out.stdout

    def test_errors(self, small_sim):
        x, y, *_ = small_sim
        with pytest.raises(ValueError):
            m.fit_iht((y > 0).astype(float) * 3, x, k=5, d=m.Bernoulli(),
                      verbose=False)
        with pytest.raises(ValueError):
            m.fit_iht(y, x, k=5, d=m.Normal(), est_r="newton", verbose=False)
        with pytest.raises(ValueError):
            m.fit_iht(y, x, k=5, d=m.Poisson(), init_beta=True, verbose=False)


class TestDebiasConvergence:
    def test_debias_irls_fixed_point(self, rng):
        """The early-exiting IRLS refit must land on a fixed point: running
        debias_refit again from its own output changes nothing beyond the
        exit tolerance (reference's GLM refit converges and stops,
        src/utilities.jl:1014-1020)."""
        import dataclasses
        import jax.numpy as jnp
        from mendeliht.models.fit import build_fit
        from mendeliht.models.initialize import init_state
        from mendeliht.models.univariate import run_iht
        from mendeliht.models.debias import debias_refit

        x, _ = m.simulate_random_snparray(None, 300, 400, rng=rng)
        y, _, _ = m.simulate_random_response(
            x, 4, m.Bernoulli(), m.LogitLink(), rng=rng)
        op, data, cfg, k_scalar = build_fit(y, x, k=4, d=m.Bernoulli(),
                                            l=m.LogitLink())
        ks = jnp.asarray([k_scalar], jnp.int32)
        cv = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
        st = run_iht(op, data, cfg, init_state(op, data, cfg, ks, cv))

        b1 = debias_refit(op, data, cfg, st)
        st2 = dataclasses.replace(st, b=b1)
        b2 = debias_refit(op, data, cfg, st2)
        np.testing.assert_allclose(np.asarray(b2), np.asarray(b1), atol=1e-4)
        assert np.all(np.isfinite(np.asarray(b1)))
