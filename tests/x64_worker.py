"""Subprocess worker for the float64 end-to-end test (run with
JAX_ENABLE_X64=1; see tests/test_fit.py::test_float64).

The reference supports Float32 AND Float64 end-to-end
(`Float = Union{Float64,Float32}`, reference src/MendelIHT.jl:39); this
drives the full solver in f64 and asserts (a) the reference-data parity
oracle at tightened tolerance and (b) packed ≡ dense at ~1e-10 — both
impossible in f32.
"""

import os
import sys

os.environ["JAX_ENABLE_X64"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mendeliht as m
from mendeliht.ops.linalg import set_kernel_backend
from mendeliht.utils.standardize import standardize

set_kernel_backend("xla")

REFDATA = "/root/reference/data"

# reference data/iht.summary.txt (k=8 fit with intercept + sex covariates)
REF_POSITIONS = [3136, 3137, 4246, 4717, 6290, 7755, 8375, 9415]
REF_BETAS = [-0.118964, 0.422123, 0.521803, 0.928709, -0.673318, -0.544042,
             -0.788316, -2.17957]
REF_C = [0.951727, 1.49986]


def main():
    assert jnp.zeros(1).dtype == jnp.float64, "x64 mode not active"

    # ---- reference-data oracle in float64, tightened tolerances ----------
    snp = m.read_plink(f"{REFDATA}/normal", dtype=jnp.float64)
    y = np.loadtxt(f"{REFDATA}/phenotypes.txt")
    z = np.loadtxt(f"{REFDATA}/covariates.txt", delimiter=",")
    z[:, 1:] = standardize(z[:, 1:])
    res = m.fit_iht(y, snp.snparray, z, k=8, d=m.Normal(),
                    l=m.IdentityLink(), verbose=False, dtype=jnp.float64)
    assert res.beta.dtype == np.float64, res.beta.dtype
    nz = np.flatnonzero(res.beta)
    assert (nz + 1).tolist() == REF_POSITIONS, (nz + 1).tolist()
    # the summary file quotes 6 significant digits; f64 must hit them all
    np.testing.assert_allclose(res.beta[nz], REF_BETAS, atol=1e-5)
    np.testing.assert_allclose(res.c, REF_C, atol=1e-5)

    # ---- packed == dense at f64 resolution -------------------------------
    rng = np.random.default_rng(2026)
    x, _ = m.simulate_random_snparray(None, 300, 600, rng=rng)
    x = m.PackedGenotypes.from_packed(
        x.packed_np(), np.asarray(x.mu, np.float64),
        np.asarray(x.inv_sd, np.float64), n=x.n, p=x.p,
        has_missing=x.has_missing, dtype=jnp.float64)
    y2, true_b, pos = m.simulate_random_response(x, 5, m.Normal(), rng=rng)
    Xd = x.to_dense_standardized(dtype=np.float64)
    r1 = m.fit_iht(y2, x, k=5, d=m.Normal(), verbose=False,
                   dtype=jnp.float64)
    r2 = m.fit_iht(y2, Xd, k=5, d=m.Normal(), verbose=False,
                   dtype=jnp.float64)
    np.testing.assert_allclose(r1.beta, r2.beta, rtol=0, atol=1e-10)
    np.testing.assert_allclose(r1.c, r2.c, rtol=0, atol=1e-10)
    assert np.isfinite(r1.logl) and abs(r1.logl - r2.logl) < 1e-6

    print("X64-OK")


if __name__ == "__main__":
    main()
