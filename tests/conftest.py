import os

# Force CPU with an 8-device virtual mesh for sharding tests. NOTE: jax may be
# imported before this file runs, so env vars alone can be too late — use
# jax.config (the backend is still uninitialized at conftest time).
# MENDELIHT_TEST_PLATFORM=cuda runs the suite on the GPU instead; the tests
# marked `gpu` run only there:
#   MENDELIHT_TEST_PLATFORM=cuda python -m pytest tests/test_chip.py -m gpu
_platform = os.environ.get("MENDELIHT_TEST_PLATFORM") or "cpu"
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if _platform == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", _platform)

import numpy as np
import pytest


REFDATA = "/root/reference/data"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(2026)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` skip unless JAX runs on a GPU (decided at run
    time, never at import, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; JAX runs on {platform!r}")


@pytest.fixture(scope="session", autouse=True)
def _xla_backend():
    from mendeliht.ops.linalg import set_kernel_backend
    set_kernel_backend("xla")


@pytest.fixture(scope="session")
def normal_data():
    """Reference example data: n=1000, p=10k Gaussian with 8 causal SNPs +
    intercept + sex."""
    import mendeliht as m
    from mendeliht.utils.standardize import standardize
    snp = m.read_plink(f"{REFDATA}/normal")
    y = np.loadtxt(f"{REFDATA}/phenotypes.txt")
    z = np.loadtxt(f"{REFDATA}/covariates.txt", delimiter=",")
    z[:, 1:] = standardize(z[:, 1:])
    return snp, y, z


@pytest.fixture(scope="session")
def small_sim(rng):
    """Small simulated problem shared across tests (one compile shape)."""
    import mendeliht as m
    x, mafs = m.simulate_random_snparray(None, 300, 600, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 5, m.Normal(), rng=rng)
    return x, y, true_b, pos
