"""chip_smoke.py's phase functions.

On the CPU they run at tiny sizes (the kernel in Pallas interpret mode, the
four-device path on the virtual CPU mesh); the tests marked `gpu` run the
same functions at moderate sizes on a GPU:

    MENDELIHT_TEST_PLATFORM=cuda python -m pytest tests/test_chip.py -m gpu

`python chip_smoke.py` runs them at the full 10k x 1M size.
"""

import os
import sys

import numpy as np
import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    probs = cs._Problems(n=300, p=8192)
    return probs.g, probs.g_miss


def test_simulated_genotypes_match_host_stats(tiny):
    """The device generator's words decode to codes whose host-computed
    stats equal the device-computed mu / inv_sd; no missing codes unless
    asked; padding samples and SNPs are zero."""
    g, g_miss = tiny
    codes = g.to_codes()                                  # (n, p)
    assert not g.has_missing and not (codes == 1).any()
    assert g_miss.has_missing and (g_miss.to_codes() == 1).any()
    vals = np.where(codes == 2, 1.0, np.where(codes == 3, 2.0, 0.0))
    np.testing.assert_allclose(np.asarray(g.mu), vals.mean(axis=0),
                               rtol=1e-6)
    sd = np.sqrt(vals.mean(axis=0) * (1 - vals.mean(axis=0) / 2))
    np.testing.assert_allclose(np.asarray(g.inv_sd), 1 / sd, rtol=1e-5)
    full = g.packed_np()
    n4 = full.shape[1]
    for q in range(4):                  # crumb q of byte b is sample q*n4+b
        first_pad = max(0, g.n - q * n4)
        assert not ((full[:, first_pad:] >> (2 * q)) & 3).any()
    ragged = cs.simulate_geno(3, 50, 10)                  # p % 4 != 0
    assert not np.asarray(ragged.words)[-1].view(np.uint8).reshape(
        -1, 4)[:, 2:].any()


def test_phase_kernel_cpu(tiny):
    g, g_miss = tiny
    out = cs.phase_kernel(g, g_miss, n_ref=2048, reps=1,
                          widths=((1, False), (2, True), (20, False)),
                          time_widths=(1,))
    errs = [v for k, v in out.items() if k.startswith("err_")]
    assert len(errs) == 6 and max(errs) <= cs.KERNEL_TOL
    assert {"kernel_ms_m1", "xla_ms_m1"} <= set(out)


def test_phase_fit_cpu(tiny):
    out = cs.phase_fit(tiny[0], k=5, min_recovered=3)
    assert out["dlogl_rel"] < cs.LOGL_RTOL and np.isfinite(
        out["bernoulli_logl"])


def test_phase_cv_cpu(tiny):
    out = cs.phase_cv(tiny[0], p_small=4096, path=range(1, 6), q=2, k=3)
    assert out["small_mse_max_rel"] <= cs.CV_RTOL


def test_phase_mv_cpu(tiny):
    out = cs.phase_mv(tiny[0], k_causal=4, k=5, min_recovered=3)
    assert np.isfinite(out["logl"])


def test_phase_wrapper_cpu():
    out = cs.phase_wrapper(n=200, p=500, k=3, path=range(1, 5))
    assert out["recovered"] >= 1
    assert not [d for d in os.listdir(cs.ROOT) if d.startswith(".smoke_")]


def test_phase_four_cpu():
    """The sharded path and its single-device comparison on 4 of the
    virtual CPU devices."""
    assert len(jax.devices()) >= 4
    out = cs.phase_four(n=300, p=4096, k=3)
    assert out["fit_same_support"] and out["cv_same_support"]
    assert out["fit_word_devices"] == 4 and out["cv_word_devices"] == 4


def test_check_raises_on_a_failed_bound():
    with pytest.raises(cs.SmokeFailure, match="bound"):
        cs.check(False, "bound")
    cs.check(True, "never raised")


def test_failed_phase_is_reported(monkeypatch, capsys):
    """A phase that raises is listed as failed and the others still run."""
    def boom(*a, **k):
        raise cs.SmokeFailure("out of bound")

    monkeypatch.setattr(cs, "phase_wrapper", boom)
    failed = cs.run_phases(["wrapper"], "card")
    assert failed == ["wrapper"]
    assert "[wrapper] FAILED" in capsys.readouterr().out


def test_main_refuses_without_gpu(capsys):
    """No GPU: non-zero exit and no result line."""
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


# --- on a GPU --------------------------------------------------------------

@pytest.fixture(scope="module")
def medium():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    probs = cs._Problems(n=2000, p=200_000)
    return probs.g, probs.g_miss


@pytest.mark.gpu
def test_phase_kernel_gpu(medium):
    cs.phase_kernel(*medium, n_ref=65536, reps=0)


@pytest.mark.gpu
def test_phase_fit_gpu(medium):
    cs.phase_fit(medium[0], min_recovered=8)


@pytest.mark.gpu
def test_phase_cv_gpu(medium):
    cs.phase_cv(medium[0], p_small=20_000)
