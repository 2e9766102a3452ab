"""Device-facing plumbing: matmul precision, compile-cache placement, the
peak-rate table, device-memory budgets, the native build key and the
checkpoint format."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import mendeliht as m

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# precision: every f32 contraction of the solver asks for HIGHEST, so a GPU
# never runs it in TF32 (about three decimal digits)
# ---------------------------------------------------------------------------

def _subjaxprs(v):
    if isinstance(v, ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, Jaxpr):
        yield v
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _subjaxprs(x)


def unpinned_f32_dots(closed):
    """dot_general equations with a float32 operand whose precision is not
    HIGHEST on both sides, anywhere in the jaxpr (nested calls included)."""
    bad, stack = [], [closed.jaxpr]
    while stack:
        jaxpr = stack.pop()
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                f32 = any(getattr(v.aval, "dtype", None) == jnp.float32
                          for v in eqn.invars)
                prec = eqn.params.get("precision")
                highest = (prec is not None and all(
                    p == jax.lax.Precision.HIGHEST for p in prec))
                if f32 and not highest:
                    bad.append(str(eqn)[:200])
            for v in eqn.params.values():
                stack.extend(_subjaxprs(v))
    return bad


def test_precision_audit_flags_unpinned_dot():
    """The walker finds an unpinned f32 dot inside nested jit/while."""
    def f(a, b):
        inner = jax.jit(lambda x, y: jnp.dot(x, y))
        return jax.lax.while_loop(lambda c: c[1] < 2,
                                  lambda c: (inner(c[0], b), c[1] + 1),
                                  (a, 0))[0]

    a = jnp.ones((4, 4), jnp.float32)
    assert len(unpinned_f32_dots(jax.make_jaxpr(f)(a, a))) == 1
    g = lambda x, y: jnp.dot(x, y, precision=jax.lax.Precision.HIGHEST)
    assert unpinned_f32_dots(jax.make_jaxpr(g)(a, a)) == []


@pytest.fixture(scope="module")
def audit_problem():
    rng = np.random.default_rng(5)
    x, _ = m.simulate_random_snparray(None, 120, 256, rng=rng)
    y, _, _ = m.simulate_random_response(x, 3, m.Normal(), rng=rng)
    z = np.column_stack([np.ones(120), rng.standard_normal(120)])
    return x, y, z


@pytest.mark.parametrize("dist,debias", [("normal", True),
                                         ("bernoulli", False)])
def test_univariate_program_precision(audit_problem, dist, debias):
    """The whole fused univariate fit (init, iterations, debias, finalize)
    has no f32 dot_general below HIGHEST."""
    from mendeliht.models.fit import build_fit
    from mendeliht.models.univariate import fit_fused_sparse

    x, y, z = audit_problem
    d = m.Normal() if dist == "normal" else m.Bernoulli()
    yy = y if dist == "normal" else (y > np.median(y)).astype(float)
    op, data, cfg, k = build_fit(yy, x, z, k=3, d=d, debias=debias)
    ks = jnp.asarray([k], jnp.int32)
    cv = data.sample_mask[None, :]
    jaxpr = jax.make_jaxpr(lambda o, dd, kk, c: fit_fused_sparse(
        o, dd, cfg, kk, c, init_beta=(dist == "normal")))(op, data, ks, cv)
    assert unpinned_f32_dots(jaxpr) == []


def test_multivariate_program_precision(audit_problem):
    """The fused multivariate fit (trait covariance, its inverse, the
    Gamma-weighted score and the covariate products) has no f32
    dot_general below HIGHEST."""
    from mendeliht.models.mv import build_mv, fit_mv_fused

    x, y, z = audit_problem
    rng = np.random.default_rng(6)
    Y = np.stack([y, y + rng.standard_normal(y.shape)])
    op, data, cfg = build_mv(Y, x, z.T, k=4)
    ks = jnp.asarray([4], jnp.int32)
    cv = data.sample_mask[None, :]
    jaxpr = jax.make_jaxpr(lambda o, dd, kk, c: fit_mv_fused(
        o, dd, cfg, kk, c, init_beta=True))(op, data, ks, cv)
    assert unpinned_f32_dots(jaxpr) == []


def test_cv_program_precision(audit_problem):
    from mendeliht.models.fit import build_fit
    from mendeliht.models.univariate import cv_fused

    x, y, z = audit_problem
    op, data, cfg, _ = build_fit(y, x, z, k=3)
    ks = jnp.asarray([2, 3], jnp.int32)
    train = jnp.broadcast_to(data.sample_mask[None, :], (2, op.n_pad))
    jaxpr = jax.make_jaxpr(lambda o, dd, kk, t: cv_fused(
        o, dd, cfg, kk, t, t))(op, data, ks, train)
    assert unpinned_f32_dots(jaxpr) == []


# ---------------------------------------------------------------------------
# compile cache: JAX_COMPILATION_CACHE_DIR wins; otherwise one fixed
# directory inside the checkout
# ---------------------------------------------------------------------------

def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, mendeliht; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_inside_checkout():
    got = _cache_dir_in_child(None)
    assert got == os.path.join(ROOT, ".jax_cache") == m.CACHE_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_var_wins(tmp_path):
    assert _cache_dir_in_child(str(tmp_path)) == str(tmp_path)


# ---------------------------------------------------------------------------
# peak table
# ---------------------------------------------------------------------------

def test_peaks_known_device():
    from mendeliht.utils.profiling import device_peaks
    pk = device_peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["int8_ops_per_s"] == 1979e12


@pytest.mark.parametrize("kind", [None, "cpu", "TPU v5 lite"])
def test_peaks_unknown_device_raises(kind):
    """No default for a device missing from the table (the CPU included)."""
    from mendeliht.utils.profiling import device_peaks
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)


def test_comm_model_defaults_are_published_h100_rates():
    from mendeliht.parallel import multihost as mh
    a = mh.comm_model(10_000, 1_000_000, B=4, n_snp=4)
    b = mh.comm_model(10_000, 1_000_000, B=4, n_snp=4,
                      stream_bytes_per_s=3.35e12, link_bytes_per_s=450e9)
    assert a == b


# ---------------------------------------------------------------------------
# device-memory budgets
# ---------------------------------------------------------------------------

def test_cpu_reports_no_memory_limit():
    from mendeliht.ops.streaming import _resident_budget
    from mendeliht.utils.device import memory_limit_bytes
    assert memory_limit_bytes() is None
    assert _resident_budget() == 0


def test_resident_budget_follows_device_limit(monkeypatch):
    from mendeliht.ops import streaming
    from mendeliht.utils import device

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 60 * 2**30, "bytes_in_use": 0}

    assert device.memory_limit_bytes(Dev()) == 60 * 2**30
    monkeypatch.setattr(device.jax, "devices", lambda: [Dev()])
    assert streaming._resident_budget() == 30 * 2**30


# ---------------------------------------------------------------------------
# native build: keyed by source, flags and architecture, in build/
# ---------------------------------------------------------------------------

def test_native_library_key(tmp_path):
    from mendeliht import native
    lib = native.library_path()
    assert os.path.dirname(lib) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(os.path.join(ROOT, "build"))
    assert "-march=native" not in native._FLAGS
    src = tmp_path / "repack.cpp"
    with open(native._SRC, "rb") as f:
        src.write_bytes(f.read())
    assert os.path.basename(native.library_path(str(src))) == \
        os.path.basename(lib)
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert native.library_path(str(src)) != lib
    assert native.library_path(flags=native._FLAGS + ("-g",)) != lib


def test_native_never_loads_a_stale_library(monkeypatch, tmp_path):
    """A library under another key (other source, flags or host) is never
    picked up: the loader only looks for its own key and builds it."""
    from mendeliht import native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    stale = tmp_path / "_repack-0000000000000000.so"
    stale.write_bytes(b"not a library")
    path = native._build()
    if path is None:
        pytest.skip("no C++ compiler")
    assert os.path.basename(path) != stale.name
    assert os.path.isfile(path)


# ---------------------------------------------------------------------------
# checkpoint format
# ---------------------------------------------------------------------------

def test_checkpoint_npz_keeps_latest_two(tmp_path):
    from mendeliht.models.state import IHTState
    from mendeliht.utils import checkpoint as ck
    import dataclasses

    fields = {f.name: jnp.full((2, 3), i, jnp.float32)
              for i, f in enumerate(dataclasses.fields(IHTState))}
    st = IHTState(**fields)
    for step in (1, 2, 3):
        ck.save_state(str(tmp_path), st, step)
    assert sorted(ck.all_steps(str(tmp_path))) == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz", "step_3.npz"]
    got, step = ck.restore_state(str(tmp_path), st)
    assert step == 3
    for f in dataclasses.fields(IHTState):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(st, f.name)))
