"""Profiling / observability subsystem (SURVEY.md §5: absent in the reference,
first-class here).

- :func:`trace` — context manager around jax.profiler for on-device traces
  viewable in TensorBoard/Perfetto.
- :func:`device_peaks` — published peak rates of the device, by device_kind.
- :func:`stream_bandwidth` / :func:`kernel_roofline` — measured read
  bandwidth over the packed words, and the achieved rate of the score pass
  against it and against the published peak.
- :func:`fit_report` — per-phase wall-clock breakdown of a fit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time

import jax
import jax.numpy as jnp

# Published dense peaks, keyed by jax.Device.device_kind.  Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part (rates assume its 700 W limit).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        "int8_ops_per_s": 1979e12,
        "f32_flops_per_s": 67e12,
        "nvlink_bytes_per_s_each_way": 450e9,
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """Published peak rates of ``kind`` (default: the first JAX device).
    A device missing from the table is an error, never a default."""
    kind = jax.devices()[0].device_kind if kind is None else kind
    try:
        return _PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(_PEAKS)}") from None


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context: `with profiling.trace(logdir): ...`"""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def median_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` after one warm-up call, each run
    ended by block_until_ready."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def stream_bandwidth(geno, iters: int = 50) -> float:
    """Measured achievable read bandwidth (bytes/s) over the packed words: a
    reduction that reads every byte once, with negligible compute.

    The reduction body is CARRY-DEPENDENT (``sum(w ^ c)``): a loop-invariant
    ``sum(w)`` is hoistable by XLA, which silently turns the measurement into
    garbage.  XOR-with-carry cannot be factored out of the sum, forcing one
    genuine full read per iteration."""
    words = geno.words

    @jax.jit
    def loop(w, s0):
        def body(c, _):
            s = jnp.sum(w ^ c, dtype=jnp.int32)
            return c + s, ()
        c, _ = jax.lax.scan(body, s0, None, length=iters)
        return c

    dt = median_seconds(loop, words, jnp.int32(1)) / iters
    return words.nbytes / dt


def kernel_roofline(geno, m: int = 1, iters: int = 10, want_missing=None,
                    measured_roof: float | None = None):
    """Achieved bandwidth of the X'R pass on `geno` (PackedGenotypes) through
    the active score path (ops/linalg.use_kernel).

    Returns ms/pass, effective GB/s over packed bytes, and the fraction of
    the published peak (and of ``measured_roof`` from
    :func:`stream_bandwidth`, when given).  Uses a data-dependent in-jit
    loop so results are not distorted by dispatch overhead."""
    from ..ops.linalg import PackedOp, use_kernel

    if want_missing is None:
        want_missing = geno.has_missing
    g = dataclasses.replace(geno, has_missing=bool(want_missing))

    @jax.jit
    def loop(g, rhs0):
        def body(r, _):
            A, _, _ = PackedOp(g)._xt_dots(r)
            r2 = r * (1.0 + A[1, 0] * 1e-12) + A[0, 0] * 1e-6
            return r2, jnp.sum(A)
        _, outs = jax.lax.scan(body, rhs0, None, length=iters)
        return outs

    rhs0 = jnp.ones((geno.n_pad, m), jnp.float32)
    dt = median_seconds(loop, g, rhs0) / iters
    bw = geno.words.nbytes / dt
    out = {
        "ms_per_pass": dt * 1e3,
        "packed_gbytes_per_s": bw / 1e9,
        "hbm_roofline_fraction": bw / device_peaks()["hbm_bytes_per_s"],
        "rhs_columns": m,
        "want_missing": want_missing,
        "backend": "kernel" if use_kernel() else "xla",
    }
    if measured_roof:
        out["measured_stream_gbytes_per_s"] = measured_roof / 1e9
        out["measured_roofline_fraction"] = bw / measured_roof
    return out


def fit_report(y, x, z=None, **kwargs):
    """Run fit_iht with a phase-level wall-clock breakdown."""
    from ..models.fit import build_fit
    from ..models.initialize import init_state
    from ..models.univariate import run_segment, finalize_iht

    t = {}
    t0 = time.time()
    op, data, cfg, k_scalar = build_fit(y, x, z, **kwargs)
    t["build"] = time.time() - t0

    ks = jnp.asarray([k_scalar], jnp.int32)
    cv = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    t0 = time.time()
    st = jax.block_until_ready(init_state(op, data, cfg, ks, cv))
    t["init"] = time.time() - t0
    t0 = time.time()
    st = jax.block_until_ready(run_segment(op, data, cfg, st, cfg.max_iter - 1))
    t["solve"] = time.time() - t0
    t0 = time.time()
    st = jax.block_until_ready(finalize_iht(op, data, cfg, st))
    t["finalize"] = time.time() - t0
    t["iterations"] = int(st.iteration)
    t["ms_per_iteration"] = (t["solve"] / max(int(st.iteration), 1)) * 1e3
    return t, st
