"""Smoke run of mendeliht on NVIDIA GPUs at the reference benchmark size.

    python chip_smoke.py           # phases kernel, fit, cv, mv, wrapper; 1 GPU
    python chip_smoke.py --four    # only the SNP-sharded 4-GPU path and the
                                   # single-GPU run it is compared with
    python chip_smoke.py --phases kernel,fit    # a subset of the phases

The problems are generated on the device from fixed seeds: 10,000 samples x
1,000,000 SNPs (the reference's own benchmark shape, BASELINE.md row 3;
2.56 GB of packed words), 50,000 x 1,000,000 for ``--four``.  Every phase
checks its results against the plain XLA path (ops/decode.py) or the
simulation truth, and any failure makes the script exit non-zero.  With no
GPU it exits non-zero before any phase runs.  The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The phase functions also run at tiny sizes on the CPU (tests/test_chip.py),
where the kernel runs in Pallas interpret mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bounds (see CHANGES.md): kernel vs the f32 XLA oracle relative to each
# column's max |output|; fit logl relative; cv MSE relative
KERNEL_TOL = 2e-5
LOGL_RTOL = 1e-3
CV_RTOL = 5e-3


class SmokeFailure(Exception):
    """A result outside its bound."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_info() -> str:
    """Card name and power limit, from nvidia-smi (a child that never
    imports JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


# ---------------------------------------------------------------------------
# data, generated on the device
# ---------------------------------------------------------------------------

def simulate_geno(seed: int, n: int, p: int, *, missing: bool = False,
                  device=None):
    """Uniform random 2-bit codes in the canonical quad-word layout, with
    per-SNP stats, built on the device.  Without ``missing`` the missing code
    01 is remapped to 00 (like the reference's benchmark simulations), so
    genotypes are 0/1/2 with probabilities 1/2, 1/4, 1/4."""
    import jax
    import jax.numpy as jnp
    from mendeliht.genotype.snparray import PackedGenotypes, _ceil_to, _LANE

    n4 = _ceil_to(-(-n // 4), _LANE)
    p4 = -(-p // 4)
    c55 = jnp.uint32(0x55555555)

    @jax.jit
    def gen(key):
        w = jax.random.bits(key, (p4, n4), jnp.uint32)
        if not missing:
            lo, hi = w & c55, (w >> 1) & c55
            w = w ^ (lo & ~hi)
        # crumb q of byte column b is sample q*n4 + b; bytes of row i are
        # SNPs 4i..4i+3: clear crumbs past n and bytes past p
        b = jnp.arange(n4, dtype=jnp.uint32)
        keep_col = sum(jnp.where(q * n4 + b < n, jnp.uint32(0x03030303 << 2 * q),
                                 jnp.uint32(0)) for q in range(4))
        snp = 4 * jnp.arange(p4, dtype=jnp.uint32)
        keep_row = sum(jnp.where(snp + k < p, jnp.uint32(0xFF << 8 * k),
                                 jnp.uint32(0)) for k in range(4))
        w = w & keep_col[None, :] & keep_row[:, None]
        lo, hi = w & c55, (w >> 1) & c55

        def per_snp(bits):
            cnt = [jnp.sum(jax.lax.population_count((bits >> 8 * k) & 0xFF),
                           axis=1, dtype=jnp.int32) for k in range(4)]
            return jnp.stack(cnt, axis=1).reshape(-1)[:p]

        het, alt, mis = per_snp(hi & ~lo), per_snp(hi & lo), per_snp(lo & ~hi)
        n_obs = n - mis
        mu = (het + 2.0 * alt) / jnp.maximum(n_obs, 1)
        sd = jnp.sqrt(jnp.maximum(mu * (1.0 - mu / 2.0), 0.0))
        inv_sd = jnp.where(sd > 0, 1.0 / jnp.where(sd > 0, sd, 1.0), 0.0)
        return (jax.lax.bitcast_convert_type(w, jnp.int32),
                mu.astype(jnp.float32), inv_sd.astype(jnp.float32),
                jnp.any(mis > 0))

    key = jax.random.PRNGKey(seed)
    if device is not None:
        key = jax.device_put(key, device)
    words, mu, inv_sd, any_missing = gen(key)
    return PackedGenotypes(words=words, mu=mu, inv_sd=inv_sd, n=n, p=p,
                           has_missing=bool(any_missing))


def sub_geno(g, p: int):
    """The first ``p`` SNPs of ``g`` (p a multiple of 4)."""
    from mendeliht.genotype.snparray import PackedGenotypes
    return PackedGenotypes(words=g.words[:p // 4], mu=g.mu[:p],
                           inv_sd=g.inv_sd[:p], n=g.n, p=p,
                           has_missing=g.has_missing)


def linear_predictor(g, causal, beta):
    """Standardized X[:, causal] @ beta on the device -> (r, n) host array
    (beta of shape (k,) or (r, k))."""
    import jax.numpy as jnp
    from mendeliht.ops.linalg import PackedOp
    op = PackedOp(g)
    idx = jnp.asarray(np.asarray(causal)[None, :], jnp.int32)
    coef = jnp.asarray(np.atleast_2d(beta)[None], jnp.float32)
    xb = op.forward_sel_multi(idx, coef, jnp.ones(idx.shape, jnp.float32))
    return np.asarray(xb[0, :, :g.n], np.float64)


def gaussian_response(g, seed, k, p_causal=None):
    """y = X[:, causal] beta + 1 + N(0, 1), beta ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    causal = np.sort(rng.choice(p_causal or g.p, size=k, replace=False))
    beta = rng.standard_normal(k)
    y = linear_predictor(g, causal, beta)[0] + 1.0 + rng.standard_normal(g.n)
    return y, causal, beta


def recovered(beta, causal) -> int:
    return len(set(np.flatnonzero(beta)) & set(np.asarray(causal).tolist()))


# ---------------------------------------------------------------------------
# phases: each returns a dict of numbers and raises on a failed check
# ---------------------------------------------------------------------------

KERNEL_WIDTHS = ((1, False), (2, True), (100, False))


def phase_kernel(g, g_miss, *, n_ref=65536, reps=5,
                 widths=KERNEL_WIDTHS, time_widths=(1, 100)):
    """Fused score kernel vs decode.xt_dots (f32, HIGHEST) on the first
    ``n_ref`` SNPs, at every width with and without missing calls; then
    warm per-pass times of the kernel and of the XLA path the operator
    falls back to (byte-view copy + decode.xt_dots) on the whole matrix."""
    import jax
    import jax.numpy as jnp
    from mendeliht.ops import decode, score_kernel
    from mendeliht.utils.profiling import median_seconds

    interpret = jax.default_backend() != "gpu"
    check(not g.has_missing and g_miss.has_missing,
          "kernel phase needs one problem without and one with missing calls")
    out = {}
    for gg in (g, g_miss):
        wm = gg.has_missing
        ref_bytes = jax.jit(lambda w: jnp.transpose(
            jax.lax.bitcast_convert_type(w, jnp.uint8), (0, 2, 1)
        ).reshape(4 * w.shape[0], w.shape[1]))(gg.words[:n_ref // 4])
        mask = (jnp.arange(gg.n_pad) < gg.n).astype(jnp.float32)[:, None]
        for m, want_sq in widths:
            rhs = jax.random.normal(jax.random.PRNGKey(m), (gg.n_pad, m)) * mask
            got = score_kernel.xt_dots_words(
                gg.words, rhs, want_missing=wm, want_sq=want_sq, p=gg.p,
                interpret=interpret)
            want = decode.xt_dots(ref_bytes, rhs, want_missing=wm,
                                  want_sq=want_sq)
            err = 0.0
            for a, b in zip(got, want):
                if b is None:
                    continue
                a, b = np.asarray(a[:n_ref]), np.asarray(b)
                col_max = np.maximum(np.abs(b).max(axis=0), 1e-30)
                err = max(err, float((np.abs(a - b).max(axis=0) / col_max).max()))
            key = f"err_m{m}{'_sq' if want_sq else ''}_missing{int(wm)}"
            out[key] = err
            check(np.isfinite(err) and err <= KERNEL_TOL,
                  f"{key} = {err:.3e} > {KERNEL_TOL}")
    if reps:
        for m in time_widths:
            rhs = jax.random.normal(jax.random.PRNGKey(7), (g.n_pad, m))
            kern = jax.jit(lambda w, r: score_kernel.xt_dots_words(
                w, r, want_missing=False, p=g.p, interpret=interpret)[0])
            plain = jax.jit(lambda gg, r: decode.xt_dots(
                gg.packed, r, want_missing=False)[0])
            out[f"kernel_ms_m{m}"] = 1e3 * median_seconds(kern, g.words, rhs,
                                                         reps=reps)
            out[f"xla_ms_m{m}"] = 1e3 * median_seconds(plain, g, rhs, reps=reps)
    return out


def _fit_program_memory(y, g, k):
    import jax.numpy as jnp
    from mendeliht.models.fit import build_fit
    from mendeliht.models.univariate import fit_fused_sparse
    op, data, cfg, k_scalar = build_fit(y, g, None, k=k)
    ks = jnp.asarray([k_scalar], jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (1, op.n_pad))
    compiled = fit_fused_sparse.lower(op, data, cfg, ks, cv_wts,
                                      init_beta=False).compile()
    return compiled.memory_analysis()


def phase_fit(g, *, k=10, seed=11, min_recovered=9):
    """Gaussian fit with the default score path and with the XLA path (same
    support, |dlogl| < 1e-3 |logl|, >= min_recovered of k causal SNPs), then
    one Bernoulli fit."""
    import mendeliht as m
    from mendeliht.ops.linalg import set_kernel_backend

    y, causal, beta = gaussian_response(g, seed, k)
    print(f"  fit program memory: {_fit_program_memory(y, g, k)}", flush=True)
    out = {}
    t0 = time.perf_counter()
    r0 = m.fit_iht(y, g, k=k, verbose=False)
    out["default_cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r0 = m.fit_iht(y, g, k=k, verbose=False)
    out["default_warm_s"] = time.perf_counter() - t0
    try:
        set_kernel_backend("xla")
        t0 = time.perf_counter()
        r1 = m.fit_iht(y, g, k=k, verbose=False)
        out["xla_cold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r1 = m.fit_iht(y, g, k=k, verbose=False)
        out["xla_warm_s"] = time.perf_counter() - t0
    finally:
        set_kernel_backend("auto")
    out.update(iters=r0.iter, logl=r0.logl, logl_xla=r1.logl,
               dlogl_rel=abs(r0.logl - r1.logl) / abs(r1.logl),
               recovered=recovered(r0.beta, causal))
    check(np.array_equal(np.flatnonzero(r0.beta), np.flatnonzero(r1.beta)),
          "default and XLA fits chose different supports")
    check(out["dlogl_rel"] < LOGL_RTOL, f"|dlogl| / |logl| = "
          f"{out['dlogl_rel']:.3e} >= {LOGL_RTOL}")
    check(out["recovered"] >= min_recovered,
          f"recovered {out['recovered']}/{k} causal SNPs")

    rng = np.random.default_rng(seed + 1)
    causal_b = np.sort(rng.choice(g.p, size=k, replace=False))
    xb = linear_predictor(g, causal_b, rng.standard_normal(k))[0]
    yb = rng.binomial(1, 1.0 / (1.0 + np.exp(-xb))).astype(np.float64)
    t0 = time.perf_counter()
    rb = m.fit_iht(yb, g, k=k, d=m.Bernoulli(), verbose=False)
    out["bernoulli_cold_s"] = time.perf_counter() - t0
    out.update(bernoulli_iters=rb.iter, bernoulli_logl=rb.logl,
               bernoulli_recovered=recovered(rb.beta, causal_b))
    check(np.isfinite(rb.logl), "Bernoulli logl is not finite")
    return out


def phase_cv(g, *, p_small=100_000, path=range(1, 21), q=5, k=10, seed=21):
    """cv over the full matrix with the default path; then the same grid on
    the first ``p_small`` SNPs with both score paths (same argmin, MSEs to
    rtol 5e-3)."""
    import mendeliht as m
    from mendeliht.ops.linalg import set_kernel_backend

    path = list(path)
    out = {}
    y, causal, _ = gaussian_response(g, seed, k)
    t0 = time.perf_counter()
    mse = np.asarray(m.cv_iht(y, g, path=path, q=q, verbose=False,
                              rng=np.random.default_rng(3)))
    out["full_cold_s"] = time.perf_counter() - t0
    out["full_best_k"] = path[int(np.argmin(mse))]
    check(np.all(np.isfinite(mse)), "cv MSEs are not finite")

    gs = sub_geno(g, p_small)
    ys, _, _ = gaussian_response(gs, seed + 1, k)
    runs = {}
    try:
        for name in ("auto", "xla"):
            set_kernel_backend(name)
            t0 = time.perf_counter()
            runs[name] = np.asarray(m.cv_iht(ys, gs, path=path, q=q,
                                             verbose=False,
                                             rng=np.random.default_rng(3)))
            out[f"small_{name}_cold_s"] = time.perf_counter() - t0
    finally:
        set_kernel_backend("auto")
    a, b = runs["auto"], runs["xla"]
    out["small_best_k"] = path[int(np.argmin(a))]
    out["small_mse_max_rel"] = float(np.max(np.abs(a - b) / np.abs(b)))
    check(int(np.argmin(a)) == int(np.argmin(b)),
          f"cv argmin differs: {np.argmin(a)} vs {np.argmin(b)}")
    check(out["small_mse_max_rel"] <= CV_RTOL,
          f"cv MSE rel diff {out['small_mse_max_rel']:.3e} > {CV_RTOL}")
    return out


def phase_mv(g, *, traits=3, k_causal=10, k=12, seed=31, min_recovered=9):
    """3-trait multivariate Gaussian fit (k = 12 over 10 shared causal SNPs):
    finite logl and the causal support recovered."""
    import mendeliht as m

    rng = np.random.default_rng(seed)
    causal = np.sort(rng.choice(g.p, size=k_causal, replace=False))
    B = rng.standard_normal((traits, k_causal)) * 0.5
    Sigma = m.random_covariance_matrix(traits, rng=rng)
    E = np.linalg.cholesky(Sigma) @ rng.standard_normal((traits, g.n))
    Y = np.ascontiguousarray(linear_predictor(g, causal, B) + E)
    t0 = time.perf_counter()
    res = m.fit_iht(Y, g, k=k, d=m.MvNormal(), verbose=False, min_iter=10,
                    init_beta=True)
    out = {"cold_s": time.perf_counter() - t0, "iters": res.iter,
           "logl": res.logl,
           "recovered": recovered(np.any(res.beta != 0, axis=0), causal)}
    check(np.isfinite(res.logl), "multivariate logl is not finite")
    check(out["recovered"] >= min_recovered,
          f"recovered {out['recovered']}/{k_causal} causal SNPs")
    return out


def phase_wrapper(*, n=1000, p=10_000, k=8, seed=41, path=range(1, 11), q=3):
    """write_plink_bed a seeded fileset, then iht() and cross_validate() on
    it (PLINK ingestion, including the native repack)."""
    import mendeliht as m

    rng = np.random.default_rng(seed)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as d:
        prefix = os.path.join(d, "sim")
        x, _ = m.simulate_random_snparray(prefix + ".bed", n, p, rng=rng)
        y, true_b, _ = m.simulate_random_response(x, k, m.Normal(), rng=rng)
        m.make_bim_fam_files(x, y, prefix)
        t0 = time.perf_counter()
        res = m.iht(prefix, k, m.Normal, verbose=False,
                    summaryfile=os.path.join(d, "iht.summary.txt"),
                    betafile=os.path.join(d, "iht.beta.txt"))
        out["iht_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mse = np.asarray(m.cross_validate(
            prefix, m.Normal, path=path, q=q, verbose=False,
            cv_summaryfile=os.path.join(d, "cviht.summary.txt"),
            rng=np.random.default_rng(3)))
        out["cross_validate_s"] = time.perf_counter() - t0
    out["recovered"] = recovered(res.beta, np.flatnonzero(true_b))
    out["best_k"] = list(path)[int(np.argmin(mse))]
    check(np.isfinite(res.logl), "wrapper logl is not finite")
    check(out["recovered"] >= k - 2, f"recovered {out['recovered']}/{k}")
    check(np.all(np.isfinite(mse)), "wrapper cv MSEs are not finite")
    return out


def phase_four(*, n=50_000, p=1_000_000, k=10, seed=51, devices=None,
               max_iter=30):
    """SNP-sharded solver over four devices vs the same solve on one: a
    Gaussian fit on a (task=1, snp=4) mesh, then a 4-task cv batch on a
    (task=2, snp=2) mesh, each against the single-device run."""
    import jax
    import jax.numpy as jnp
    from mendeliht.models.fit import build_fit
    from mendeliht.models.initialize import init_state
    from mendeliht.models.univariate import run_iht
    from mendeliht.parallel.mesh import (make_mesh, shard_data,
                                         shard_geno_op, shard_state)

    devices = jax.devices()[:4] if devices is None else devices
    check(len(devices) == 4, f"need 4 devices, found {len(devices)}")
    g = simulate_geno(seed, n, p, device=devices[0])
    y, causal, _ = gaussian_response(g, seed, k)
    op, data, cfg, _ = build_fit(y, g, None, k=k, max_iter=max_iter)
    out = {}

    def compare(tag, ks, cv_wts, n_task, n_snp):
        st = init_state(op, data, cfg, ks, cv_wts)
        t0 = time.perf_counter()
        ref = jax.block_until_ready(run_iht(op, data, cfg, st))
        out[f"{tag}_single_s"] = time.perf_counter() - t0
        mesh = make_mesh(n_task=n_task, n_snp=n_snp, devices=devices)
        op_s = shard_geno_op(op, mesh)
        held = {s.device for s in op_s.geno.words.addressable_shards}
        check(len(held) == n_task * n_snp,
              f"{tag}: words on {len(held)} devices")
        out[f"{tag}_word_devices"] = len(held)
        t0 = time.perf_counter()
        got = jax.block_until_ready(run_iht(
            op_s, shard_data(data, mesh), cfg, shard_state(st, mesh)))
        out[f"{tag}_sharded_s"] = time.perf_counter() - t0
        l0, l1 = np.asarray(ref.best_logl), np.asarray(got.best_logl)
        out[f"{tag}_dlogl_rel"] = float(np.max(np.abs(l1 - l0) / np.abs(l0)))
        same = np.array_equal(np.asarray(ref.b) != 0, np.asarray(got.b) != 0)
        out[f"{tag}_same_support"] = bool(same)
        check(same, f"{tag}: sharded and single-device supports differ")
        check(out[f"{tag}_dlogl_rel"] < LOGL_RTOL,
              f"{tag}: |dlogl| / |logl| = {out[tag + '_dlogl_rel']:.3e}")
        return ref

    ref = compare("fit", jnp.asarray([k], jnp.int32),
                  data.sample_mask[None, :], 1, 4)
    out["fit_recovered"] = recovered(np.asarray(ref.b[0]), causal)
    check(out["fit_recovered"] >= k - 1,
          f"recovered {out['fit_recovered']}/{k} causal SNPs")
    fold = np.random.default_rng(seed).integers(0, 2, g.n_pad)
    train = np.stack([fold == 0, fold == 1] * 2).astype(np.float32)
    cv_wts = jnp.asarray(train) * data.sample_mask[None, :]
    compare("cv", jnp.asarray([5, 5, 15, 15], jnp.int32), cv_wts, 2, 2)
    return out


PHASES = ("kernel", "fit", "cv", "mv", "wrapper")


class _Problems:
    """The 10k x 1M problems, generated once and shared by the phases."""

    def __init__(self, n=10_000, p=1_000_000):
        self.n, self.p = n, p
        self._g = self._g_miss = None

    @property
    def g(self):
        if self._g is None:
            self._g = simulate_geno(1, self.n, self.p)
        return self._g

    @property
    def g_miss(self):
        if self._g_miss is None:
            self._g_miss = simulate_geno(2, self.n, self.p, missing=True)
        return self._g_miss


def run_phases(phases, card, probs=None):
    """Run each phase, printing its numbers beside the card; returns the
    names of the phases that failed."""
    probs = probs or _Problems()
    calls = {
        "kernel": lambda: phase_kernel(probs.g, probs.g_miss),
        "fit": lambda: phase_fit(probs.g),
        "cv": lambda: phase_cv(probs.g),
        "mv": lambda: phase_mv(probs.g),
        "wrapper": lambda: phase_wrapper(),
        "four": lambda: phase_four(),
    }
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            res = calls[name]()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s "
                  f"({card})", flush=True)
            continue
        for key, val in res.items():
            print(f"[{name}] {key} = {val} ({card})", flush=True)
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s ({card})",
              flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded path and its comparison")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    import jax
    import mendeliht  # noqa: F401  (fails here, not mid-run, without the repo)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    phases = ["four"] if args.four else [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - {"four"}
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    t0 = time.perf_counter()
    failed = run_phases(phases, card)
    print(f"total {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
