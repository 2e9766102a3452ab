"""Multi-host (multi-process) distributed execution.

The reference scales cross-validation with Distributed.jl `addprocs` — every
worker holds a full copy of the genotype matrix and fits its share of
(fold, k) combinations (reference src/cross_validation.jl:133-204,
figures/ukbiobank/distribute_folds.jl).  This design instead keeps
ONE global SPMD program over a multi-process (task, snp) device mesh:

  * each host reads only its own SNP-shard of the `.bed` file (the format is
    SNP-major, so a shard is one contiguous byte range — no host ever touches
    the full matrix),
  * the packed words / per-SNP stats become global `jax.Array`s sharded
    P("snp", None) across all hosts' devices,
  * the existing solver runs UNCHANGED: the same jitted program executes on
    every process, `shard_map` collectives (psum over 'snp') ride the
    device interconnect,
  * per-sample arrays are replicated; cv (fold, k) tasks shard over 'task'.

Usage (same script launched once per host):

    from mendeliht.parallel import multihost as mh
    mh.initialize()                      # env-driven, or pass coordinator
    mesh = mh.make_global_mesh(n_snp=jax.process_count())
    x = mh.load_bed_shard("data/geno", mesh)       # host-sharded ingest
    op = ShardedPackedOp(x, mesh)                  # or shard_geno_op
    result = fit_iht(y, op, ...)                   # unchanged solver
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh
from ..genotype.snparray import PackedGenotypes, _ceil_to, _LANE


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None):
    """Start the JAX distributed runtime (no-op if already running).

    With no arguments the cluster-environment autodetection is used
    (SLURM, ...); pass explicit values for manual localhost clusters.
    Reference analog: `addprocs` + `@everywhere using MendelIHT`
    (figures/ukbiobank/distribute_folds.jl:1-2)."""
    # NOTE: do not probe jax.process_count() here — it initializes the XLA
    # backend, after which distributed.initialize() refuses to run.
    try:
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is not None:
            return
    except Exception:
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kwargs)


def make_global_mesh(n_task: int | None = None,
                     n_snp: int | None = None) -> Mesh:
    """(task, snp) mesh over ALL processes' devices (jax.devices() is global
    after initialize())."""
    return make_mesh(n_task=n_task, n_snp=n_snp, devices=jax.devices())


def shard_rows(p: int, n_shards: int):
    """(p_pad, per-shard row ranges): equal-sized shards (jax requires even
    splits along a sharded axis), rounded to multiples of 4 so every shard
    owns whole quad-word rows (genotype/snparray.py layout). Padding rows
    carry inv_sd == 0 so they are inert in every product; callers strip
    them via the true `p`."""
    per = -(-(-(-p // n_shards)) // 4) * 4
    return per * n_shards, [(min(i * per, p), min((i + 1) * per, p))
                            for i in range(n_shards)]


def bed_dims(prefix: str) -> tuple[int, int]:
    """(n, p) from the .fam line count and the .bed byte size."""
    with open(prefix + ".fam") as f:
        n = sum(1 for line in f if line.strip())
    bpr = -(-n // 4)
    size = os.path.getsize(prefix + ".bed") - 3
    if size % bpr:
        raise ValueError(f"{prefix}.bed size is not a multiple of ceil(n/4)")
    return n, size // bpr


def load_bed_shard(prefix: str, mesh: Mesh, dtype=jnp.float32,
                   ) -> tuple[PackedGenotypes, int]:
    """Host-sharded PLINK ingest.

    Every process reads ONLY the contiguous `.bed` byte ranges of the SNP
    rows owned by its local devices (`.bed` is SNP-major: SNP j occupies
    bytes [3 + j*ceil(n/4), 3 + (j+1)*ceil(n/4))), repacks them to the
    crumb-transposed word layout with local per-SNP stats, and assembles
    global sharded arrays with `jax.make_array_from_callback`.

    Returns (geno, p_true): `geno.p` is padded to an even multiple of the
    'snp' axis; pad rows have inv_sd == 0 (inert). Slice betas to p_true."""
    n, p = bed_dims(prefix)
    bpr = -(-n // 4)
    ns = int(mesh.shape["snp"])
    p_pad, ranges = shard_rows(p, ns)
    per = p_pad // ns
    n4 = _ceil_to(bpr, _LANE)
    np_dtype = np.dtype(dtype)

    # local repack: every snp-shard coordinate owned by one of this process's
    # devices (device (t, s) owns ranges[s])
    pid = jax.process_index()
    devarr = mesh.devices
    owned = sorted({s for t in range(devarr.shape[0])
                    for s in range(devarr.shape[1])
                    if devarr[t, s].process_index == pid})
    blocks = {}
    local_missing = 0
    per4 = per // 4          # quad-word rows per shard (per is a mult of 4)
    for s in owned:
        lo, hi = ranges[s]
        rows = hi - lo
        w = np.zeros((per4, n4), np.int32)
        mu = np.zeros(per, np_dtype)
        inv = np.zeros(per, np_dtype)
        if rows > 0:
            with open(prefix + ".bed", "rb") as f:
                f.seek(3 + lo * bpr)
                raw = np.frombuffer(f.read(rows * bpr), np.uint8)
            sub = PackedGenotypes.from_bed_bytes(raw, n, rows, dtype=dtype)
            w[:sub.words.shape[0]] = np.asarray(sub.words)
            mu[:rows] = np.asarray(sub.mu)
            inv[:rows] = np.asarray(sub.inv_sd)
            local_missing += int(np.asarray(sub.n_missing).sum())
        blocks[s] = (w, mu, inv)

    snp2 = NamedSharding(mesh, P("snp", None))
    snp1 = NamedSharding(mesh, P("snp"))

    def cb(idx):
        def f(index):
            per_ax0 = per4 if idx == 0 else per
            return blocks[(index[0].start or 0) // per_ax0][idx]
        return f

    words = jax.make_array_from_callback((p_pad // 4, n4), snp2, cb(0))
    mu = jax.make_array_from_callback((p_pad,), snp1, cb(1))
    inv_sd = jax.make_array_from_callback((p_pad,), snp1, cb(2))

    # has_missing is STATIC jit config — it must agree on every process, so
    # reduce the local counts across hosts before constructing the container.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        total_missing = int(np.sum(multihost_utils.process_allgather(
            np.asarray([local_missing], np.int64))))
    else:
        total_missing = local_missing

    geno = PackedGenotypes(words=words, mu=mu, inv_sd=inv_sd,
                           n=n, p=p_pad, has_missing=total_missing > 0,
                           maf_=None, n_missing=None)
    return geno, p


def replicate(tree, mesh: Mesh):
    """device_put every leaf with a fully-replicated sharding on `mesh` —
    required in multi-process mode where plain np/jnp arrays are not valid
    jit inputs alongside global arrays."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), rep), tree)


def nnz_throughput(n: int, p: int, iters: int, seconds: float) -> float:
    """Scaling metric: genotype entries streamed per second (BASELINE.md
    north star: >=80% efficiency at >=2 hosts on 500k x 1M)."""
    return n * p * max(iters, 1) / seconds


def scaling_efficiency(single_host_nnz_s: float, multi_host_nnz_s: float,
                       n_hosts: int) -> float:
    return multi_host_nnz_s / (single_host_nnz_s * n_hosts)


# the device whose published rates comm_model assumes by default
_MODEL_DEVICE = "NVIDIA H100 80GB HBM3"


def comm_model(n: int, p: int, B: int = 1, n_task: int = 1, n_snp: int = 1,
               stream_bytes_per_s: float | None = None,
               link_bytes_per_s: float | None = None,
               backtracks_per_iter: float = 0.0) -> dict:
    """Per-iteration byte/time model of the SNP-sharded IHT solver.

    Accounts (see parallel/sharded_ops.py for the op structure):
      * local: one full read of the shard's packed words per iteration — the
        score pass ``X' R`` is communication-free because every SNP row is
        owned by exactly one 'snp' shard (reference analog: per-thread
        column loops, src/utilities.jl:96-106);
      * collectives: the k-sparse forward product and the stepsize product
        each psum a (B/n_task, n_pad) f32 over 'snp' (ring all-reduce moves
        2*(ns-1)/ns of the payload per device); each backtrack round adds
        one more forward psum; the global top-k projection gathers only
        per-shard candidate lists (B/n_task * S * 8 bytes * ns — negligible).

    ``stream_bytes_per_s`` and ``link_bytes_per_s`` default to the published
    H100 SXM rates (utils/profiling.py: 3.35 TB/s device memory, 450 GB/s
    of NVLink each way); neither has been measured by this program.  The
    predicted efficiency assumes no compute/comm overlap (pessimistic: XLA
    overlaps the psums with the next tile's decode when it can)."""
    from ..utils.profiling import device_peaks
    peaks = device_peaks(_MODEL_DEVICE)
    if stream_bytes_per_s is None:
        stream_bytes_per_s = peaks["hbm_bytes_per_s"]
    if link_bytes_per_s is None:
        link_bytes_per_s = peaks["nvlink_bytes_per_s_each_way"]
    n4 = _ceil_to(-(-n // 4), _LANE)
    n_pad = 4 * n4
    local_bytes = (p / max(n_snp, 1)) * n4          # packed words per shard
    psums = 2.0 + backtracks_per_iter
    payload = psums * (B / max(n_task, 1)) * n_pad * 4
    ring = 2.0 * (n_snp - 1) / n_snp if n_snp > 1 else 0.0
    comm_bytes = payload * ring
    t_local = local_bytes / stream_bytes_per_s
    t_comm = comm_bytes / link_bytes_per_s
    t1 = p * n4 / stream_bytes_per_s                # single-shard iteration
    return {
        "local_bytes_per_iter": local_bytes,
        "psum_payload_bytes_per_iter": payload,
        "collective_bytes_per_iter": comm_bytes,
        "t_local_s": t_local,
        "t_comm_s": t_comm,
        "t_iter_s": t_local + t_comm,
        "predicted_efficiency": t1 / (max(n_snp, 1) * (t_local + t_comm)),
    }
