"""Multivariate mesh sharding: the sharded mv solver must produce the same
iterates as the single-device solver (round-4 VERDICT missing #1 — the
reference's flagship workloads are multivariate, manuscript/UKBB_hyptertension,
and its mmap design served them at any scale on one node; here the answer
is the (task, snp) mesh).  Runs on the 8-virtual-CPU-device mesh (conftest)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mendeliht as m
from mendeliht.models.mv import (build_mv, init_mv_state, run_mv_iht,
                                     _iteration_mv, cv_mv_fused)
from mendeliht.parallel.mesh import (
    make_mesh, shard_geno_op, shard_mv_state, shard_mv_data, pad_geno_rows)


def _make_problem(rng, n=128, p=512, r=3, k=6):
    codes = rng.choice([0, 2, 3], size=(n, p),
                       p=[0.4, 0.35, 0.25]).astype(np.uint8)
    x = m.PackedGenotypes.from_codes(codes)
    Xd = x.to_dense_standardized()
    Btrue = np.zeros((r, p))
    hot = rng.choice(p, k, replace=False)
    for j in hot:
        Btrue[rng.integers(0, r), j] = rng.standard_normal() * 2
    Y = Btrue @ Xd.T + 0.1 * rng.standard_normal((r, n))
    return x, Y, Btrue


@pytest.fixture(scope="module")
def mv_problem():
    rng = np.random.default_rng(91)
    x, Y, Btrue = _make_problem(rng)
    T = 4
    op, data, cfg = build_mv(Y, x, k=6, max_iter=25)
    ks = jnp.full((T,), 6, jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (T, op.n_pad))
    st = init_mv_state(op, data, cfg, ks, cv_wts)
    return op, data, cfg, st


def _shard_all(op, data, st, n_task, n_snp):
    mesh = make_mesh(n_task=n_task, n_snp=n_snp)
    return (mesh, shard_geno_op(op, mesh), shard_mv_data(data, mesh),
            shard_mv_state(st, mesh))


@pytest.mark.parametrize("n_task,n_snp", [(4, 2), (2, 4), (1, 8)])
def test_sharded_mv_iteration_matches(mv_problem, n_task, n_snp):
    op, data, cfg, st = mv_problem
    ref = _iteration_mv(op, data, cfg, st)
    mesh, op_s, data_s, st_s = _shard_all(op, data, st, n_task, n_snp)
    with mesh:
        out = jax.jit(lambda o, d, s: _iteration_mv(o, d, cfg, s))(
            op_s, data_s, st_s)
    np.testing.assert_allclose(np.asarray(out.B), np.asarray(ref.B),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.logl), np.asarray(ref.logl),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.active),
                                  np.asarray(ref.active))


def test_sharded_mv_full_solve_matches(mv_problem):
    op, data, cfg, st = mv_problem
    ref = run_mv_iht(op, data, cfg, st)
    mesh, op_s, data_s, st_s = _shard_all(op, data, st, 2, 4)
    with mesh:
        out = run_mv_iht(op_s, data_s, cfg, st_s)
    np.testing.assert_allclose(np.asarray(out.best_logl),
                               np.asarray(ref.best_logl), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.B) != 0,
                                  np.asarray(ref.B) != 0)
    np.testing.assert_allclose(np.asarray(out.B), np.asarray(ref.B),
                               rtol=1e-4, atol=1e-5)


def test_sharded_mv_ragged_p():
    """p = 603 over 8 shards (pad to 608 inert rows), causal SNP in the
    ragged tail: sharded == unsharded on the true columns."""
    rng = np.random.default_rng(93)
    n, p, r, k = 96, 603, 2, 5
    codes = rng.choice([0, 2, 3], size=(n, p),
                       p=[0.4, 0.35, 0.25]).astype(np.uint8)
    x = m.PackedGenotypes.from_codes(codes)
    Xd = x.to_dense_standardized()
    Btrue = np.zeros((r, p))
    hot = np.concatenate([rng.choice(p - 1, k - 1, replace=False), [p - 1]])
    for j in hot:
        Btrue[rng.integers(0, r), j] = rng.standard_normal() * 2
    Y = Btrue @ Xd.T + 0.1 * rng.standard_normal((r, n))

    T = 2
    op, data, cfg = build_mv(Y, x, k=k, max_iter=20)
    ks = jnp.full((T,), k, jnp.int32)
    cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (T, op.n_pad))
    st = init_mv_state(op, data, cfg, ks, cv_wts)
    ref = run_mv_iht(op, data, cfg, st)

    xp = pad_geno_rows(x, 8)
    assert xp.p == 608
    opp, datap, cfgp = build_mv(Y, xp, k=k, max_iter=20)
    stp = init_mv_state(opp, datap, cfgp, ks,
                        jnp.broadcast_to(datap.sample_mask[None, :],
                                         (T, opp.n_pad)))
    mesh, op_s, data_s, st_s = _shard_all(opp, datap, stp, 1, 8)
    with mesh:
        out = run_mv_iht(op_s, data_s, cfgp, st_s)
    np.testing.assert_allclose(np.asarray(out.B)[:, :, :p],
                               np.asarray(ref.B), rtol=1e-4, atol=1e-5)
    assert not np.any(np.asarray(out.B)[:, :, p:])   # pads never selected
    np.testing.assert_allclose(np.asarray(out.best_logl),
                               np.asarray(ref.best_logl), rtol=1e-5)


def test_sharded_mv_cv_matches(mv_problem):
    """One fused mv cv batch on the mesh == single-device mses."""
    op, data, cfg, st = mv_problem
    rng = np.random.default_rng(95)
    T = 4
    n = op.n
    folds = rng.integers(1, 3, size=n)
    ks = jnp.asarray([2, 4, 2, 4], jnp.int32)
    train = np.zeros((T, op.n_pad), np.float32)
    test = np.zeros((T, op.n_pad), np.float32)
    for i in range(T):
        fold = 1 + (i // 2)
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold
    train_d, test_d = jnp.asarray(train), jnp.asarray(test)
    ref = cv_mv_fused(op, data, cfg, ks, train_d, test_d)
    mesh, op_s, data_s, _ = _shard_all(op, data, st, 2, 4)
    from jax.sharding import NamedSharding, PartitionSpec as P
    tw = jax.device_put(train_d, NamedSharding(mesh, P("task", None)))
    sw = jax.device_put(test_d, NamedSharding(mesh, P("task", None)))
    with mesh:
        out = cv_mv_fused(op_s, data_s, cfg, ks, tw, sw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
