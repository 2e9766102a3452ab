"""Cross-validation tests (reference analog: test/cv_iht_test.jl — which
deliberately asserts only `all(mse > 0)` because RNG streams differ; we add a
best-k sanity check on a well-separated simulation)."""

import numpy as np
import pytest

import mendeliht as m
from mendeliht.models.cv import allocate_fold_and_k, meanloss


def test_allocate_fold_and_k():
    combos = allocate_fold_and_k(3, [5, 10])
    assert combos == [(1, 5), (1, 10), (2, 5), (2, 10), (3, 5), (3, 10)]


def test_meanloss_weighting():
    folds = np.array([1, 1, 1, 2])          # fold sizes 3 and 1
    losses = np.array([10.0, 20.0, 100.0, 200.0])  # 2 ks x 2 folds
    out = meanloss(losses, 2, folds)
    np.testing.assert_allclose(out, [10 * .75 + 100 * .25, 20 * .75 + 200 * .25])


@pytest.fixture(scope="module")
def cv_problem(rng):
    x, _ = m.simulate_random_snparray(None, 400, 500, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 5, m.Normal(), rng=rng)
    return x, y, pos


def test_cv_normal(cv_problem, rng):
    x, y, pos = cv_problem
    path = list(range(1, 11))
    mse = m.cv_iht(y, x, path=path, q=3, d=m.Normal(), verbose=False,
                   rng=np.random.default_rng(11))
    assert len(mse) == len(path)
    assert np.all(mse > 0)
    # minimum should be near the true k=5 on this easy problem
    best = path[int(np.argmin(mse))]
    assert 3 <= best <= 9


def test_cv_with_fixed_folds(cv_problem):
    x, y, pos = cv_problem
    folds = np.tile(np.arange(1, 4), 200)[:400]
    mse1 = m.cv_iht(y, x, path=[2, 5], q=3, folds=folds, d=m.Normal(),
                    verbose=False)
    mse2 = m.cv_iht(y, x, path=[2, 5], q=3, folds=folds, d=m.Normal(),
                    verbose=False)
    np.testing.assert_allclose(mse1, mse2)   # deterministic given folds


def test_cv_path_too_large(cv_problem):
    x, y, pos = cv_problem
    with pytest.raises(ValueError):
        m.cv_iht(y, x, path=[501], q=3, d=m.Normal(), verbose=False)


def test_iht_run_many_models(cv_problem):
    x, y, pos = cv_problem
    logls = m.iht_run_many_models(y, x, path=[1, 3, 5], d=m.Normal(),
                                  verbose=False)
    assert len(logls) == 3
    # loglikelihood increases with model size on the training data
    assert logls[0] <= logls[1] + 1e-3 and logls[1] <= logls[2] + 1e-3


def test_cv_group_per_task_k(cv_problem):
    """cv with groups must fit each (fold, k) task at its OWN per-group cap k
    (reference cross_validation.jl:109 `v.k = sparsity`), not max(path).
    Batched cv must equal the same k run alone."""
    x, y, pos = cv_problem
    p = x.shape[1]
    group = (np.arange(p) % 4) + 1            # 4 groups
    folds = np.tile(np.arange(1, 3), 250)[:x.shape[0]]
    mse_batch = m.cv_iht(y, x, path=[2, 5], q=2, folds=folds, group=group,
                         d=m.Normal(), verbose=False)
    mse_k2 = m.cv_iht(y, x, path=[2], q=2, folds=folds, group=group,
                      d=m.Normal(), verbose=False)
    mse_k5 = m.cv_iht(y, x, path=[5], q=2, folds=folds, group=group,
                      d=m.Normal(), verbose=False)
    np.testing.assert_allclose(mse_batch, [mse_k2[0], mse_k5[0]], rtol=1e-5)
    # a smaller per-group cap must actually bind (different fits)
    assert abs(mse_batch[0] - mse_batch[1]) > 1e-8


def test_fit_group_support_size(cv_problem):
    """Scalar-k group fit keeps at most J groups x k per group
    (reference project_group_sparse!, src/utilities.jl:613-645)."""
    x, y, pos = cv_problem
    p = x.shape[1]
    group = (np.arange(p) % 4) + 1
    for k in (2, 3):
        res = m.fit_iht(y, x, k=k, J=2, d=m.Normal(), group=group,
                        verbose=False)
        nz = np.flatnonzero(res.beta)
        assert len(nz) <= 2 * k
        assert len(np.unique(group[nz])) <= 2


def test_cv_debias(cv_problem):
    x, y, pos = cv_problem
    mse = m.cv_iht(y, x, path=[3, 5, 7], q=3, d=m.Normal(), debias=True,
                   verbose=False, rng=np.random.default_rng(5))
    assert np.all(mse > 0)
