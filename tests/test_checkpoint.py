"""Checkpoint/resume oracle: a segmented + checkpointed CV must equal the
single-shot CV exactly (this framework's addition over the reference, which
stages long runs manually — SURVEY.md §5)."""

import numpy as np
import pytest

import mendeliht as m


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(123)
    x, _ = m.simulate_random_snparray(None, 300, 400, rng=rng)
    y, true_b, pos = m.simulate_random_response(x, 4, m.Normal(), rng=rng)
    folds = np.tile(np.arange(1, 4), 100)
    return x, y, folds


def test_checkpointed_equals_plain(problem, tmp_path):
    x, y, folds = problem
    mse_plain = m.cv_iht(y, x, path=[2, 4, 6], q=3, folds=folds,
                         d=m.Normal(), verbose=False)
    mse_ckpt = m.cv_iht(y, x, path=[2, 4, 6], q=3, folds=folds,
                        d=m.Normal(), verbose=False,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=3)
    np.testing.assert_allclose(mse_ckpt, mse_plain, rtol=1e-6)


def test_resume_from_checkpoint(problem, tmp_path):
    """Simulate preemption: run with a tiny max_iter budget to force an early
    checkpoint, then resume with the full budget; result must match the
    uninterrupted run."""
    x, y, folds = problem
    ckdir = str(tmp_path / "ck2")
    from mendeliht.utils import checkpoint as ckpt

    # interrupted run: stop after the first segment by monkey-limiting steps
    m.cv_iht(y, x, path=[2, 4, 6], q=3, folds=folds, d=m.Normal(),
             verbose=False, checkpoint_dir=ckdir, checkpoint_every=2,
             max_iter=5)
    assert ckpt.latest_step(ckdir) is not None

    # resumed run with the full budget picks up the saved state
    mse_resumed = m.cv_iht(y, x, path=[2, 4, 6], q=3, folds=folds,
                           d=m.Normal(), verbose=False,
                           checkpoint_dir=ckdir, checkpoint_every=50,
                           max_iter=100)
    mse_plain = m.cv_iht(y, x, path=[2, 4, 6], q=3, folds=folds,
                         d=m.Normal(), verbose=False, max_iter=100)
    np.testing.assert_allclose(mse_resumed, mse_plain, rtol=1e-5)
