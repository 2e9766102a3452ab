"""Checkpoint / resume for long cross-validation runs.

The reference has no checkpointing — UK-Biobank runs were manually staged
(SURVEY.md §5). Here the solver loop is resumable (`run_segment` advances the
state pytree to an iteration bound and can continue from the saved state), so
long CV can survive preemption: pass ``checkpoint_dir`` (and optionally
``checkpoint_every``) to :func:`mendeliht.cv_iht`.

A checkpoint is one numpy ``.npz`` file per step holding every field of the
state dataclass; the latest two are kept.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.npz")


def save_state(directory: str, st, step: int):
    """Save a solver state dataclass at `directory`/step_<n>.npz (written to
    a temporary name, then renamed, so a killed run never leaves a torn
    file), keeping the latest two steps."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + ".tmp.npz"
    arrays = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    for s in sorted(all_steps(directory))[:-2]:
        os.remove(_path(directory, s))
    return path


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                out.append(int(name[5:-4]))
            except ValueError:
                pass
    return out


def latest_step(directory: str):
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore_state(directory: str, like, step: int | None = None):
    """Restore a state saved by :func:`save_state` into the dataclass type of
    `like` (used for shape/dtype reference). Returns (state, step) or None."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    with np.load(_path(directory, step)) as d:
        cast = {}
        for f in dataclasses.fields(like):
            ref = getattr(like, f.name)
            cast[f.name] = jax.numpy.asarray(d[f.name]).astype(
                ref.dtype).reshape(ref.shape)
    return dataclasses.replace(like, **cast), step
