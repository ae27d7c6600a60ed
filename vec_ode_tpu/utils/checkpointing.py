"""Checkpoint/resume for long ensemble runs.

The reference's 'checkpoints' are time-grid hits, not fault tolerance
(SURVEY §5). This adds actual fault tolerance: the integration carry
(:class:`~vec_ode_tpu.driver.IntState`) is a flat pytree of arrays, so it
serializes directly to a numpy ``.npz`` of its leaves, and
:func:`~vec_ode_tpu.driver.resume` continues from it.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import jax
import numpy as np

from ..driver import IntState


def save_state(path, state: IntState) -> None:
    """Persist an integration carry as an npz of its leaves on the host."""
    flat = jax.tree_util.tree_leaves(state)
    np.savez(
        _npz_path(pathlib.Path(path)),
        **{f"leaf_{i}": np.asarray(a) for i, a in enumerate(flat)},
    )


def _npz_path(path: pathlib.Path) -> pathlib.Path:
    """APPEND .npz (with_suffix would REPLACE a dotted checkpoint name's
    tail — 'ckpt.step100' and 'ckpt.step200' would collide on ckpt.npz)."""
    if path.suffix == ".npz":
        return path
    return pathlib.Path(str(path) + ".npz")


def load_state(path, like: Optional[IntState] = None) -> IntState:
    """Restore a carry saved by :func:`save_state`. ``like`` (a template
    IntState with matching structure) is required: it gives the tree
    structure and each leaf's dtype."""
    data = np.load(_npz_path(pathlib.Path(path)))
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if like is None:
        raise ValueError("load_state requires a template `like`")
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but the template has "
            f"{len(like_leaves)} — structure mismatch"
        )
    # cast each restored leaf to the TEMPLATE's dtype (an x64-saved carry
    # restored under x32 would otherwise silently downcast inconsistently
    # with a fresh IntState)
    return jax.tree_util.tree_unflatten(
        treedef,
        [jax.numpy.asarray(a, getattr(l, "dtype", None))
         for a, l in zip(leaves, like_leaves)],
    )
