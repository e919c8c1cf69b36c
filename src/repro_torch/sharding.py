"""Data-parallel axes and the per-leaf FSDP (ZeRO) dims of a parameter tree.

The port of what the JAX package's ``runtime/step.py`` keeps for its
shard_map over the ``("pod", "data")`` axes: :func:`dp_axes_of`, the FSDP
dims of each leaf (:func:`repro_torch.models.param.tree_fsdp_dims`), their
per-layer form inside the layer loop (:func:`strip_layer_dim`) and a map over
a tree beside its dims (:func:`map_with_dims`).  A leaf's dim is the one its
ZeRO shard is cut along over the data axis, or None (replicated in the pod).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.tree import flatten, unflatten
from repro_torch.models.param import tree_fsdp_dims

__all__ = ["dp_axes_of", "tree_fsdp_dims", "strip_layer_dim", "map_with_dims"]


def dp_axes_of(mesh) -> tuple[str, ...]:
    """The data-parallel axes of `mesh`, in the reference's order."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def strip_layer_dim(dims_tree):
    """The dims of one layer's parameters from those of the stacked
    ``(layers, ...)`` leaves: every dim one lower; a leaf cut along the
    layer dim itself is not gathered inside the layer loop (None)."""
    leaves, td = flatten(dims_tree)
    return unflatten(td, [None if d in (None, 0) else d - 1 for d in leaves])


def map_with_dims(fn: Callable, tree, dims):
    """``fn(leaf, dim)`` over the leaves of `tree` beside those of `dims`."""
    leaves, td = flatten(tree)
    return unflatten(td, [fn(x, d) for x, d in zip(leaves, flatten(dims)[0])])
