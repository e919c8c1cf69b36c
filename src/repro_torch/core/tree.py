"""Nested-dict trees (the JAX package's pytrees of parameters, gradients and
optimizer state), flattened in sorted-key order as ``jax.tree`` flattens a
dict, so leaf i is the same leaf in both packages."""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef) of a nested dict / list / tuple; anything else is a
    leaf (None included)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", keys, [td for _, td in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [flatten(t) for t in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, len(tree), [td for _, td in parts]))
    return [tree], None


def unflatten(td, leaves: list):
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return next(it)
        kind, keys, subs = t
        items = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, items))
        return items if kind == "list" else tuple(items)

    out = build(td)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"unflatten: {rest} leaves left over")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of `tree` (and the matching leaves of `rest`)."""
    leaves, td = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(td, [fn(x, *ys) for x, *ys in zip(leaves, *others)])
