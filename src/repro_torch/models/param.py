"""Declarative parameter definitions and their initialization.

Each model builds one nested-dict tree of :class:`PD` (param defs); from that
single source the port derives initialization (:func:`tree_init`) and the
KV-cache buffers.  :func:`params_from_jax` takes the JAX package's parameter
tree (as numpy arrays) into the port's, keeping its names and its stacked
``(layers, ...)`` layout, so both packages compute with the same weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class PD:
    """One parameter definition."""
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # stddev; default fan-in
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PD: shape {self.shape} and axes {self.axes} "
                             f"must have the same rank")


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def _fan_in(pd: PD) -> int:
    # fan-in = product of non-output dims; heuristically first non-layer dim
    dims = [s for s, a in zip(pd.shape, pd.axes) if a not in (None, "layers")]
    return dims[0] if dims else 1


def init_one(pd: PD, gen: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(pd.dtype)
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init != "normal":
        raise NotImplementedError(
            f"init {pd.init!r} belongs to a model family not ported yet "
            f"(ROADMAP.md queue A, 'other model families')")
    std = pd.scale if pd.scale is not None else _fan_in(pd) ** -0.5
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dt)


def is_pd_leaf(x) -> bool:
    return isinstance(x, PD)


def tree_map(fn: Callable, tree, *, is_leaf: Callable = is_pd_leaf):
    """Map `fn` over the leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, tree[k], is_leaf=is_leaf) for k in sorted(tree)}
    return fn(tree)


def tree_init(defs, seed: int = 0, *, device="cuda"):
    """Initialize a full param tree from PDs: one `torch.Generator` seeded
    with `seed` on `device`, drawn leaf by leaf in sorted-key order.  The
    draws differ from the JAX package's `jax.random` ones; tests that
    compare the two packages take the JAX package's tree through
    :func:`params_from_jax`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return tree_map(lambda pd: init_one(pd, gen, device), defs)


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no numpy twin
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree_of_numpy, device="cuda", dtype=None):
    """The JAX package's parameter tree, its leaves converted with
    ``np.asarray``, as the port's tree: same names, same stacked
    ``(layers, ...)`` layout, optionally cast to `dtype`."""
    device = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree_of_numpy,
                    is_leaf=lambda x: not isinstance(x, dict))
