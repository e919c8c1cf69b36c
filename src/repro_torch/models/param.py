"""Declarative parameter definitions and their initialization.

Each model builds one nested-dict tree of :class:`PD` (param defs); from that
single source the port derives initialization (:func:`tree_init`) and the
KV-cache buffers.  :func:`params_from_jax` takes the JAX package's parameter
tree (as numpy arrays) into the port's, keeping its names and its stacked
``(layers, ...)`` layout, so both packages compute with the same weights.

Under ZeRO a rank holds the shard of each leaf that the JAX package's
``NamedSharding`` over ``"data"`` gives its data index: the leaf cut into
``data`` equal blocks along its FSDP dim (:func:`fsdp_dim`), block i on data
index i (:func:`shard_leaf`; :func:`gather_leaf` is the reverse).

With tensor parallelism (a mesh of ``model > 1``) a rank first holds block
``model_index`` of ``model`` equal blocks of each leaf along its TP dim
(:func:`tp_dim`, the JAX package's ``spec_for``: the dim whose logical axis
is in ``TP_LOGICAL`` and divides by the model size; an indivisible vocab
stays replicated), then its ZeRO block of that, as ``NamedSharding`` lays
out a dim sharded over ``("model", "data")``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class PD:
    """One parameter definition."""
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones | ssm_a | arange
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
    if pd.init == "ssm_a":
        # mamba2's A: -uniform(1, 16), drawn in f32
        u = torch.rand(pd.shape, generator=gen, dtype=torch.float32, device=device)
        return u.mul_(15.0).add_(1.0).neg_().to(dt)
    if pd.init == "arange":
        n = pd.shape[-1]
        r = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return r.expand(pd.shape).contiguous().to(dt)
    if pd.init != "normal":
        raise ValueError(f"unknown init {pd.init!r}")
    std = pd.scale if pd.scale is not None else _fan_in(pd) ** -0.5
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dt)


def shard_leaf(x: torch.Tensor, dim: Optional[int], index: int,
               n: int) -> torch.Tensor:
    """Block `index` of `n` equal blocks of `x` along `dim` (a copy, so the
    full leaf may be freed); `x` itself when `dim` is None or ``n == 1``."""
    if dim is None or n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"leaf of shape {tuple(x.shape)} does not split into "
                         f"{n} blocks along dim {dim}")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).clone()


def gather_leaf(shards: list, dim: Optional[int]) -> torch.Tensor:
    """The full leaf from its shards in data-index order (the reverse of
    :func:`shard_leaf`); the first shard when `dim` is None."""
    if dim is None:
        return shards[0]
    return torch.cat(list(shards), dim=dim)


def _none_like(tree):
    return tree_map(lambda _: None, tree)


def rank_shard(x, dim: Optional[int], tdim: Optional[int], mesh):
    """This rank's shard of the full leaf `x` (a tensor or a numpy array):
    its TP block along `tdim` at ``mesh.model_index``, then its ZeRO block of
    that along `dim` at ``mesh.data_index``; `x` itself where neither cuts."""
    if mesh is None:
        return x
    cut = lambda a, d, i, n: (shard_leaf(a, d, i, n) if isinstance(a, torch.Tensor)
                              else _np_block(a, d, i, n))
    if tdim is not None and mesh.model > 1:
        x = cut(x, tdim, mesh.model_index, mesh.model)
    if dim is not None and mesh.data > 1:
        x = cut(x, dim, mesh.data_index, mesh.data)
    return x


def _np_block(a, dim: Optional[int], index: int, n: int):
    """:func:`shard_leaf` of a numpy array: a view of block `index`."""
    if dim is None or n == 1:
        return a
    a = np.asarray(a)
    if a.shape[dim] % n:
        raise ValueError(f"leaf of shape {a.shape} does not split into "
                         f"{n} blocks along dim {dim}")
    size = a.shape[dim] // n
    return a[(slice(None),) * dim + (slice(index * size, (index + 1) * size),)]


def shard_tree(tree, dims, mesh, tp_dims=None):
    """This rank's shard of every leaf of `tree` (full leaves): its TP block
    along the leaf's dim of `tp_dims` at ``mesh.model_index`` (None:
    replicated over the model ranks), then its ZeRO block along its dim of
    `dims` at ``mesh.data_index`` (None: replicated in the pod); `tree` as
    it is without a mesh, or where neither cuts."""
    if mesh is None or ((dims is None or mesh.data == 1)
                        and (tp_dims is None or mesh.model == 1)):
        return tree
    dims = dims if dims is not None else _none_like(tree)
    tp_dims = tp_dims if tp_dims is not None else _none_like(tree)
    return tree_map(lambda x, d, t: rank_shard(x, d, t, mesh), tree, dims, tp_dims)


def tree_init(defs, seed: int = 0, *, device="cuda", dims=None, mesh=None,
              tp_dims=None):
    """Initialize a param tree from PDs: one `torch.Generator` seeded with
    `seed` on `device`, drawn leaf by leaf in sorted-key order.  With a
    `mesh` and `dims` (ZeRO, ``data > 1``) or `tp_dims` (``model > 1``) each
    full leaf is drawn and only this rank's shard kept
    (:func:`rank_shard`), so the bits do not depend on the mesh.  The draws
    differ from the JAX package's `jax.random` ones; tests that compare the
    two packages take the JAX package's tree through :func:`params_from_jax`
    or :func:`state_from_jax`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if mesh is None or ((dims is None or mesh.data == 1)
                        and (tp_dims is None or mesh.model == 1)):
        return tree_map(lambda pd: init_one(pd, gen, device), defs)
    dims = dims if dims is not None else _none_like(defs)
    tp_dims = tp_dims if tp_dims is not None else _none_like(defs)
    return tree_map(lambda pd, d, t: rank_shard(init_one(pd, gen, device), d, t, mesh),
                    defs, dims, tp_dims)


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """`a` (a numpy array, ml_dtypes' bfloat16 included) as a tensor on
    `device`, in `dtype` or its own."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no numpy twin
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree_of_numpy, device="cuda", dtype=None, *, mesh=None,
                    dims=None, tp_dims=None):
    """The JAX package's parameter tree, its leaves converted with
    ``np.asarray``, as the port's tree: same names, same stacked
    ``(layers, ...)`` layout, optionally cast to `dtype`.  With a `mesh` and
    `dims` (ZeRO) or `tp_dims` (tensor parallelism) each leaf is this rank's
    shard (:func:`shard_tree`), cut from the numpy array before it is
    copied to `device`."""
    device = torch.device(device)
    tree = shard_tree(tree_of_numpy, dims, mesh, tp_dims)
    return tree_map(lambda a: tensor_from_numpy(a, device, dtype), tree)


def state_from_jax(state_of_numpy, device="cuda", *, mesh=None,
                   dims=None, tp_dims=None) -> dict:
    """The JAX package's train state ``{"params", "opt": {"m", "v", "step"}}``,
    its full leaves converted with ``np.asarray``, as the port's: the
    parameters and moments as by :func:`params_from_jax` (dtypes kept), and
    ``step`` as a 0-d int32 tensor.  With `mesh` and `dims` (ZeRO: the train
    bundle's ``dims``) or `tp_dims` (the bundle's ``tp_dims``) the
    parameters and moments are this rank's shards."""
    opt = state_of_numpy["opt"]
    part = lambda t: params_from_jax(t, device, mesh=mesh, dims=dims,
                                     tp_dims=tp_dims)
    return {"params": part(state_of_numpy["params"]),
            "opt": {"m": part(opt["m"]),
                    "v": part(opt["v"]),
                    "step": torch.as_tensor(np.array(opt["step"]),
                                            dtype=torch.int32,
                                            device=torch.device(device))}}


# logical axes that may carry tensor parallelism, and those eligible to carry
# the FSDP ("data") sharding dim: the JAX package's sets
TP_LOGICAL = {"vocab", "heads", "kv_heads", "ff", "experts", "d_inner", "ssm_heads"}
FSDP_LOGICAL = {"d_model", "vocab", "ff", "d_inner", "heads", "kv_heads", "conv_ch", "source"}


def fsdp_dim(pd: PD, fsdp_size: int, tp_size: int = 16) -> Optional[int]:
    """The dim that carries the FSDP ("data") sharding of this param: the
    last dim whose logical axis is FSDP-eligible, not TP-sharded and
    divisible by `fsdp_size`; else the last TP dim divisible by
    ``fsdp_size * tp_size``; else None.  With data = 1 it is the scatter dim
    the cross-pod chunk planner cuts each gradient along."""
    cand = [i for i in range(len(pd.shape))
            if pd.axes[i] in FSDP_LOGICAL
            and pd.axes[i] not in TP_LOGICAL
            and pd.shape[i] % fsdp_size == 0]
    if not cand:
        cand = [i for i in range(len(pd.shape))
                if pd.axes[i] in TP_LOGICAL
                and pd.shape[i] % (fsdp_size * max(tp_size, 1)) == 0]
        return cand[-1] if cand else None
    return cand[-1]


def tree_fsdp_dims(defs, fsdp_size: int, tp_size: int = 16):
    """Per-param :func:`fsdp_dim` (or None), in the tree's layout."""
    return tree_map(lambda pd: fsdp_dim(pd, fsdp_size, tp_size), defs)


def tp_dim(pd: PD, tp_size: int) -> Optional[int]:
    """The dim that carries tensor parallelism over `tp_size` model ranks:
    the JAX package's ``spec_for`` puts ``"model"`` on each dim whose
    logical axis is in ``TP_LOGICAL`` and divides by the size (so an
    indivisible vocab stays replicated).  None with one model rank or no
    such dim; a leaf with two such dims has no valid layout and raises."""
    if tp_size <= 1:
        return None
    dims = [i for i, (a, s) in enumerate(zip(pd.axes, pd.shape))
            if a in TP_LOGICAL and s % tp_size == 0]
    if len(dims) > 1:
        raise ValueError(f"PD {pd.shape} {pd.axes}: dims {dims} would all "
                         f"carry the model axis")
    return dims[0] if dims else None


def tree_tp_dims(defs, tp_size: int):
    """Per-param :func:`tp_dim` (or None), in the tree's layout."""
    return tree_map(lambda pd: tp_dim(pd, tp_size), defs)


def local_defs(defs, tp_size: int):
    """The PDs of one rank's TP shards: each TP dim divided by `tp_size`."""
    def local(pd: PD) -> PD:
        d = tp_dim(pd, tp_size)
        if d is None:
            return pd
        shape = list(pd.shape)
        shape[d] //= tp_size
        return replace(pd, shape=tuple(shape))
    return tree_map(local, defs)


def leaf_bytes_pd(pd: PD) -> int:
    return int(np.prod(pd.shape)) * torch_dtype(pd.dtype).itemsize
