"""Functional AdamW with global-norm clipping: the port of the JAX package's
``optim/adamw.py``.

The update keeps the reference's order of operations and roundings: bias
correction by division, the weight decay inside ``delta``, the parameter
updated in f32 and rounded to its own dtype (``torch.optim.AdamW``'s
decoupled decay is another sequence of roundings, and is not used).  State
is a plain tree: ``{"m", "v"}`` in f32 shaped like the parameters, and
``step`` a 0-d int32 tensor.  Under ZeRO the gradients, parameters and
moments are shards over the data axis: the global norm sums the scattered
leaves' squares over the data-parallel group and the replicated ones
locally, as the reference does.  The bucketed update (``buckets=``,
ROADMAP.md queue A, 'bucketed overlap and flush_hook') is queued.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.collectives import psum_group, queued
from repro_torch.core.tree import flatten, tree_map, unflatten


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = flatten(params)[0][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads, dims=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  `dims` (a tree
    beside `grads`, or a flat list) marks the scattered leaves (a dim) and
    the replicated ones (None); `group` is the data-parallel group the
    scattered leaves' sum is taken over (rank order), as the reference's
    psum over ``data_axes``.  Each part is summed in leaf order.

    Under the reference's ZeRO the data-parallel axes are ("pod", "data"):
    after the cross-pod sync every pod holds the same shard, so each
    scattered leaf is counted once per pod (ROADMAP.md §C 6); the port
    computes the same number."""
    leaves = flatten(grads)[0]
    if dims is None:
        dim_list = [None] * len(leaves)
    else:
        dim_list = dims if isinstance(dims, list) else flatten(dims)[0]
    dev = leaves[0].device
    scat = torch.zeros((), dtype=torch.float32, device=dev)
    repl = torch.zeros((), dtype=torch.float32, device=dev)
    for g, d in zip(leaves, dim_list):
        s = torch.sum(torch.square(g.float()))
        if d is not None and group is not None:
            scat = scat + s
        else:
            repl = repl + s
    if group is not None:
        scat = psum_group(scat, group)
    return torch.sqrt(scat + repl)


def adamw_update(grads, opt_state: dict, params, tc: TrainConfig,
                 lr: torch.Tensor, *, dims=None, group=None, buckets=None):
    """One AdamW step.  Returns (new_params, new_opt_state, stats).  `dims`
    and `group` go to :func:`global_norm` (ZeRO: the shards' dims and the
    data-parallel group)."""
    if buckets is not None:
        raise queued("the bucketed AdamW update", "bucketed overlap and flush_hook")
    step = opt_state["step"] + 1
    norm = global_norm(grads, dims, group)
    if tc.grad_clip:
        scale = torch.clamp(tc.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=norm.device)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(sf, b1), sf)
    c2 = 1.0 - torch.pow(torch.full_like(sf, b2), sf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + tc.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    lp, td = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        lp, flatten(grads)[0], flatten(opt_state["m"])[0],
        flatten(opt_state["v"])[0])]
    return (unflatten(td, [o[0] for o in out]),
            {"m": unflatten(td, [o[1] for o in out]),
             "v": unflatten(td, [o[2] for o in out]), "step": step},
            {"grad_norm": norm})
