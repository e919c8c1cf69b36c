"""Functional AdamW with global-norm clipping: the port of the JAX package's
``optim/adamw.py``.

The update keeps the reference's order of operations and roundings: bias
correction by division, the weight decay inside ``delta``, the parameter
updated in f32 and rounded to its own dtype (``torch.optim.AdamW``'s
decoupled decay is another sequence of roundings, and is not used).  State
is a plain tree: ``{"m", "v"}`` in f32 shaped like the parameters, and
``step`` a 0-d int32 tensor.  With one data rank per pod every gradient is
replicated, so the global norm needs no collective; ZeRO-scattered leaves
(ROADMAP.md queue A, 'data > 1 with ZeRO and reduce-scatter') and the
bucketed update (``buckets=``, 'bucketed overlap and flush_hook') are
queued.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.collectives import queued
from repro_torch.core.tree import flatten, tree_map, unflatten


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = flatten(params)[0][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in leaf order in f32."""
    leaves = flatten(grads)[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def adamw_update(grads, opt_state: dict, params, tc: TrainConfig,
                 lr: torch.Tensor, *, buckets=None):
    """One AdamW step.  Returns (new_params, new_opt_state, stats)."""
    if buckets is not None:
        raise queued("the bucketed AdamW update", "bucketed overlap and flush_hook")
    step = opt_state["step"] + 1
    norm = global_norm(grads)
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
