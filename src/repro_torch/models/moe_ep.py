"""Expert-parallel MoE over the model axis: the JAX package's ``moe_ep.py``
with its shard_map written out as collectives over the model group.

Per rank, as the reference's body runs on each device:

  take the rank's S/tp slice of every row of x -> route those tokens with a
  *local* capacity -> (E, C, d) buffers regrouped (tp, E/tp, C, d) ->
  all-to-all (each token row travels to its expert's rank) -> the rank's
  E/tp experts, dense -> all-to-all back -> weighted combine -> the slices
  gathered back to the whole sequence.

The capacity is the rank's, ``round(cf * k * T_local / E)``, so the layer's
numbers differ from the unsharded layer's where a rank's tokens overflow it:
the reference's do too, and the port reproduces them.  The aux loss is the
mean of the ranks' aux losses.  Gradients are the reference's: the slice of
x gathers its cotangent from every rank, the router (whole on every rank,
used on the rank's tokens) has its gradient summed over the model group,
and each rank's aux loss receives 1/tp of the mean's cotangent.

Link bytes per rank per layer: 2 * k * cf * T_local * d through the two
all-to-alls.  The all-to-alls cross through host copies over the gloo model
group (``core/collectives.py``), as every group of the port does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.collectives import (tp_all_to_all, tp_copy, tp_gather,
                                          tp_reduce, tp_split)
from repro_torch.models import moe as moe_lib


def ep_applicable(E: int, S: int, tp: int) -> bool:
    """Whether the shapes tile a model axis of `tp` ranks."""
    return tp > 1 and E % tp == 0 and S % tp == 0


def moe_ffn_ep(p: dict, x: torch.Tensor, cfg: MoEConfig,
               tp) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d), whole on every model rank, S divisible by ``tp.size``;
    gate/up/down this rank's (E/tp, d, f), (E/tp, d, f), (E/tp, f, d)
    experts.  Returns (y (B, S, d) whole on every rank, aux)."""
    E, k = cfg.num_experts, cfg.top_k
    n, group = tp.size, tp.group
    xs = tp_split(x, 1, group)                      # (B, S/n, d)
    router = tp_copy(p["router"], group)            # its gradient summed
    B, Sl, d = xs.shape
    T = B * Sl
    xt = xs.reshape(T, d)
    logits = (xt @ router).float()                  # (T, E)
    probs, gates, ids = moe_lib.route(logits, k)

    density = torch.mean(F.one_hot(ids[:, 0], E).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * E
    aux = tp_reduce(aux.reshape(1), group).reshape(()) / n      # pmean

    # local capacity per destination expert: C token rows
    C = moe_lib.capacity(cfg, T)
    flat_ids = ids.reshape(T * k)
    pos, keep = moe_lib.slots(ids, E, C)
    gates = gates * keep.reshape(T, k)
    safe_pos = torch.where(keep, pos, C - 1)
    send = moe_lib.dispatch(xt, flat_ids, pos, keep, E, C)

    # the rows travel to their expert's rank: (E, C, d) as (n, E/n, C, d)
    El = E // n
    recv = tp_all_to_all(send.reshape(n, El, C, d), group)
    # recv: (n sources, E/n, C, d), the rows bound for this rank's experts
    gate = p["gate"]
    h_in = recv.movedim(1, 0).reshape(El, n * C, d).to(gate.dtype)
    out = moe_lib.experts(p, h_in)                  # (E/n, n*C, d)
    out = out.reshape(El, n, C, d).movedim(1, 0).contiguous()
    back = tp_all_to_all(out, group).reshape(E, C, d)   # the send layout again

    picked = back[flat_ids, safe_pos]
    picked = picked * gates.reshape(T * k)[:, None].to(picked.dtype)
    y = torch.sum(picked.reshape(T, k, d), dim=1)
    return tp_gather(y.reshape(B, Sl, d), 1, group), aux
