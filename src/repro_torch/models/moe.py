"""Top-k MoE layer with scatter-based dispatch (the JAX package's
``moe_ffn`` scatter path).

Tokens are routed to per-expert capacity buffers, the experts run as one
batched product over the expert dim, and the outputs are gathered back and
combined with the renormalised gates.  The expert-parallel all-to-all of the
JAX package (``moe_ep.py``, taken when the tensor-parallel axis has more than
one device) waits for tensor parallelism: the port's mesh refuses ``model >
1`` (:func:`repro_torch.launch.mesh.make_local_mesh`), so this path is the
only one.

Two places differ in form from the JAX package and not in result:

* top-k takes a stable descending sort, so that tied probabilities pick the
  lower expert index first, as ``jax.lax.top_k`` does (``torch.topk`` makes
  no such promise on the card);
* dispatch writes each kept ``(expert, slot)`` row with an indexed store:
  the kept pairs are unique, and the reference's scatter-add adds only zeros
  (the dropped rows, parked at slot C-1) besides them, so the buffer is the
  same without an accumulate whose order on the card is not fixed.  The
  dropped rows are parked in a spare slot C that the experts never see, so
  no kept row shares an index with them and the host never waits for a
  count of the kept ones.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def capacity(cfg: MoEConfig, T: int) -> int:
    """Slots per expert for T tokens, with Python's round as the reference."""
    return int(max(1, round(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts)))


def route(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """(probs (T, E), gates (T, k) renormalised, ids (T, k)) of f32 router
    logits; ties go to the lower expert index."""
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k]
    return probs, gates / gates.sum(dim=-1, keepdim=True), ids[:, :k]


def slots(ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep), each (T*k,): the slot of each (token, choice) in its
    expert's buffer, the exclusive running count of prior assignments to the
    same expert in (token-major, choice-minor) order, and whether it is under
    the capacity C (the rest are dropped)."""
    flat_ids = ids.reshape(-1)
    onehot = F.one_hot(flat_ids, E).to(torch.int32)      # (T*k, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot        # exclusive
    pos = torch.gather(pos_all, 1, flat_ids[:, None])[:, 0]
    return pos, pos < C


def moe_ffn(p: dict, x: torch.Tensor,
            cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32).

    params: router (d, E), gate/up (E, d, f), down (E, f, d)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)

    logits = (xt @ p["router"]).float()                   # (T, E)
    probs, gates, ids = route(logits, k)

    # load-balancing aux loss (Switch-style)
    density = torch.mean(F.one_hot(ids[:, 0], E).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * E

    C = capacity(cfg, T)
    flat_ids = ids.reshape(T * k)
    pos, keep = slots(ids, E, C)
    gates = gates * keep.reshape(T, k)

    # dispatch: each kept (expert, slot) gets its token's row
    safe_pos = torch.where(keep, pos, C - 1)
    buf = torch.zeros((E, C + 1, d), dtype=xt.dtype, device=x.device)
    buf[flat_ids, torch.where(keep, pos, C)] = xt.repeat_interleave(k, dim=0)
    buf = buf[:, :C]

    # expert FFN, batched over E
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out = torch.bmm(h, p["down"])                         # (E, C, d)

    # combine: gather each token's k expert outputs, weight by gates
    picked = out[flat_ids, safe_pos]                      # (T*k, d)
    picked = picked * gates.reshape(T * k)[:, None].to(picked.dtype)
    y = torch.sum(picked.reshape(T, k, d), dim=1)
    return y.reshape(B, S, d), aux
