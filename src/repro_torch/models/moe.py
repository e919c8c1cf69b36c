"""Top-k MoE layer with scatter-based dispatch (the JAX package's
``moe_ffn`` scatter path).

Tokens are routed to per-expert capacity buffers, the experts run as one
batched product over the expert dim, and the outputs are gathered back and
combined with the renormalised gates.

Over a model axis (`tp`) the experts are sharded E/tp a rank.  Where the
shapes tile the axis (:func:`repro_torch.models.moe_ep.ep_applicable`) the
layer is the expert-parallel all-to-all of ``moe_ep.py``, as the JAX
package's ``moe_ffn`` dispatches to it; elsewhere (decode, a sequence that
does not split) it is this scatter path over every token with each rank
running its experts and the (E, C, d) expert outputs gathered over the
model group before the combine, so that its numbers are the unsharded
layer's (the JAX package's GSPMD fallback).

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
from repro_torch.core.collectives import tp_copy, tp_gather


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


def dispatch(xt: torch.Tensor, flat_ids: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The (E, C, d) capacity buffer: each kept (token, choice) row of
    `xt` (T, d) at its (expert, slot); dropped ones go to a spare slot C
    that is cut off."""
    k = flat_ids.numel() // xt.shape[0]
    buf = torch.zeros((E, C + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf[flat_ids, torch.where(keep, pos, C)] = xt.repeat_interleave(k, dim=0)
    return buf[:, :C]


def experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their rows (E, C, d), batched over E."""
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    return torch.bmm(h, p["down"])


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig,
            tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32).

    params: router (d, E), gate/up (E, d, f), down (E, f, d); with `tp` (a
    ``layers.TensorParallel``) gate/up/down are this rank's E/tp experts
    when E divides over the model ranks (else whole, and the layer runs as
    on one rank)."""
    from repro_torch.models import moe_ep
    B, S, d = x.shape
    E = cfg.num_experts
    if tp is not None and E % tp.size == 0:
        if moe_ep.ep_applicable(E, S, tp.size):
            return moe_ep.moe_ffn_ep(p, x, cfg, tp)
        return _moe_ffn(p, x, cfg, tp)
    return _moe_ffn(p, x, cfg, None)


def _moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, tp):
    """The scatter path; with `tp` each rank runs its experts' rows of the
    buffer and the outputs are gathered over the model group."""
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
    buf = dispatch(xt if tp is None else tp_copy(xt, tp.group), flat_ids,
                   pos, keep, E, C)

    # expert FFN, batched over E (over this rank's experts with `tp`)
    if tp is not None:
        El = E // tp.size
        buf = buf[tp.index * El:(tp.index + 1) * El]
    out = experts(p, buf)                                 # (E, C, d)
    if tp is not None:
        out = tp_gather(out, 0, tp.group)

    # combine: gather each token's k expert outputs, weight by gates
    picked = out[flat_ids, safe_pos]                      # (T*k, d)
    picked = picked * gates.reshape(T * k)[:, None].to(picked.dtype)
    y = torch.sum(picked.reshape(T, k, d), dim=1)
    return y.reshape(B, S, d), aux
