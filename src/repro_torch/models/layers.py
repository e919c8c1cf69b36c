"""Shared neural-net layers: norm, RoPE and sinusoidal positions, attention
(train / prefill, cross-attention, and cached decode), SwiGLU MLP, chunked
cross-entropy.

Conventions, as in the JAX package:
  * activations are (B, S, ...);
  * attention params: wq (d, n_q), wk/wv (d, n_kv), wo (n_q, d), optional
    bq/bk/bv; n_q = H*Dh and n_kv = KH*Dh are the fused head dims.

Tensor parallelism (:class:`TensorParallel`, a mesh's model axis) is
Megatron's: attention and the SwiGLU MLP run on a rank's heads and ff
columns with the layer functions here unchanged (the caller passes the
rank's head counts and shards, and wraps the input in ``tp_copy`` and the
output in ``tp_reduce``); the embedding and the cross-entropy are
vocab-parallel (:func:`embed_lookup`, :func:`chunked_ce_loss` with `tp`).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import tp_copy, tp_max, tp_reduce
from repro_torch.kernels import ops


@dataclass(frozen=True)
class TensorParallel:
    """One rank's model axis: its process group, the group's size and the
    rank's index in it (block `index` of every TP-sharded leaf)."""
    group: object
    size: int
    index: int

    @staticmethod
    def of(mesh) -> Optional["TensorParallel"]:
        """The model axis of `mesh`, or None with one model rank."""
        if mesh is None or mesh.model == 1:
            return None
        return TensorParallel(mesh.model_group, mesh.model, mesh.model_index)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """The rows of `embed` at `tokens`.  With `tp` the table is this rank's
    vocab block: each rank looks up the tokens in its block, zeros
    elsewhere, and the model group sums them (every token's row from the
    one rank that holds it, so the sum is exact)."""
    if tp is None:
        return embed[tokens]
    Vl = embed.shape[0]
    local = tokens - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    rows = embed[local.clamp(0, Vl - 1)]
    return tp_reduce(torch.where(inside[..., None], rows, torch.zeros_like(rows)),
                     tp.group)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Differentiable through :class:`repro_torch.kernels.ops.RMSNormFn`: the
    JAX package's ``custom_vjp``, dx in x's dtype, dw in w's."""
    return ops.rmsnorm(x, w, eps=eps)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (whisper-style), f32 (S, d) of the (S,)
    `positions`: sines of the first d/2 frequencies, then their cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: a scalar, (S,) absolute positions, or
    (B, S) per-sequence positions (continuous batching: each slot sits at its
    own depth)."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device)
    if pos.dim() == 0:
        pos = pos.reshape(1)
    ang = pos.to(torch.float32)[..., None] * freqs          # (S|B,S, half)
    if ang.dim() == 2:
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < D:  # odd head dims (not used by the configured archs)
        rot = torch.cat([rot, xf[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


class AttnDims(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float
    window: Optional[int]
    causal: bool = True


def _project_qkv(p: dict, x: torch.Tensor, dims: AttnDims, positions):
    B, S, _ = x.shape
    H, KH, Dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KH, Dh)
    v = v.reshape(B, S, KH, Dh)
    if dims.rope_theta and positions is not None:
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def attention(p: dict, x: torch.Tensor, dims: AttnDims, *,
              positions=None, kv_x: Optional[torch.Tensor] = None,
              kv_positions=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  Cross-attention when
    `kv_x` (B, Skv, d) is given (whisper's decoder): k/v projected from
    `kv_x` without bias, RoPE only where ``dims.rope_theta`` is set, and no
    causal mask or window."""
    B, S, _ = x.shape
    H, KH, Dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    if kv_x is None:
        q, k, v = _project_qkv(p, x, dims, positions)
        causal, window = dims.causal, dims.window
    else:
        Skv = kv_x.shape[1]
        q = (x @ p["wq"]).reshape(B, S, H, Dh)
        k = (kv_x @ p["wk"]).reshape(B, Skv, KH, Dh)
        v = (kv_x @ p["wv"]).reshape(B, Skv, KH, Dh)
        if dims.rope_theta and positions is not None:
            q = apply_rope(q, positions, dims.rope_theta)
            if kv_positions is not None:
                k = apply_rope(k, kv_positions, dims.rope_theta)
        causal, window = False, None
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return o.reshape(B, S, H * Dh) @ p["wo"]


def decode_attention(p: dict, x: torch.Tensor, dims: AttnDims, *,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos, ring: bool = False):
    """One-token attention against a cache.

    x: (B, 1, d); k_cache/v_cache: (B, W, KH, Dh).  `pos` is the number of
    tokens already in the cache (the new token's absolute position): an int
    or 0-d tensor when every row sits at the same depth, or a (B,) tensor
    when the continuous batcher has each slot at its own depth.  When `ring`
    (sliding window), the cache is a ring buffer of width W and keys were
    rope'd at insertion; otherwise W == max_len and slot i == position i.

    The new token's k/v are written into the caches IN PLACE (the JAX
    package returns updated copies and donates the old buffers).  Returns
    (attn_out (B,1,n_q @ wo), k_cache, v_cache).  No kernel: plain torch ops,
    as the JAX package has no Pallas kernel here either.
    """
    B = x.shape[0]
    H, KH, Dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    W = k_cache.shape[1]
    g = H // KH
    dev = x.device
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, 1, H, Dh)
    k = k.reshape(B, 1, KH, Dh)
    v = v.reshape(B, 1, KH, Dh)
    pos_t = torch.as_tensor(pos, device=dev)
    vec = pos_t.dim() >= 1       # per-sequence positions (B,)
    if dims.rope_theta:
        ppos = pos_t.to(torch.int32).reshape(B, 1) if vec else pos_t.reshape(1)
        q = apply_rope(q, ppos, dims.rope_theta)
        k = apply_rope(k, ppos, dims.rope_theta)
    rows = torch.arange(B, device=dev)
    slot = torch.remainder(pos_t, W) if ring else torch.clamp(pos_t, max=W - 1)
    slot = slot.expand(B)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)

    qf = (q.float() * Dh ** -0.5).reshape(B, 1, KH, g, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float())   # (B,KH,g,1,W)
    idx = torch.arange(W, device=dev)
    pb = pos_t.reshape(-1, 1)                                    # (B|1, 1)
    if ring:
        # slot j holds absolute position pos - ((pos - j) mod W); valid iff >= 0
        valid = (pb - torch.remainder(pb - idx[None, :], W)) >= 0
    else:
        valid = idx[None, :] <= pb
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    p_attn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p_attn, v_cache.float())
    o = o.reshape(B, 1, H * Dh).to(x.dtype)
    return o @ p["wo"], k_cache, v_cache


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]


def _chunk_loss(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # the matmul stays in the activations' dtype and the upcast comes after
    # it, so the head's cotangent and its sum over chunks stay bf16, as in
    # the JAX package (its f32 (d, V) gradient was gigabytes)
    logits = (xc @ head).float()                       # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    # gathering the gold logit is the JAX package's one-hot contraction
    gold = logits.gather(-1, lc[..., None]).squeeze(-1)
    mf = mc.float()
    return ((lse - gold) * mf).sum(), mf.sum()


def _chunk_loss_tp(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                   mc: torch.Tensor, tp: TensorParallel):
    # vocab-parallel: `head` is this rank's (d, V/tp) block.  The max and the
    # sum of exponentials come from every rank's block, and the gold logit
    # from the one rank that holds it: two scalars a token cross the group,
    # as the JAX package's masked one-hot sum costs under GSPMD
    logits = (tp_copy(xc, tp.group) @ head).float()        # (B, chunk, V/tp)
    Vl = logits.shape[-1]
    m = tp_max(logits.amax(dim=-1), tp.group)
    se = tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), tp.group)
    lse = m + torch.log(se)
    local = lc - tp.index * Vl
    inside = (local >= 0) & (local < Vl)
    gold = logits.gather(-1, local.clamp(0, Vl - 1)[..., None]).squeeze(-1)
    gold = tp_reduce(torch.where(inside, gold, torch.zeros_like(gold)), tp.group)
    mf = mc.float()
    return ((lse - gold) * mf).sum(), mf.sum()


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, *,
                    mask: Optional[torch.Tensor] = None,
                    chunk: Optional[int] = None,
                    tp: Optional[TensorParallel] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing the full (B, S, V) logits.

    Walks the sequence in chunks; each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``), bounding live logits to (B, chunk, V).  Returns
    (sum_loss, sum_count) in f32, summed over the chunks in order; the
    caller normalizes.  With `tp`, `head` is this rank's vocab block and
    the loss is vocab-parallel; every model rank gets the same sums."""
    B, S, d = x.shape
    if chunk is None:
        chunk = int(os.environ.get("REPRO_CE_CHUNK", "512"))  # memory knob
    chunk = min(chunk, S)
    m = mask if mask is not None else torch.ones((B, S), dtype=torch.bool,
                                                 device=x.device)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        m = F.pad(m, (0, pad))
    sum_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        if tp is None:
            l, c = checkpoint(_chunk_loss, x[:, sl], head, labels[:, sl], m[:, sl],
                              use_reentrant=False)
        else:
            l, c = checkpoint(_chunk_loss_tp, x[:, sl], head, labels[:, sl],
                              m[:, sl], tp, use_reentrant=False)
        sum_loss = sum_loss + l
        count = count + c
    return sum_loss, count
