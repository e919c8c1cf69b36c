"""Shared neural-net layers, forward only: norm, RoPE, attention (prefill and
cached decode), SwiGLU MLP.

Conventions, as in the JAX package:
  * activations are (B, S, ...);
  * attention params: wq (d, n_q), wk/wv (d, n_kv), wo (n_q, d), optional
    bq/bk/bv; n_q = H*Dh and n_kv = KH*Dh are the fused head dims.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, w, eps=eps)


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
              positions=None) -> torch.Tensor:
    """Full-sequence self-attention (prefill).  Cross-attention (the
    JAX package's ``kv_x``) belongs to the encoder-decoder family, which is
    not ported yet."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, dims, positions)
    o = ops.flash_attention(q, k, v, causal=dims.causal, window=dims.window)
    return o.reshape(B, S, -1) @ p["wo"]


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
