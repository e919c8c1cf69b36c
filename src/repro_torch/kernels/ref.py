"""Plain PyTorch versions of the four kernels.

Naive, materializing, obviously right: they are what a kernel's wrapper runs
for a tensor on the CPU, and what the kernels are held to on the card.  Each
repeats the arithmetic of the JAX package's oracle (src/repro/kernels/ref.py)
with one deliberate difference: a query row with no valid key gives 0 in
:func:`flash_attention_ref` (the JAX oracle gives NaN there, the Pallas kernel
the mean of V, the JAX package's CPU path 0).
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive attention. q: (B,Sq,H,D); k,v: (B,Sk,KH,D) with H % KH == 0.

    Queries align to the end of the keys (position i of q is key position
    i + Sk - Sq).  `window`: queries attend to the last `window` keys,
    inclusive of self."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    g = H // KH
    if scale is None:
        scale = D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KH, g, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())     # (B,KH,g,Sq,Sk)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                                      # masked -> 0
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def quant_int8_ref(x: torch.Tensor, block: int = 256):
    """Blockwise absmax int8 quantization along the last dim.

    Returns (q: int8 same shape, scales: float32 shape[..., n/block])."""
    *lead, n = x.shape
    if n % block:
        raise ValueError(f"quant_int8_ref: last dim {n} must be a multiple "
                         f"of block {block}")
    xb = x.float().reshape(*lead, n // block, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    # a full tensor, not the scalar 127.0: PyTorch's CUDA division by a
    # scalar multiplies by its reciprocal, which is not IEEE division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(*lead, n), scale.squeeze(-1)


def dequant_int8_ref(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
                     dtype=torch.float32) -> torch.Tensor:
    *lead, n = q.shape
    qb = q.float().reshape(*lead, n // block, block)
    x = qb * scales[..., None]
    return x.reshape(*lead, n).to(dtype)
