"""Dispatch around the kernels, with the JAX package's signatures and errors.

``impl`` picks the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor, the plain version
  for a CPU tensor (the kernel wrappers decide by the tensor's device);
* ``"cuda"``: the CUDA kernel; a CPU tensor raises;
* ``"plain"``: the plain PyTorch version on any device (tests, and the
  kernel-against-plain checks on the card).

Nothing here falls back from a kernel to the plain version.

Gradients.  :func:`flash_attention` and :func:`rmsnorm` are differentiable.
Attention on CUDA tensors that need a gradient goes through
:class:`FlashAttentionFn`: its forward runs the forward kernel and keeps each
row's log-sum-exp, its backward runs the backward kernel; on CPU tensors (and
with ``impl="plain"``) autograd differentiates the plain version.  rmsnorm
always goes through :class:`RMSNormFn`, the port of the JAX package's
``custom_vjp`` (``src/repro/models/layers.py`` ``rms_norm``): the forward is
the kernel (or the plain version on the CPU), the backward is
:func:`rmsnorm_bwd`, plain torch as in the JAX package, dx in x's dtype and
dw in w's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant as _q
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn

IMPLS = ("auto", "cuda", "plain")


def _resolve(impl: str, t: torch.Tensor, what: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"{what}: impl='cuda' needs CUDA tensors, got a "
                         f"tensor on {t.device}")
    return impl


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class FlashAttentionFn(torch.autograd.Function):
    """Attention on the CUDA kernels, forward and backward.  A recompute
    (activation checkpointing) runs the forward again and saves its own
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                          scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = _fa.flash_attention_bwd_bshd(
            q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Batched multi-head attention. q: (B,Sq,H,D); k,v: (B,Sk,KH,D)."""
    H, KH = q.shape[2], k.shape[2]
    if H % KH:
        raise ValueError(f"attention: q heads {H} must be a multiple of "
                         f"kv heads {KH} (GQA group size)")
    if _resolve(impl, q, "flash_attention") == "plain" or q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    scale=scale)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_rms_bwd``: (dx in x's dtype, dw in w's dtype),
    computed in f32."""
    xf, gf, wf = x.float(), g.float(), w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gw = gf * wf
    dx = (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True)) * r
    dw = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dw.to(w.dtype)


def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float,
                 impl: str) -> torch.Tensor:
    if impl == "plain":
        return _ref.rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    y = _rn.rmsnorm_rows(x.reshape(-1, d), w, eps=eps)
    return y.reshape(x.shape)


class RMSNormFn(torch.autograd.Function):
    """rmsnorm with the JAX package's hand-written backward."""

    @staticmethod
    def forward(ctx, x, w, eps, impl):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g, ctx.eps)
        return dx, dw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    """x: (..., d); w: (d,)."""
    impl = _resolve(impl, x, "rmsnorm")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps, impl)
    return _rmsnorm_fwd(x, w, eps, impl)


# ---------------------------------------------------------------------------
# int8 blockwise quantization (wire codec)
# ---------------------------------------------------------------------------

def quant_int8(x: torch.Tensor, *, block: int = 256, impl: str = "auto"):
    """x: (..., n) with n % block == 0 -> (int8, f32 scales (..., n/block)).

    Raises ValueError (not a bare assert) on a ragged trailing dim: callers
    must pad to the block size first (kvship._encode_decode does)."""
    n_last = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or n_last % block != 0:
        raise ValueError(
            f"quant_int8: leaf of shape {tuple(x.shape)} has trailing dim "
            f"{n_last}, not divisible by block={block}; pad the trailing "
            f"dim to a multiple of the quantization block (see "
            f"repro_torch.core.kvship._encode_decode)")
    if _resolve(impl, x, "quant_int8") == "plain":
        return _ref.quant_int8_ref(x, block)
    lead = x.shape[:-1]
    q, s = _q.quant_int8_2d(x.reshape(-1, n_last), block=block)
    return q.reshape(*lead, n_last), s.reshape(*lead, n_last // block)


def dequant_int8(q: torch.Tensor, s: torch.Tensor, *, block: int = 256,
                 dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    if _resolve(impl, q, "dequant_int8") == "plain":
        return _ref.dequant_int8_ref(q, s, block, dtype)
    lead = q.shape[:-1]
    n = q.shape[-1]
    x = _q.dequant_int8_2d(q.reshape(-1, n), s.reshape(-1, n // block),
                           block=block, dtype=dtype)
    return x.reshape(*lead, n)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since the counts were last reset."""
    return {"flash_attention": _fa.flash_attention_bshd.launches,
            "flash_attention_bwd": _fa.flash_attention_bwd_bshd.launches,
            "rmsnorm": _rn.rmsnorm_rows.launches,
            "quant_int8": _q.quant_int8_2d.launches,
            "dequant_int8": _q.dequant_int8_2d.launches}


def reset_launch_counts() -> None:
    _fa.flash_attention_bshd.launches = 0
    _fa.flash_attention_bwd_bshd.launches = 0
    _rn.rmsnorm_rows.launches = 0
    _q.quant_int8_2d.launches = 0
    _q.dequant_int8_2d.launches = 0
