"""Dispatch around the kernels, with the JAX package's signatures and errors.

``impl`` picks the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor, the plain version
  for a CPU tensor (the kernel wrappers decide by the tensor's device);
* ``"cuda"``: the CUDA kernel; a CPU tensor raises;
* ``"plain"``: the plain PyTorch version on any device (tests, and the
  kernel-against-plain checks on the card).

Nothing here falls back from a kernel to the plain version.
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
    if _resolve(impl, q, "flash_attention") == "plain":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale)
    return _fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    scale=scale)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    """x: (..., d); w: (d,)."""
    if _resolve(impl, x, "rmsnorm") == "plain":
        return _ref.rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    y = _rn.rmsnorm_rows(x.reshape(-1, d), w, eps=eps)
    return y.reshape(x.shape)


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
            "rmsnorm": _rn.rmsnorm_rows.launches,
            "quant_int8": _q.quant_int8_2d.launches,
            "dequant_int8": _q.dequant_int8_2d.launches}


def reset_launch_counts() -> None:
    _fa.flash_attention_bshd.launches = 0
    _rn.rmsnorm_rows.launches = 0
    _q.quant_int8_2d.launches = 0
    _q.dequant_int8_2d.launches = 0
