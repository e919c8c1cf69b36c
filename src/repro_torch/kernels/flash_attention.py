"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its wrapper.

Replaces ``_flash_kernel`` in src/repro/kernels/flash_attention.py (causal
and sliding-window masks, queries aligned to the end of the keys, GQA by
indexing).  The TPU wrapper takes (B*H, Sq, D) after a transpose; this one
takes the (B, S, H, D) layout the model produces and hands the kernel its
strides, so nothing is transposed or copied.  Bound on an H100 at the
prefill shapes by operations; both products run on the tensor cores
(``wgmma``), see the source's note.  On CPU tensors the wrapper runs the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (32, 64, 128)      # head dims the kernel is compiled for
_MAX_Q_TILES = 65535           # grid y: query tiles of 64 rows


@functools.cache
def _fn():
    f = build.load("flash_attention").flash_fwd_bf16
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_int64] * 12
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Unit stride on D and 16-byte aligned rows, as the kernel loads them."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention_bshd: tensor at {t.data_ptr():#x} "
                         f"is not 16-byte aligned")
    return t


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 -> (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if H % KH or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_bshd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not form "
                         f"(B,Sq,H,D) / (B,Sk,KH,D) with H a multiple of KH")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_bshd: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must be on one "
                         f"CUDA device (or on the CPU)")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention_bshd: the kernel takes bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bshd: head dim {D} not in {HEAD_DIMS}")
    if -(-Sq // 64) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention_bshd: Sq = {Sq} exceeds "
                         f"{64 * _MAX_Q_TILES} query rows")
    q, k, v = _ready(q), _ready(k), _ready(v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    win = -1 if window is None else int(window)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, H, KH, Sq, Sk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], float(scale), int(causal), win,
                build.stream_handle(q))
    build.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    return o


flash_attention_bshd.launches = 0
