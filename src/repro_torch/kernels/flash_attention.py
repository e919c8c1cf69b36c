"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), and their wrappers.

Replaces ``_flash_kernel`` in src/repro/kernels/flash_attention.py (causal
and sliding-window masks, queries aligned to the end of the keys, GQA by
indexing).  The TPU wrapper takes (B*H, Sq, D) after a transpose; this one
takes the (B, S, H, D) layout the model produces and hands the kernel its
strides, so nothing is transposed or copied.  Bound on an H100 at the
prefill shapes by operations; both products run on the tensor cores
(``wgmma``), see the source's note.  On CPU tensors the wrapper runs the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.

The forward can also return each row's log-sum-exp (exp2 domain, (B, H, Sq)
f32), which the backward recomputes P from.  The backward has no TPU
counterpart (the JAX package differentiates its blocked jnp attention): it
is FlashAttention-2's dK/dV and dQ passes, held to autograd through the
plain version.  Head dim 120 runs the 128-wide tiles with zero columns.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (32, 64, 120, 128)   # head dims the kernels are compiled for
BWD_PARTS = ("delta", "dkdv", "dq")   # the backward's kernels, in launch order
_MAX_Q_TILES = 65535           # grid y: query tiles of 64 rows


@functools.cache
def _fn():
    f = build.load("flash_attention").flash_fwd_bf16
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                  + [ctypes.c_int64] * 12
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.cache
def _bwd_fn():
    f = build.load("flash_attention_bwd").flash_bwd_bf16
    f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def bwd_resources(head_dim: int) -> dict:
    """Registers per thread and shared memory per block (bytes) of the
    backward's delta, dK/dV and dQ kernels at `head_dim`, as the card's
    runtime reports them (CUDA only)."""
    f = build.load("flash_attention_bwd").flash_bwd_resources
    f.argtypes = [ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    build.check(f(int(head_dim), ctypes.cast(out, ctypes.c_void_p)), "bwd_resources")
    return {name: {"registers": out[2 * i], "smem_bytes": out[2 * i + 1]}
            for i, name in enumerate(BWD_PARTS)}


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Unit stride on D and 16-byte aligned rows, as the kernel loads them."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention_bshd: tensor at {t.data_ptr():#x} "
                         f"is not 16-byte aligned")
    return t


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
    B, Sq, H, D = q.shape
    ts = (q, k, v, *more)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}; "
                         f"all must be on one CUDA device (or on the CPU)")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what}: the kernel takes bfloat16, got "
                        f"{[str(t.dtype) for t in ts]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if -(-Sq // 64) > _MAX_Q_TILES:
        raise ValueError(f"{what}: Sq = {Sq} exceeds {64 * _MAX_Q_TILES} "
                         f"query rows")


def _shapes(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if H % KH or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not form (B,Sq,H,D) / "
                         f"(B,Sk,KH,D) with H a multiple of KH")
    return B, Sq, H, D, Sk, KH


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 -> (B, Sq, H, D).

    With `return_lse` (CUDA tensors only) returns ``(o, lse)``: lse is
    (B, H, Sq) f32, each row's log2-sum-exp2 of its scaled logits, +inf for
    a row with no valid key; :func:`flash_attention_bwd_bshd` takes it."""
    B, Sq, H, D, Sk, KH = _shapes("flash_attention_bshd", q, k, v)
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        if return_lse:
            raise ValueError("flash_attention_bshd: return_lse is for the CUDA "
                             "kernel; on the CPU the plain version is "
                             "differentiated by autograd")
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale)
    _check("flash_attention_bshd", q, k, v)
    q, k, v = _ready(q), _ready(k), _ready(v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    win = -1 if window is None else int(window)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, H, KH, Sq, Sk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], float(scale), int(causal), win,
                build.stream_handle(q))
    build.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor,
                             do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Gradients of :func:`flash_attention_bshd`: q, k, v and o (its output)
    as the forward saw and gave them, lse from ``return_lse=True``, do the
    gradient of o (any strides with unit stride on D) -> (dq, dk, dv) in
    bf16, shaped like q, k and v.  CUDA tensors only: on the CPU autograd
    differentiates the plain version."""
    B, Sq, H, D, Sk, KH = _shapes("flash_attention_bwd_bshd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd_bshd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} must be {tuple(q.shape)} and lse "
                         f"{tuple(lse.shape)} must be {(B, H, Sq)}")
    if scale is None:
        scale = D ** -0.5
    _check("flash_attention_bwd_bshd", q, k, v, o, do)
    if lse.device != q.device or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd_bshd: lse must be float32 on "
                        f"{q.device}, got {lse.dtype} on {lse.device}")
    q, k, v, o, do = (_ready(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    win = -1 if window is None else int(window)
    err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    B, H, KH, Sq, Sk, D, ctypes.cast(strides, ctypes.c_void_p),
                    float(scale), int(causal), win, build.stream_handle(q))
    build.check(err, "flash_attention_bwd_bshd")
    flash_attention_bwd_bshd.launches += 1
    return dq, dk, dv


flash_attention_bshd.launches = 0
flash_attention_bwd_bshd.launches = 0
