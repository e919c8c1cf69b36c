"""Blockwise int8 quant/dequant: the CUDA kernels ``csrc/quant.cu`` and their
wrappers.

Replace ``_quant_kernel`` and ``_dequant_kernel`` in
src/repro/kernels/quant.py: the int8 wire codec of KV shipping (and, once
ported, of compressed gradient sync).  Both are bound on an H100 by bytes.
quant takes f32 or bf16 and casts in registers, as the TPU kernel casts in
its body; at block 256 one warp quantizes a block with 16-byte loads and a
shuffle absmax, other blocks take a thread block each.  dequant gives f32 or
bf16, 16 values a thread with 16-byte loads where the block is a multiple of
16.  :func:`quant_path` and :func:`dequant_path` pick the path from the block
and the input's address alone.  Both match the reference bit for bit (IEEE
division, round half to even, one f32 product rounded to nearest even); see
the source's note.  On CPU tensors the wrappers run the plain versions in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_QUANT_ENTRY = {torch.float32: "quant_int8_f32",
                torch.bfloat16: "quant_int8_bf16"}
_DEQUANT_ENTRY = {torch.float32: "dequant_int8_f32",
                  torch.bfloat16: "dequant_int8_bf16"}

# `path` argument of the C entry points (csrc/quant.cu)
PATH_BLOCK, PATH_VECTOR = 0, 1
WARP_BLOCK = 256     # the block size of quant's warp path


def quant_path(block: int, x_ptr: int) -> int:
    """quant's kernel path: PATH_VECTOR (one warp per quantization block,
    16-byte loads) when the block is WARP_BLOCK and x is 16-byte aligned,
    else PATH_BLOCK (any block, element loads)."""
    return PATH_VECTOR if block == WARP_BLOCK and x_ptr % 16 == 0 else PATH_BLOCK


def dequant_path(block: int, q_ptr: int) -> int:
    """dequant's kernel path: PATH_VECTOR (16 values a thread, 16-byte loads)
    when the block is a multiple of 16 and q is 16-byte aligned, else
    PATH_BLOCK."""
    return PATH_VECTOR if block % 16 == 0 and q_ptr % 16 == 0 else PATH_BLOCK


@functools.cache
def _fn(name: str):
    f = getattr(build.load("quant"), name)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}; "
                         f"all must be on one CUDA device (or on the CPU)")


def quant_int8_2d(x: torch.Tensor, *, block: int = 256):
    """x: (R, n) f32 or bf16 with n % block == 0 -> (int8 (R, n), f32 scales
    (R, n/block))."""
    if x.dim() != 2:
        raise ValueError(f"quant_int8_2d: x must be (R, n), got {tuple(x.shape)}")
    R, n = x.shape
    if block < 1 or n % block:
        raise ValueError(f"quant_int8_2d: last dim {n} must be a multiple "
                         f"of block {block}")
    if x.device.type == "cpu":
        return _ref.quant_int8_ref(x, block)
    _check_cuda("quant_int8_2d", x)
    entry = _QUANT_ENTRY.get(x.dtype)
    if entry is None:
        raise TypeError(f"quant_int8_2d: the kernel takes one of "
                        f"{list(_QUANT_ENTRY)}, got {x.dtype}")
    x = x.contiguous()
    q = torch.empty((R, n), dtype=torch.int8, device=x.device)
    s = torch.empty((R, n // block), dtype=torch.float32, device=x.device)
    err = _fn(entry)(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, n, block,
                     quant_path(block, x.data_ptr()), build.stream_handle(x))
    build.check(err, "quant_int8_2d")
    quant_int8_2d.launches += 1
    return q, s


def dequant_int8_2d(q: torch.Tensor, s: torch.Tensor, *, block: int = 256,
                    dtype=torch.float32) -> torch.Tensor:
    """q: int8 (R, n), s: f32 (R, n/block) -> (R, n) in `dtype`."""
    if q.dim() != 2:
        raise ValueError(f"dequant_int8_2d: q must be (R, n), got {tuple(q.shape)}")
    R, n = q.shape
    if block < 1 or n % block or tuple(s.shape) != (R, n // block):
        raise ValueError(f"dequant_int8_2d: q {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} do not match block {block}")
    if q.device.type == "cpu":
        return _ref.dequant_int8_ref(q, s, block, dtype)
    _check_cuda("dequant_int8_2d", q, s)
    entry = _DEQUANT_ENTRY.get(dtype)
    if q.dtype != torch.int8 or s.dtype != torch.float32 or entry is None:
        raise TypeError(f"dequant_int8_2d: the kernel takes int8 and float32 "
                        f"scales to one of {list(_DEQUANT_ENTRY)}, got "
                        f"{q.dtype}, {s.dtype} -> {dtype}")
    q = q.contiguous()
    s = s.contiguous()
    out = torch.empty((R, n), dtype=dtype, device=q.device)
    err = _fn(entry)(q.data_ptr(), s.data_ptr(), out.data_ptr(), R, n, block,
                     dequant_path(block, q.data_ptr()), build.stream_handle(q))
    build.check(err, "dequant_int8_2d")
    dequant_int8_2d.launches += 1
    return out


quant_int8_2d.launches = 0
dequant_int8_2d.launches = 0
