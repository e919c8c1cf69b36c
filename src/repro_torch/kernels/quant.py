"""Blockwise int8 quant/dequant: the CUDA kernels ``csrc/quant.cu`` and their
wrappers.

Replace ``_quant_kernel`` and ``_dequant_kernel`` in
src/repro/kernels/quant.py: the int8 wire codec of KV shipping (and, once
ported, of compressed gradient sync).  Both are bound on an H100 by bytes;
quant runs one thread block per (row, quantization block) and matches the
reference bit for bit (IEEE division, round half to even), dequant is
elementwise, see the source's note.  On CPU tensors the wrappers run the plain
versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DEQUANT_ENTRY = {torch.float32: "dequant_int8_f32",
                  torch.bfloat16: "dequant_int8_bf16"}
_MAX_GRID = 2 ** 31 - 1


@functools.cache
def _fn(name: str):
    f = getattr(build.load("quant"), name)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}; "
                         f"all must be on one CUDA device (or on the CPU)")


def quant_int8_2d(x: torch.Tensor, *, block: int = 256):
    """x: (R, n) with n % block == 0 -> (int8 (R, n), f32 scales (R, n/block))."""
    if x.dim() != 2:
        raise ValueError(f"quant_int8_2d: x must be (R, n), got {tuple(x.shape)}")
    R, n = x.shape
    if block < 1 or n % block:
        raise ValueError(f"quant_int8_2d: last dim {n} must be a multiple "
                         f"of block {block}")
    if x.device.type == "cpu":
        return _ref.quant_int8_ref(x, block)
    _check_cuda("quant_int8_2d", x)
    if x.dtype != torch.float32:
        raise TypeError(f"quant_int8_2d: the kernel takes float32, got {x.dtype}")
    if R * (n // block) > _MAX_GRID:
        raise ValueError(f"quant_int8_2d: {R * (n // block)} blocks exceed the "
                         f"grid limit {_MAX_GRID}")
    x = x.contiguous()
    q = torch.empty((R, n), dtype=torch.int8, device=x.device)
    s = torch.empty((R, n // block), dtype=torch.float32, device=x.device)
    err = _fn("quant_int8_f32")(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, n,
                                block, build.stream_handle(x))
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
                     build.stream_handle(q))
    build.check(err, "dequant_int8_2d")
    dequant_int8_2d.launches += 1
    return out


quant_int8_2d.launches = 0
dequant_int8_2d.launches = 0
