"""RMSNorm over rows: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces ``_rmsnorm_kernel`` in src/repro/kernels/rmsnorm.py.  Bound on an
H100 by bytes (read x once, write y once): one warp per row with the row in
registers, or a two-pass block per row for rows that cannot take that path
(:func:`row_path`); see the source's note.  On a CPU tensor the wrapper runs
the plain version, :func:`repro_torch.kernels.ref.rmsnorm_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_ENTRY = {
    (torch.bfloat16, torch.bfloat16): "rmsnorm_bf16_wbf16",
    (torch.bfloat16, torch.float32): "rmsnorm_bf16_wf32",
    (torch.float32, torch.bfloat16): "rmsnorm_f32_wbf16",
    (torch.float32, torch.float32): "rmsnorm_f32_wf32",
}


# `path` argument of the C entry points (csrc/rmsnorm.cu)
PATH_SCALAR, PATH_VECTOR, PATH_ROW = 0, 1, 2
# row widths the row path is compiled for, in 16-byte vectors per lane
# (d = 32 * steps * 16 / itemsize: 1024 ... 6144 for bf16 rows); the cases of
# `launch` in csrc/rmsnorm.cu
ROW_STEPS = (4, 6, 8, 12, 16, 20, 24)


def row_path(d: int, itemsize: int, x_ptr: int, y_ptr: int, w_ptr: int) -> int:
    """The kernel path for rows of `d` elements of `itemsize` bytes, from the
    shape and the tensors' addresses alone: the row path when d is 32 lanes
    times one of ROW_STEPS 16-byte vectors and x, y and w are 16-byte
    aligned; else the two-pass loop, with 16-byte loads of x and y where d
    and their addresses allow them."""
    vec = 16 // itemsize
    if d % vec or x_ptr % 16 or y_ptr % 16:
        return PATH_SCALAR
    steps, rest = divmod(d // vec, 32)
    return (PATH_ROW if rest == 0 and steps in ROW_STEPS and w_ptr % 16 == 0
            else PATH_VECTOR)


@functools.cache
def _fn(name: str):
    f = getattr(build.load("rmsnorm"), name)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def rmsnorm_rows(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d); w: (d,) -> (R, d) in x.dtype."""
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm_rows: x on {x.device}, w on {w.device}; "
                         f"both must be on one CUDA device (or x on the CPU)")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_rows: x {tuple(x.shape)} must be (R, d) and "
                         f"w {tuple(w.shape)} must be (d,)")
    entry = _ENTRY.get((x.dtype, w.dtype))
    if entry is None:
        raise TypeError(f"rmsnorm_rows: no kernel for x {x.dtype}, w {w.dtype}; "
                        f"have {sorted(str(k) for k in _ENTRY)}")
    x = x.contiguous()
    w = w.contiguous()
    R, d = x.shape
    y = torch.empty_like(x)
    path = row_path(d, x.element_size(), x.data_ptr(), y.data_ptr(), w.data_ptr())
    err = _fn(entry)(x.data_ptr(), w.data_ptr(), y.data_ptr(), R, d, float(eps),
                     path, build.stream_handle(x))
    build.check(err, "rmsnorm_rows")
    rmsnorm_rows.launches += 1
    return y


rmsnorm_rows.launches = 0
