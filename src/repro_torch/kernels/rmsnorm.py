"""RMSNorm over rows: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces ``_rmsnorm_kernel`` in src/repro/kernels/rmsnorm.py.  Bound on an
H100 by bytes (read x once, write y once); one thread block per row with
16-byte loads, see the source's note.  On a CPU tensor the wrapper runs the
plain version, :func:`repro_torch.kernels.ref.rmsnorm_ref`.
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
    vec = 16 // x.element_size()
    vectorized = int(d % vec == 0 and x.data_ptr() % 16 == 0
                     and y.data_ptr() % 16 == 0)
    err = _fn(entry)(x.data_ptr(), w.data_ptr(), y.data_ptr(), R, d, float(eps),
                     vectorized, build.stream_handle(x))
    build.check(err, "rmsnorm_rows")
    rmsnorm_rows.launches += 1
    return y


rmsnorm_rows.launches = 0
