"""Serve step builder (prefill / decode).

The port of the serve half of the JAX package's ``runtime/step.py``
(``build_serve_step``), on one device: there is no mesh, no sharding and no
ZeRO gather here (sharding is queued in ROADMAP.md).  The training step is
queued too.  PyTorch runs eagerly, so the bundle's ``fn`` is the model call
itself, run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.path import WidePath
from repro_torch.models import build_model


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises here,
    with a clear message, instead of deep inside the first kernel."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but PyTorch sees no CUDA device "
            f"(torch {torch.__version__}, CUDA build "
            f"{torch.version.cuda}); pass device='cpu' to run the plain "
            f"PyTorch versions of the kernels on the CPU")
    return dev


@dataclass
class StepBundle:
    fn: Callable
    model: object
    param_defs: dict
    path: WidePath
    device: torch.device
    cache_defs: Optional[dict] = None


def build_serve_step(rc: RunConfig, kind: Optional[str] = None, *,
                     device="cuda") -> StepBundle:
    """kind: "decode" (one token per row against a ``(B, seq_len)`` cache:
    ``fn(params, cache, pos, tokens) -> (logits, cache)``, the cache updated
    in place) or "prefill" (``fn(params, {"tokens": (B, S)}) -> (logits,
    cache)``)."""
    kind = kind or rc.shape.kind
    dev = resolve_device(device)
    model = build_model(rc.model)
    defs = model.param_defs()
    path = WidePath(axis="pod", comm=rc.comm, name="serve")
    if kind == "decode":
        fn = torch.inference_mode()(model.decode_step)
        return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                          device=dev,
                          cache_defs=model.cache_defs(rc.shape.global_batch,
                                                      rc.shape.seq_len))
    if kind != "prefill":
        raise ValueError(f"serve step kind must be 'decode' or 'prefill', "
                         f"got {kind!r}")
    fn = torch.inference_mode()(model.prefill)
    return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                      device=dev)
