"""Cross-pod payload compression on a ``torch.distributed`` process group.

The port of the JAX package's ``core/compress.py``.  int8 mode: blockwise
absmax int8 through the quant kernel; the sum is taken over the *gathered*
dequantized values (quantize-then-reduce), one dequant launch for the whole
gathered ``(P, ...)`` batch, then a sum over P in f32 in rank order, so that
every rank gets the same bits.  bf16 mode gathers bf16 and sums the same
way.

The pod groups use gloo, which takes CPU tensors: each payload crosses
through host memory (as MPWide's WAN sockets carry it from host memory too)
and comes back to the chunk's device for the dequantize and the sum.  Every
collective is issued with ``async_op=True``; a :class:`Pending` holds it
until :meth:`Pending.finish`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops

QBLOCK = 256


class Pending:
    """An issued collective: ``finish()`` waits for it and returns the
    reduced chunk on the chunk's device.  `sent_bytes` is what this rank
    handed to the group."""

    def __init__(self, works: list, done: Callable[[], torch.Tensor],
                 sent_bytes: int):
        self.works = works
        self._done = done
        self.sent_bytes = int(sent_bytes)

    def finish(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self._done()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of `t` that the collective may own; pinned
    (page-locked, from PyTorch's caching host allocator) when `t` is on the
    card, so the copies out and back run at the link's rate."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.contiguous().clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _gather(t: torch.Tensor, group) -> tuple[torch.Tensor, object]:
    """Start an all_gather of `t` over `group`: the (P, ...) host buffer it
    fills, rank r's copy at index r, and the work."""
    src = _host(t)
    out = torch.empty((dist.get_world_size(group),) + tuple(src.shape),
                      dtype=src.dtype, pin_memory=t.device.type == "cuda")
    return out, dist.all_gather(list(out.unbind(0)), src, group=group,
                                async_op=True)


def _rank_sum(y: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in index (rank) order, in y's dtype."""
    out = y[0]
    for i in range(1, y.shape[0]):
        out = out + y[i]
    return out


def _to_last(x: torch.Tensor, dim: int):
    if x.dim() == 0:
        y = x.reshape(1, 1)
        return y, y.shape, 1
    y = x.movedim(dim, -1)
    return y, y.shape, y.shape[-1]


def quant_chunk(x: torch.Tensor, dim: int):
    """Quantize a chunk along `dim` (its scatter dim), padded to the block.
    Returns (q, scales, meta)."""
    y, _, n = _to_last(x, dim)
    pad = (-n) % QBLOCK
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
    q, s = ops.quant_int8(y, block=QBLOCK)
    return q, s, (tuple(x.shape), x.dtype, dim, n, pad)


def _restore(y: torch.Tensor, meta) -> torch.Tensor:
    shape, dtype, dim, n, pad = meta
    if pad:
        # a copy: a view would keep the padded block alive (a chunk of few
        # rows pads to 256, ROADMAP.md §C 4)
        y = y[..., :n].contiguous()
    if len(shape) == 0:
        return y.reshape(()).to(dtype)
    return y.movedim(-1, dim).to(dtype)


def dequant_chunk(q: torch.Tensor, s: torch.Tensor, meta) -> torch.Tensor:
    return _restore(ops.dequant_int8(q, s, block=QBLOCK, dtype=torch.float32), meta)


def dequant_sum(qg: torch.Tensor, sg: torch.Tensor, meta) -> torch.Tensor:
    """Dequantize a gathered (P, ...) int8 batch in one launch and sum over
    the shard axis in f32, in rank order."""
    y = ops.dequant_int8(qg, sg, block=QBLOCK, dtype=torch.float32)
    return _restore(_rank_sum(y), meta)


def compressed_psum_start(x: torch.Tensor, dim: int, group) -> Pending:
    """Issue the quantize-then-reduce all-reduce of `x` over `group`: the
    int8 payload and the scales are all-gathered (per-pod link bytes
    (P - 1) * n/4 plus the scales)."""
    q, s, meta = quant_chunk(x, dim)
    qg, wq = _gather(q, group)
    sg, ws = _gather(s, group)
    dev = x.device
    return Pending([wq, ws],
                   lambda: dequant_sum(qg.to(dev), sg.to(dev), meta).to(x.dtype),
                   q.numel() + 4 * s.numel())


def bf16_psum_start(x: torch.Tensor, group) -> Pending:
    """Issue the bf16-on-the-wire all-reduce of `x` (gather-based, as in the
    JAX package)."""
    g, w = _gather(x.to(torch.bfloat16), group)
    dev = x.device
    return Pending([w], lambda: _rank_sum(g.to(dev).float()).to(x.dtype),
                   2 * x.numel())


def psum_start(x: torch.Tensor, group) -> Pending:
    """Issue the plain all-reduce (sum) of `x` over `group`, in x's dtype."""
    h = _host(x)
    w = dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group, async_op=True)
    dev = x.device
    return Pending([w], lambda: h.to(dev).reshape(x.shape),
                   h.numel() * h.element_size())


def compressed_psum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return compressed_psum_start(x, dim, group).finish()


def bf16_psum(x: torch.Tensor, group) -> torch.Tensor:
    return bf16_psum_start(x, group).finish()


def reduce_start(x: torch.Tensor, dim: Optional[int], group,
                 compress: str) -> Pending:
    """Issue one chunk's all-reduce with the wire codec `compress`."""
    if compress == "int8":
        return compressed_psum_start(x, dim if dim is not None else 0, group)
    if compress == "bf16":
        return bf16_psum_start(x, group)
    if compress == "none":
        return psum_start(x, group)
    raise ValueError(f"unknown wire codec {compress!r}; have none|bf16|int8")
