"""Latency hiding: overlap the cross-pod gradient sync with compute
(MPW_ISendRecv / MPW_Wait, the bloodflow-coupling trick).

The port of ``accum_grads`` from the JAX package's ``core/overlap.py``.  With
``m > 1`` microbatches and overlap on, microbatch i-1's sync is issued after
microbatch i's gradients are computed, as the reference orders it, so only
the last sync is exposed.  With the int8 codec the two orders give different
numbers (each synced gradient is quantized on its own), so the order is part
of the result.

:func:`flush_hook` is the bucketed backward flush (``core/buckets.py``): an
identity in the forward around a bucket's layer range, whose backward runs
the bucket's sync once every layer of the range has returned its gradient.
Like ``accum_grads``, it issues the sync at the reference's point of the
backward and waits for it there; it does not overlap it with the backward
of earlier layers.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.autotune import simulate_transfer_s
from repro_torch.core.tree import flatten, tree_map, unflatten


def accum_grads(grad_fn: Callable, params, microbatches: list, *,
                sync: Callable, overlap: bool = True):
    """grad_fn(params, microbatch) -> ((loss, metrics), grads).

    `microbatches`: a list of m microbatches.  sync(grads) -> synced grads
    (the WidePath transfer).  Returns (mean_loss, metrics_last,
    synced_grad_sum).  With overlap=False (or m == 1) this is plain
    accumulate-then-sync."""
    m = len(microbatches)
    if not overlap or m == 1:
        total_loss = torch.zeros((), dtype=torch.float32)
        acc = None
        metrics = None
        for mb in microbatches:
            (loss, metrics), g = grad_fn(params, mb)
            total_loss = total_loss.to(loss.device) + loss
            acc = g if acc is None else tree_map(torch.add, acc, g)
        return total_loss / m, metrics, sync(acc)

    # software-pipelined: sync microbatch i-1 after computing microbatch i
    (loss0, metrics), pending = grad_fn(params, microbatches[0])
    total_loss = loss0
    synced = None
    for i in range(1, m):
        (loss_i, metrics), g_i = grad_fn(params, microbatches[i])
        s = sync(pending)
        synced = s if synced is None else tree_map(torch.add, synced, s)
        pending = g_i
        total_loss = total_loss + loss_i
    s = sync(pending)                   # exposed tail (1/m of the naive cost)
    synced = s if synced is None else tree_map(torch.add, synced, s)
    return total_loss / m, metrics, synced


class _Flush(torch.autograd.Function):
    """Identity on a tree's leaves; the backward maps the cotangents through
    `sync_fn` and returns them in the primal dtypes."""

    @staticmethod
    def forward(ctx, sync_fn, td, *leaves):
        ctx.sync_fn, ctx.td = sync_fn, td
        ctx.dtypes = [x.dtype for x in leaves]
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        synced = flatten(ctx.sync_fn(unflatten(ctx.td, list(grads))))[0]
        return (None, None, *[g.to(dt) for g, dt in zip(synced, ctx.dtypes)])


def flush_hook(sync_fn: Callable) -> Callable:
    """Identity-in-forward hook whose *backward* runs `sync_fn` on the
    cotangent tree: ``hook(tree) -> tree``.

    Wrapped around a bucket's (layer-sliced) parameters before its layers
    run, the hook runs the bucket's cross-pod gradient sync where the
    bucket's backward slice is produced.  The cotangents come back in the
    primal dtypes (the reference's ``custom_vjp`` forces that), so a
    `sync_fn` that syncs in f32 rounds to the parameters' dtype again."""
    def hook(tree):
        leaves, td = flatten(tree)
        return unflatten(td, list(_Flush.apply(sync_fn, td, *leaves)))
    return hook


def modeled_exposure(payload_bytes: float, link, *, streams: int,
                     chunk_bytes: float, pacing: float = 1.0,
                     compute_window: float = 0.0, bucket_bytes: float = 0.0,
                     microbatches: int = 1, world: int = 2,
                     algo: str = "psum", compress: str = "none",
                     backward_frac: float = 2.0 / 3.0) -> dict:
    """One train step's modeled cross-pod comm exposure, as the JAX package
    models it: microbatches 1..m-1 sync under the next microbatch's compute
    window, the final one's sync is exposed (with buckets, only what spills
    past the backward).  Per-transfer seconds from
    :func:`repro_torch.core.autotune.simulate_transfer_s`.  Returns
    dict(exposed_s, overlapped_s, comm_s, n_buckets, per_bucket_s)."""
    def t_of(nbytes: float) -> float:
        return simulate_transfer_s(nbytes, link, streams=streams,
                                   chunk_bytes=chunk_bytes, pacing=pacing,
                                   algo=algo, world=world, compress=compress)

    m = max(1, int(microbatches))
    W = max(0.0, float(compute_window))
    t_all = t_of(payload_bytes)
    if bucket_bytes and bucket_bytes > 0:
        n_buckets = max(1, math.ceil(payload_bytes / bucket_bytes))
        per_bucket = [t_all / n_buckets + link.latency_s] * n_buckets
    else:
        n_buckets = 1
        per_bucket = [t_all]
    exposed = (m - 1) * max(0.0, sum(per_bucket) - W)
    Wb = backward_frac * W
    end = 0.0
    for k, t_k in enumerate(per_bucket):
        ready = Wb * (k + 1) / n_buckets
        end = max(end, ready) + t_k
    exposed += max(0.0, end - Wb)
    comm = m * sum(per_bucket)
    return dict(exposed_s=exposed, overlapped_s=max(0.0, comm - exposed),
                comm_s=comm, n_buckets=n_buckets, per_bucket_s=per_bucket)
