"""Chunk planning: split a payload into chunk descriptors and balance them
over streams (MPW_Send "splitted evenly over the channels").

Assignment is greedy longest-processing-time (LPT), not round-robin: chunks
in descending size order each go to the currently least-loaded stream, so
mixed-size payloads keep the per-stream byte loads even;
`plan_summary.load_balance` reports max/mean bucket load.

Leaves are torch tensors (or anything with `shape` and a torch `dtype`, such
as a tensor on the ``meta`` device); chunks are cut along each leaf's scatter
dim.  The plans are the JAX package's, number for number.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Chunk:
    leaf: int                 # index into the flat leaf list
    dim: int                  # dim being sliced
    start: int
    size: int
    nbytes: int               # approximate payload bytes


def leaf_bytes(x) -> int:
    """numel * element_size of a tensor (or of a shape/dtype template)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape)) * x.dtype.itemsize


def chunk_rows(x, dim: Optional[int], chunk_bytes: int) -> Optional[int]:
    """Rows-per-chunk the planner would pick for this leaf (None: unchunked).

    Exposed so bucketed transfers can chunk a *slice* of a leaf with the row
    geometry of the full leaf: identical chunk boundaries along the scatter
    dim keep blockwise int8 quantization bit-identical to the unbucketed
    transfer."""
    nb = leaf_bytes(x)
    if dim is None or nb <= chunk_bytes or len(x.shape) == 0 or x.shape[dim] <= 1:
        return None
    return max(1, chunk_bytes // max(nb // x.shape[dim], 1))


def plan_chunks(leaves: list, dims: list[Optional[int]], chunk_bytes: int,
                rows: Optional[list] = None) -> list[Chunk]:
    """Split each leaf into chunks of <= chunk_bytes along its scatter dim.

    `rows` (per-leaf rows-per-chunk override, None entries = default
    behaviour) forces a leaf's chunk geometry — see :func:`chunk_rows`."""
    chunks: list[Chunk] = []
    for i, (x, dim) in enumerate(zip(leaves, dims)):
        nb = leaf_bytes(x)
        ndim = len(x.shape)
        forced = rows[i] if rows is not None else None
        if forced is None and (dim is None or nb <= chunk_bytes
                               or x.shape[dim] <= 1):
            chunks.append(Chunk(i, dim if dim is not None else 0, 0,
                                x.shape[dim] if dim is not None and ndim else 0, nb))
            continue
        n = x.shape[dim]
        bytes_per_row = nb // n
        rows_i = (forced if forced is not None
                  else max(1, chunk_bytes // max(bytes_per_row, 1)))
        start = 0
        planned = 0
        while start < n:
            size = min(rows_i, n - start)
            # the last chunk absorbs the truncation remainder of nb // n, so
            # summed chunk nbytes exactly equals the leaf's bytes
            cb = nb - planned if start + size >= n else size * bytes_per_row
            chunks.append(Chunk(i, dim, start, size, cb))
            planned += cb
            start += size
        if planned != nb:
            raise RuntimeError(
                f"chunk plan covers {planned} bytes but leaf {i} (shape "
                f"{tuple(x.shape)}, dim {dim}, rows {rows_i}) holds {nb}")
    return chunks


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def normalize_dims(leaves: list, dims=None) -> list[Optional[int]]:
    """Per-leaf scatter dims with the unsharded dim-0 fallback.

    `dims` may be None (fallback everywhere), a flat list, or a nested dict
    whose leaves (sorted-key order, None kept) align with `leaves`.  A leaf
    with no stated scatter dim is sliced along dim 0.

    Negative dims follow numpy semantics (``d % ndim``: -1 is the *last*
    dim).  Out-of-range dims (d >= ndim) are passed through so the chunk
    planner fails loudly, not silently wrapped.
    """
    if dims is None:
        return [0 if len(l.shape) else None for l in leaves]
    dim_list = dims if isinstance(dims, list) else _flat(dims)
    out: list[Optional[int]] = []
    for l, d in zip(leaves, dim_list):
        ndim = len(l.shape)
        if d is None:
            out.append(0 if ndim else None)
        elif ndim == 0:
            out.append(None)
        else:
            out.append(d if d >= 0 else d % ndim)
    return out


def assign_streams(chunks: list[Chunk], streams: int) -> list[list[Chunk]]:
    """Greedy longest-processing-time balancing: chunks in descending size
    order each go to the currently least-loaded stream."""
    streams = max(1, min(streams, max(1, len(chunks))))
    buckets: list[list[Chunk]] = [[] for _ in range(streams)]
    loads = [0] * streams
    for c in sorted(chunks, key=lambda c: -c.nbytes):
        s = int(np.argmin(loads))
        buckets[s].append(c)
        loads[s] += c.nbytes
    return [b for b in buckets if b]


def plan_summary(chunks: list[Chunk], buckets: list[list[Chunk]],
                 streams_configured: int, chunk_bytes: int,
                 pacing: float = 1.0, *, algo: str = "psum", world: int = 1,
                 compress: str = "none",
                 wire_bytes: Optional[int] = None) -> dict:
    """Static traffic shape of a (chunks, buckets) plan, in the kwargs
    telemetry.note_plan expects.

    `algo`/`world`/`compress` feed the modeled per-pod wire-byte count
    (:func:`repro_torch.core.ring.wire_bytes_per_pod`); pass `wire_bytes` to
    override the model."""
    from repro_torch.core.ring import wire_bytes_per_pod
    loads = [sum(c.nbytes for c in b) for b in buckets]
    mean = (sum(loads) / len(loads)) if loads else 0.0
    payload = sum(c.nbytes for c in chunks)
    if wire_bytes is None:
        wire_bytes = int(round(wire_bytes_per_pod(
            payload, int(world), algo=algo, compress=compress)))
    return dict(
        payload_bytes=payload,
        n_chunks=len(chunks),
        streams_used=len(buckets),
        streams_configured=max(1, int(streams_configured)),
        chunk_bytes=int(chunk_bytes),
        pacing=float(pacing),
        load_balance=(max(loads) / mean) if mean > 0 else 1.0,
        algo=str(algo),
        wire_bytes=int(wire_bytes),
    )


def slice_chunk(x: torch.Tensor, c: Chunk) -> torch.Tensor:
    """The chunk's rows of `x`: a view, no copy."""
    if c.size == 0 or c.size == x.shape[c.dim]:
        return x
    return x.narrow(c.dim, c.start, c.size)


def stitch_leaf(x_template: torch.Tensor,
                pieces: list[tuple[Chunk, torch.Tensor]]) -> torch.Tensor:
    """Reassemble a leaf from its processed chunks."""
    if len(pieces) == 1 and (pieces[0][0].size == 0
                             or pieces[0][0].size == x_template.shape[pieces[0][0].dim]):
        return pieces[0][1]
    pieces = sorted(pieces, key=lambda p: p[0].start)
    return torch.cat([p[1] for p in pieces], dim=pieces[0][0].dim)
