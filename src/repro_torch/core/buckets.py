"""Layer-bucketed gradient sync: the port of the JAX package's
``core/buckets.py``.

The gradient tree is partitioned into ``bucket_bytes``-sized buckets along
the stacked ``layers`` dim, one streamed cross-pod psum per bucket:

  * **backward flush** — the train step wraps each bucket's layer range in
    :func:`repro_torch.core.overlap.flush_hook`, whose backward runs the
    bucket's sync the moment the bucket's backward slice is produced;
  * **tail mode** — the post-backward sync goes bucket by bucket
    (:func:`bucketed_sync`) and the optimizer takes the buckets one by one
    (:func:`repro_torch.optim.adamw.adamw_update` with ``buckets=``).

Bucket boundaries slice the leading layers dim of the stacked ``blocks``
leaves, never a scatter dim.  A leaf is layer-bucketable only when it has a
stated scatter dim other than 0: leaves chunked along the dim-0 fallback
would change their blockwise-int8 quantization blocks under layer slicing,
so they ride in the rest bucket.  Within a bucket each slice is chunked with
the row geometry of its full leaf (:func:`repro_torch.core.streams.
chunk_rows`), which keeps bucketed transfers bit-identical to the unbucketed
path for every algorithm and codec.

Bucket indices count from the output end of the stack (bucket 0 = the last
layers, the first gradients the backward produces); the rest bucket
(embedding, head, norms, any stacked leaf that is not sliceable) comes last.
Telemetry lands under ``{key}/bkt{i}``.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.path import WidePath
from repro_torch.core.ring import wire_bytes_per_pod
from repro_torch.core.tree import flatten, unflatten


@dataclass(frozen=True)
class Bucket:
    """One sync bucket: a layer range of the stacked subtree, or the rest
    bucket (``lo == hi == -1``) holding every non-layer-sliceable leaf."""
    index: int
    lo: int
    hi: int
    nbytes: int                   # payload bytes of this bucket's slices

    @property
    def is_rest(self) -> bool:
        return self.lo < 0


@dataclass(frozen=True)
class BucketPlan:
    n_layers: int
    layers_per_bucket: int
    buckets: tuple                # layer buckets (backward order) + rest
    stacked_bytes: int
    rest_bytes: int

    @property
    def layer_buckets(self) -> tuple:
        return tuple(b for b in self.buckets if not b.is_rest)

    @property
    def rest_bucket(self) -> Optional[Bucket]:
        for b in self.buckets:
            if b.is_rest:
                return b
        return None

    @property
    def layer_bounds(self) -> list:
        """[(lo, hi), ...] in forward (ascending-layer) order."""
        return sorted((b.lo, b.hi) for b in self.layer_buckets)


def _flat(tree) -> list:
    return tree if isinstance(tree, list) else flatten(tree)[0]


def bucketable_flags(leaves: list, stacked, dims=None) -> list[bool]:
    """Per-leaf layer-bucketability: marked stacked AND a stated scatter dim
    other than 0 (negative dims counted from the end, as in
    :func:`repro_torch.core.streams.normalize_dims`).  `stacked` and `dims`
    are trees beside the leaves' tree, or flat lists (None kept)."""
    flag_list = _flat(stacked)
    dim_list = [None] * len(leaves) if dims is None else _flat(dims)
    out = []
    for x, f, d in zip(leaves, flag_list, dim_list):
        ok = bool(f) and d is not None and len(x.shape) >= 2
        if ok:
            ok = (d if d >= 0 else d % len(x.shape)) != 0
        out.append(ok)
    return out


def plan_buckets(leaves: list, flags: list[bool], bucket_bytes: int
                 ) -> BucketPlan:
    """Tile the stacked leaves' leading layers dim into ~bucket_bytes ranges,
    cut from the top of the stack (backward order); the last (lowest-layer)
    bucket absorbs the remainder, so the ranges tile ``[0, n_layers)``
    exactly.  Leaves may be tensors on the ``meta`` device."""
    stacked_leaves = [x for x, f in zip(leaves, flags) if f]
    rest_bytes = sum(st.leaf_bytes(x) for x, f in zip(leaves, flags) if not f)
    if not stacked_leaves or bucket_bytes <= 0:
        rest = (Bucket(0, -1, -1, rest_bytes),) if rest_bytes else ()
        return BucketPlan(0, 0, rest, 0, rest_bytes)
    n_layers = {x.shape[0] for x in stacked_leaves}
    if len(n_layers) != 1:
        raise ValueError(f"stacked leaves disagree on the layers dim: "
                         f"{sorted(n_layers)}")
    nL = n_layers.pop()
    stacked_bytes = sum(st.leaf_bytes(x) for x in stacked_leaves)
    per_layer = max(1, stacked_bytes // nL)
    lpb = max(1, int(bucket_bytes // per_layer))
    buckets: list[Bucket] = []
    hi = nL
    planned = 0
    while hi > 0:
        lo = max(0, hi - lpb)
        nb = sum((st.leaf_bytes(x) // nL) * (hi - lo) for x in stacked_leaves)
        if lo == 0:   # the remainder bucket absorbs the byte-accounting tail
            nb = stacked_bytes - planned
        buckets.append(Bucket(len(buckets), lo, hi, nb))
        planned += nb
        hi = lo
    if planned != stacked_bytes:
        raise RuntimeError(
            f"bucket plan covers {planned} bytes but the stacked leaves "
            f"hold {stacked_bytes} (n_layers={nL}, layers_per_bucket={lpb})")
    if rest_bytes:
        buckets.append(Bucket(len(buckets), -1, -1, rest_bytes))
    return BucketPlan(nL, lpb, tuple(buckets), stacked_bytes, rest_bytes)


def bucket_indices(flags: list[bool], bucket: Bucket) -> list[int]:
    """Flat-leaf indices participating in one bucket."""
    if bucket.is_rest:
        return [i for i, f in enumerate(flags) if not f]
    return [i for i, f in enumerate(flags) if f]


def slice_leaf(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Layer-range slice of a stacked leaf: a view (also of a meta tensor)."""
    return x.narrow(0, lo, hi - lo)


def bucket_payload(leaves: list, flags: list[bool], bucket: Bucket
                   ) -> tuple[list, list[int]]:
    """(payload leaves, their original flat indices) for one bucket."""
    idx = bucket_indices(flags, bucket)
    if bucket.is_rest:
        return [leaves[i] for i in idx], idx
    return [slice_leaf(leaves[i], bucket.lo, bucket.hi) for i in idx], idx


def aligned_chunks(full_leaves: list, payload: list, idx: list[int],
                   dim_list: list, chunk_bytes: int) -> list:
    """Chunk plan for a bucket payload using each FULL leaf's row geometry,
    so chunk boundaries along the scatter dim, and therefore blockwise-int8
    quantization blocks, match the unbucketed transfer exactly."""
    rows = [st.chunk_rows(full_leaves[i], dim_list[i], chunk_bytes)
            for i in idx]
    sub_dims = [dim_list[i] for i in idx]
    return st.plan_chunks(payload, sub_dims, chunk_bytes, rows=rows)


def bucketed_sync(tree, path: WidePath, mesh, *, stacked, dims=None,
                  site_groups=None, tel_prefix: Optional[str] = None,
                  bucket_bytes: Optional[int] = None, log=None,
                  timer: Optional[Callable[[int], object]] = None):
    """Chunked, streamed cross-pod psum of a tree over `mesh`'s pod axis,
    one :func:`repro_torch.core.collectives.streamed_psum` per bucket.

    `stacked` marks the leaves carrying a leading layers dim (a tree of
    bools beside `tree`, or a flat list); `dims` the usual per-leaf scatter
    dims.  Bit-identical to ``streamed_psum(tree, ...)`` for every algorithm
    and codec: buckets only re-partition which chunks travel together, and
    chunk geometry within a slice mirrors the full leaf's.  Per-bucket plans
    land under ``{key}/bkt{i}``; `log` (a list) receives each chunk's dict
    with its ``bucket`` index; `timer(i)`, when given, is a context manager
    entered around bucket i's transfer."""
    from repro_torch.core.collectives import streamed_psum
    bb = path.bucket_bytes if bucket_bytes is None else int(bucket_bytes)
    if bb <= 0:
        return streamed_psum(tree, path, mesh, dims=dims,
                             site_groups=site_groups, log=log)
    if mesh is None or mesh.pod_group is None:
        return tree
    leaves, td = flatten(tree)
    flags = bucketable_flags(leaves, stacked, dims)
    ndims = st.normalize_dims(leaves, dims)
    plan = plan_buckets(leaves, flags, bb)
    key = tel_prefix or path.key
    pieces: dict[int, list] = {i: [] for i in range(len(leaves))}
    out: list = list(leaves)
    for b in plan.buckets:
        payload, idx = bucket_payload(leaves, flags, b)
        if not payload:
            continue
        chunks = aligned_chunks(leaves, payload, idx, ndims, path.chunk_bytes)
        blog: list = []
        with (timer(b.index) if timer is not None else nullcontext()):
            synced = streamed_psum(payload, path, mesh,
                                   dims=[ndims[i] for i in idx],
                                   site_groups=site_groups,
                                   tel_key=f"{key}/bkt{b.index}",
                                   chunks=chunks, log=blog)
        if log is not None:
            log.extend({**c, "bucket": b.index} for c in blog)
        for i, s in zip(idx, synced):
            if b.is_rest:
                out[i] = s
            else:
                pieces[i].append((b.lo, s))
    for i, ps in pieces.items():
        if ps:
            out[i] = torch.cat([s for _, s in sorted(ps, key=lambda p: p[0])],
                               dim=0)
    return unflatten(td, out)


def note_bucket_plans(path: WidePath, leaves: list, dims, stacked,
                      bucket_bytes: Optional[int] = None,
                      key: Optional[str] = None, world: int = 1,
                      flags: Optional[list] = None) -> Optional[BucketPlan]:
    """Record per-bucket traffic plans from template leaves (build time), as
    :func:`bucketed_sync` and the flush hooks will note them.  `flags`
    overrides the bucketability test (the backward flush buckets *every*
    stacked leaf with its segment).  Returns the plan (None when bucketing
    is off)."""
    bb = path.bucket_bytes if bucket_bytes is None else int(bucket_bytes)
    if bb <= 0:
        return None
    if flags is None:
        flags = bucketable_flags(leaves, stacked, dims)
    ndims = st.normalize_dims(leaves, dims)
    plan = plan_buckets(leaves, flags, bb)
    key = key or path.key
    for b in plan.buckets:
        payload, idx = bucket_payload(leaves, flags, b)
        if not payload:
            continue
        chunks = aligned_chunks(leaves, payload, idx, ndims, path.chunk_bytes)
        buckets = st.assign_streams(chunks, path.streams)
        wire = wire_bytes_per_pod(sum(c.nbytes for c in chunks), world,
                                  algo=path.comm.algo,
                                  compress=path.comm.compress)
        tel.note_plan(f"{key}/bkt{b.index}", **st.plan_summary(
            chunks, buckets, path.streams, path.chunk_bytes,
            path.comm.pacing, algo=path.comm.algo, world=world,
            compress=path.comm.compress, wire_bytes=int(round(wire))))
    return plan
