"""Train and serve step builders.

The port of the JAX package's ``runtime/step.py``.  PyTorch runs eagerly, so
a bundle's ``fn`` is plain Python over the model and the collectives, not a
jitted shard_map.

* :func:`build_train_step`: one data-parallel training step on a
  :class:`repro_torch.launch.mesh.PodMesh` of ``pod`` x ``data`` ranks (no
  tensor parallelism), modes ``flat``, ``hierarchical`` and ``gateway``, in
  the reference's sequence: f32 gradients after the backward,
  ``accum_grads`` with the WidePath sync, division by the data-parallel
  world, ``lr_at``, ``adamw_update``, and the loss averaged over every
  rank.  With ``zero1``, the hierarchical mode and ``data > 1`` it is
  ZeRO-3: parameters and AdamW moments are stored scattered over the data
  group, each layer's weights are all-gathered at use (:class:`AllGatherAtUse`,
  whose backward reduce-scatters the gradients in f32), and only the 1/D
  shards cross the pod axis.  Under ZeRO, ``CommConfig.bucket_mb > 0``
  buckets the gradient sync along the stacked layers (``core/buckets.py``):
  with no wire codec each bucket's sync runs in the backward from a flush
  hook around its layer range (flush mode), with a codec the post-backward
  sync runs bucket by bucket (tail mode); AdamW takes the buckets one by
  one.  With ``site_groups`` (``Topology.pod_groups``) the cross-pod stage
  is site-hierarchical (``core/collectives.py`` ``site_allreduce``): the
  pods of a site sum first, then only the site gateways cross the WAN.
  A ``route`` (``core/topology.py`` ``Route``) makes the cross-pod path
  multi-hop: the sync runs with the bottleneck hop's knobs and every hop's
  plan is noted.  ``local_only=True`` is the local-SGD step: the gradient
  sync stays inside each site.
* :func:`build_delta_sync` and :func:`build_catchup`: local SGD's cross-site
  reconciliation and a rejoined site's catch-up (``core/localsgd.py``), as
  plain callables over the mesh.
* :func:`build_serve_step`: prefill / decode under
  ``torch.inference_mode()``, on one device or over the model axis of a
  mesh.

On a mesh with a model axis (``model > 1``) both builders run tensor and
expert parallelism (``models/transformer.py``, ``models/moe_ep.py``) on the
dense and moe families: each rank holds its TP shards (``bundle.tp_dims``,
the JAX package's ``spec_for`` layout), every model rank of a (pod, data)
coordinate takes the same batch rows, the replicated leaves' gradients come
out equal on every model rank and the sharded leaves' stay local, and the
cross-pod sync runs per model index over its pod group.  Its plan is the
reference's: with no wire codec (and wherever the reference's sync is not
wrapped in its manual ``{"model"}`` shard_map: without ZeRO, or in the
gateway mode) the chunks of the whole leaves, each rank moving its part
(``core/collectives.py`` ``TPView``); under ZeRO with a codec the chunks of
the rank-local shards.  The gradient norm sums the sharded leaves' squares
over the model group.  What stays queued on such a mesh raises
``NotImplementedError`` naming ROADMAP.md's 'tensor parallelism and the
production meshes': the ssm, hybrid, audio and vlm families, ``bucket_mb``,
the ring algorithms, site groups and routes, local SGD, the attention modes
other than ``heads``, and serving over data-parallel ranks.
"""
from __future__ import annotations

import functools
import inspect
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import buckets as bk
from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import autotune_path
from repro_torch.core.collectives import (TP_ITEM, TPView, _note_hop_plans,
                                          all_gather_dim, local_site_allreduce,
                                          psum_group, queued, reduce_scatter_dim,
                                          streamed_psum, wide_allreduce)
from repro_torch.core.overlap import accum_grads, flush_hook, modeled_exposure
from repro_torch.core.path import INTERPOD, WidePath
from repro_torch.core.tree import flatten, tree_map, unflatten
from repro_torch.launch.roofline import modeled_compute_window
from repro_torch.models import build_model
from repro_torch.models.layers import TensorParallel
from repro_torch.models.param import leaf_bytes_pd, tree_init, tree_tp_dims
from repro_torch.optim import adamw_update, init_opt_state, lr_at
from repro_torch.sharding import (dp_axes_of, map_with_dims, strip_layer_dim,
                                  tree_fsdp_dims)


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
    mesh: object = None                # train bundles: the PodMesh
    dims: object = None                # per-leaf scatter dims of the stored state (ZeRO), else None
    zero: bool = False
    bucket_plan: object = None         # BucketPlan when the sync is bucketed
    replan: Optional[Callable] = None  # re-notes this bundle's sync plan
    tp_dims: object = None             # per-leaf TP dims on a model axis, else None

    def init_state(self, seed: int = 0) -> dict:
        """Parameters from `seed` and a fresh optimizer state, on the
        bundle's device: the same bits on every rank, and under ZeRO or
        tensor parallelism this rank's shards of them."""
        params = self.init_params(seed)
        return {"params": params, "opt": init_opt_state(params)}

    def init_params(self, seed: int = 0):
        """Parameters from `seed`: this rank's shards, as in init_state."""
        return tree_init(self.param_defs, seed, device=self.device,
                         dims=self.dims, mesh=self.mesh, tp_dims=self.tp_dims)


# ---------------------------------------------------------------------------
# gather hook construction (ZeRO-3 all-gather-at-use)
# ---------------------------------------------------------------------------

class AllGatherAtUse(torch.autograd.Function):
    """ZeRO-3 all-gather at use over the data group, whose backward
    reduce-scatters the cotangent in f32 and rounds the shard back to the
    parameter's dtype, as the reference's ``_ag_use`` / ``_ag_bwd`` do.

    `stats` (a dict from :func:`inpod_stats`, or None) takes each call's
    host-clock seconds, from a device sync as the step's ``sync_s``, and
    one count."""

    @staticmethod
    def forward(ctx, x, dim: int, group, stats):
        ctx.dim, ctx.group, ctx.dtype, ctx.stats = dim, group, x.dtype, stats
        with _timed(stats, "gather", x.device):
            return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        with _timed(ctx.stats, "reduce_scatter", g.device):
            rs = reduce_scatter_dim(g.float(), ctx.dim, ctx.group)
        return rs.to(ctx.dtype), None, None, None


def inpod_stats() -> dict:
    """Zeroed host seconds and calls of the in-pod gathers (forward and
    recompute) and reduce-scatters (backward)."""
    return {"gather_s": 0.0, "gather_n": 0, "reduce_scatter_s": 0.0,
            "reduce_scatter_n": 0}


@contextmanager
def _timed(stats, kind: str, dev: torch.device):
    if stats is None:
        yield
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats[f"{kind}_s"] += time.perf_counter() - t0
    stats[f"{kind}_n"] += 1


def _make_gather(defs, dims_tree, zero: bool, group, stats=None):
    """Returns (gather_layer, gather_top), as the reference's: gather_layer(lp)
    gathers one layer's parameters inside a layer loop, matched by its tree
    structure to one table per stacked subtree (``blocks``, and the audio
    family's ``encoder`` without its final norm); gather_top(params) the
    leaves outside the loops (embedding, head, final norms, the hybrid
    family's shared block).  An unknown layer structure raises.  Identities
    without ZeRO.  `stats`: see :class:`AllGatherAtUse`."""
    if not zero or group is None:
        return None, lambda p: p
    tables = []
    for key in ("blocks", "encoder"):
        if key in defs:
            src = dims_tree[key]
            if key == "encoder":   # ln_f is applied outside the layer loop
                src = {k: v for k, v in src.items() if k != "ln_f"}
            leaves, td = flatten(strip_layer_dim(src))
            tables.append((td, leaves))

    def gather_leaf(x, d):
        if d is None:
            return x
        return AllGatherAtUse.apply(x, d, group, stats)

    def gather_layer(lp):
        leaves, td = flatten(lp)
        for td_ref, dims in tables:
            if td == td_ref:
                return unflatten(td, [gather_leaf(x, d) for x, d in zip(leaves, dims)])
        raise ValueError(f"gather: unknown layer structure {td}")

    def gather_top(params):
        out = {}
        for k, v in params.items():
            if k == "blocks":
                out[k] = v
            elif k == "encoder":
                out[k] = {**v, "ln_f": gather_leaf(v["ln_f"], dims_tree[k]["ln_f"])}
            else:
                out[k] = map_with_dims(gather_leaf, v, dims_tree[k])
        return out

    return gather_layer, gather_top


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _param_bytes(defs) -> int:
    return sum(leaf_bytes_pd(pd) for pd in flatten(defs)[0])


def _eff_grad_leaves(defs, dims, shard: int):
    """(leaves, scatter dims) of the cross-pod gradient payload: f32 on the
    wire, ZeRO leaves scattered over the data group as 1/shard slices,
    exactly what the streamed psum sees, as ``meta`` tensors."""
    eff_leaves, eff_dims = [], []
    for pd, d in zip(flatten(defs)[0], flatten(dims)[0]):
        shape = list(pd.shape)
        if d is not None and shard > 1 and shape[d] % shard == 0:
            shape[d] //= shard
        eff_leaves.append(torch.empty(shape, dtype=torch.float32, device="meta"))
        eff_dims.append(d if (d is not None and len(shape)) else None)
    return eff_leaves, eff_dims


def _note_path_plan(defs, dims, path: WidePath, shard: int, world: int = 1, *,
                    stacked_flags=None, window: float = 0.0,
                    m_micro: int = 1) -> None:
    """Record the path's static gradient-sync plan into telemetry, as the
    JAX package records it at build time: gradients are f32 on the wire and,
    under ZeRO, each scatterable leaf crosses pods as a 1/shard slice;
    `world` (the pod-axis size) feeds the modeled per-pod wire bytes; with
    `stacked_flags` (the sync is bucketed) each bucket's plan lands under
    ``{key}/bkt{i}``; the modeled exposure against `window` lands in the
    overlap note."""
    eff_leaves, eff_dims = _eff_grad_leaves(defs, dims, shard)
    chunks = st.plan_chunks(eff_leaves, eff_dims, path.chunk_bytes)
    buckets = st.assign_streams(chunks, path.streams)
    tel.note_plan(path.key, **st.plan_summary(
        chunks, buckets, path.streams, path.chunk_bytes, path.comm.pacing,
        algo=path.comm.algo, world=world, compress=path.comm.compress))
    if path.hops:
        _note_hop_plans(path, eff_leaves, eff_dims)
    bucketed = stacked_flags is not None and path.bucket_bytes > 0
    if bucketed:
        bk.note_bucket_plans(path, eff_leaves, eff_dims, None, world=world,
                             flags=stacked_flags)
    res = modeled_exposure(
        sum(st.leaf_bytes(x) for x in eff_leaves), path.link,
        streams=path.streams, chunk_bytes=path.chunk_bytes,
        pacing=path.comm.pacing, compute_window=window,
        bucket_bytes=path.bucket_bytes if bucketed else 0,
        microbatches=m_micro, world=max(2, world),
        algo=path.comm.algo, compress=path.comm.compress)
    tel.note_overlap(path.key, res["exposed_s"], res["overlapped_s"])


def _make_flush_segments(defs, dims, path: WidePath, plan, mesh, shard: int,
                         record, site_groups=None):
    """(layer bounds, one flush hook per bound) for the segmented layer loop.

    Each hook's backward casts its bucket's gradients (the stacked blocks'
    slices) to f32, sums the replicated leaves over the data group, runs the
    bucket's streamed psum under ``{key}/bkt{i}`` with each slice chunked in
    its full leaf's rows (site-hierarchical with `site_groups`), and rounds
    back to the leaf's dtype, as the reference's ``_make_flush_segments``
    does.  `record(i)` is a context manager around bucket i's sync that
    yields the list its chunks are logged into."""
    blocks_eff, blocks_dims = _eff_grad_leaves(defs["blocks"], dims["blocks"],
                                               shard)
    blocks_ndims = st.normalize_dims(blocks_eff, blocks_dims)
    rows_full = [st.chunk_rows(x, d, path.chunk_bytes)
                 for x, d in zip(blocks_eff, blocks_ndims)]
    index_of = {(b.lo, b.hi): b.index for b in plan.layer_buckets}

    def make_sync(bi: int):
        def sync_seg(g):
            leaves, td = flatten(g)
            gf = [l.float() for l in leaves]
            with record(bi) as log:
                gf = [psum_group(l, mesh.data_group) if d is None else l
                      for l, d in zip(gf, blocks_dims)]
                chunks = st.plan_chunks(gf, blocks_ndims, path.chunk_bytes,
                                        rows=rows_full)
                synced = streamed_psum(gf, path, mesh, dims=blocks_dims,
                                       site_groups=site_groups,
                                       tel_key=f"{path.key}/bkt{bi}",
                                       chunks=chunks, log=log)
            return unflatten(td, [s.to(l.dtype) for s, l in zip(synced, leaves)])
        return sync_seg

    bounds = plan.layer_bounds
    return bounds, [flush_hook(make_sync(index_of[b])) for b in bounds]


def _bucket_rows(plan, log: list, seconds: dict) -> list:
    """Per bucket of `plan`, in index order: its sync seconds and the
    chunks, payload, wire and sent bytes of its logged chunks."""
    rows = []
    for b in plan.buckets:
        mine = [c for c in log if c["bucket"] == b.index]
        rows.append({"index": b.index, "lo": b.lo, "hi": b.hi,
                     "sync_s": seconds.get(b.index, 0.0), "n_chunks": len(mine),
                     **{k: sum(c[k] for c in mine) for k in
                        ("payload_bytes", "wire_bytes", "sent_bytes")}})
    return rows


def split_microbatches(batch: dict, m: int) -> list[dict]:
    """`batch` cut along rows into `m` microbatches, every leaf alike (the
    tokens and the family's stub inputs), as the reference reshapes each
    leaf to ``(m, rows // m, ...)``."""
    for k, v in batch.items():
        if v.shape[0] % m:
            raise ValueError(f"local batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {m} microbatches")
    parts = {k: v.chunk(m, dim=0) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(m)]


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def build_train_step(rc: RunConfig, mesh, *, route=None, site_groups=None,
                     local_only: bool = False) -> StepBundle:
    """The training step on `mesh`: ``fn(state, batch) -> (state, metrics)``
    with `batch` this rank's rows ``{"tokens": (B_local, S+1)}`` (and the
    family's stub inputs, ``patch_embeds`` or ``source_frames``, with the
    same rows) on the mesh's device and, under ZeRO (``bundle.zero``),
    `state` this rank's shards.  The step donates `state`, as the
    reference's ``jax.jit(donate_argnums=(0,))``: its AdamW moments are
    updated in place, so the caller keeps only the returned state.  The
    autotuner's warm start reads the modeled compute window at the H100's
    peak (``launch/roofline.py``).

    Metrics: loss (averaged over every rank), lr, grad_norm (the
    reference's: under ZeRO the scattered leaves count once per pod,
    ROADMAP.md §C 6), aux_loss, and of the step's gradient sync: sync_s
    (host clock from a device sync to the synced gradients, the flush
    hooks' syncs in the backward included; under ZeRO the in-pod
    reduce-scatter runs in the backward, before it), chunks (the per-chunk
    log of :func:`repro_torch.core.collectives.streamed_psum`), wire_bytes
    (their modeled per-pod link bytes) and sent_bytes; under ZeRO also the
    in-pod stages' host seconds and calls (gather_s, gather_n,
    reduce_scatter_s, reduce_scatter_n; :func:`inpod_stats`); bucket_mode
    ("flush", "tail" or None) and buckets (per bucket: its sync seconds,
    chunks, payload, wire and sent bytes; :func:`_bucket_rows`).

    `site_groups` (lists of pod indices, one per site) must tile the pod
    axis; with one pod there is nothing to group and they are dropped.
    `route` (a ``core/topology.py`` ``Route``) makes the cross-pod path
    multi-hop: per-hop links and knobs from the route's LinkProfiles, the
    bottleneck leg driven by ``rc.comm`` (the autotuner's slot), per-hop
    plans in telemetry.  The bundle's ``replan`` re-notes its plan (a
    trainer swapping back to a cached bundle calls it).

    `local_only=True` builds the local-SGD step (``CommConfig.local_steps >
    1``, hierarchical mode only): the gradient sync stays inside each site
    (a rank-order sum over the site group, the whole pod group without
    `site_groups`), with no WAN stage, no bucketing and no plan noted, and
    the gradients are divided by the ranks of one site; the cross-site
    reconciliation is :func:`build_delta_sync`."""
    if rc.comm.mode not in ("flat", "hierarchical", "gateway"):
        raise ValueError(f"unknown comm mode {rc.comm.mode!r}")
    if local_only and rc.comm.mode != "hierarchical":
        raise ValueError(f"local-SGD local steps need comm mode "
                         f"'hierarchical', got {rc.comm.mode!r}")
    if site_groups is not None:
        total = sorted(p for g in site_groups for p in g)
        if mesh.pod == 1:
            site_groups = None          # single pod: nothing to group
        elif total != list(range(mesh.pod)):
            raise ValueError(f"site_groups {site_groups} must tile the pod "
                             f"axis of size {mesh.pod}")
    dev = resolve_device(mesh.device)
    tp = TensorParallel.of(mesh)
    if tp is not None:
        _refuse_on_model_axis(rc, route=route, site_groups=site_groups,
                              local_only=local_only)
    model = build_model(rc.model, tp)
    defs = model.param_defs()
    data_size = mesh.data
    zero = bool(rc.train.zero1 and rc.comm.mode == "hierarchical"
                and data_size > 1)
    dims = tree_fsdp_dims(defs, data_size, mesh.model)
    dims_or_none = dims if zero else tree_map(lambda d: None, dims)
    dp = dp_axes_of(mesh)
    dp_group = mesh.group_of(dp)
    tp_dims = tree_tp_dims(defs, mesh.model) if tp is not None else None
    # the reference plans the chunks of the whole leaves unless its sync runs
    # in its manual {"model"} shard_map (ZeRO with a wire codec)
    tp_view = None
    if tp is not None and not (zero and rc.comm.compress != "none"):
        tp_view = TPView(tuple(flatten(tp_dims)[0]), tp.size, tp.index, tp.group)

    path = WidePath(axis="pod", comm=rc.comm, link=INTERPOD, name="train")
    if route is not None:
        path = path.with_hops(route.as_hops(bottleneck_comm=rc.comm))
    tc = rc.train
    m_micro = max(1, tc.microbatches)
    shard = data_size if zero else 1
    pod_world = mesh.pod
    window = modeled_compute_window(rc.model, rc.shape, n_chips=mesh.n_ranks,
                                    microbatches=m_micro)
    path = autotune_path(path, _param_bytes(defs) // shard, world=pod_world,
                         compute_window=window)

    # bucketed sync (core/buckets.py), under the reference's conditions:
    # flush mode (each bucket synced in the backward by a hook around its
    # layer range) needs the model's support and no wire codec; tail mode
    # (the post-backward sync bucket by bucket) otherwise
    bucketed = bool(path.bucket_bytes > 0 and rc.comm.mode == "hierarchical"
                    and zero and not local_only)
    use_flush = bool(bucketed and rc.comm.compress == "none"
                     and "flush_segments" in inspect.signature(model.loss).parameters)
    stacked_tree = {k: tree_map(lambda pd: k == "blocks", v)
                    for k, v in defs.items()}
    plan = stacked_flags = None
    if bucketed:
        eff_leaves, eff_dims = _eff_grad_leaves(defs, dims, shard)
        raw_flags = flatten(stacked_tree)[0]
        stacked_flags = (raw_flags if use_flush
                         else bk.bucketable_flags(eff_leaves, raw_flags, eff_dims))
        plan = bk.plan_buckets(eff_leaves, stacked_flags, path.bucket_bytes)
        if not plan.layer_buckets:
            bucketed = use_flush = False
            plan = stacked_flags = None
    replan = None
    if rc.comm.mode != "flat" and not local_only:
        replan = functools.partial(_note_path_plan, defs, dims, path, shard,
                                   pod_world, stacked_flags=stacked_flags,
                                   window=window, m_micro=m_micro)
        replan()
    inpod = inpod_stats()
    gather_layer, gather_top = _make_gather(defs, dims, zero, mesh.data_group,
                                            inpod)
    dp_world = mesh.pod * mesh.data
    # local SGD: the gradient mean is over one site's ranks (the sites'
    # models diverge between delta syncs by design)
    sync_world = dp_world
    if local_only and site_groups is not None:
        sync_world = data_size * len(site_groups[0])
    # this step's sync record: seconds, the chunk log, each bucket's seconds
    cur: dict = {}

    @contextmanager
    def record(bucket=None, total=True):
        """Time a sync into the step's record (its sync_s unless not
        `total`, and the seconds of `bucket`) and give it a chunk log that
        lands in the step's, tagged with `bucket`."""
        log: list = []
        acc = {"sync_s": 0.0, "sync_n": 0}
        with _timed(acc, "sync", dev):
            yield log
        if total:
            cur["sync_s"] += acc["sync_s"]
        if bucket is not None:
            cur["bucket_s"][bucket] = cur["bucket_s"].get(bucket, 0.0) + acc["sync_s"]
            log = [{**c, "bucket": bucket} for c in log]
        cur["log"] += log

    flush_segments = (_make_flush_segments(defs, dims, path, plan, mesh, shard,
                                           record, site_groups)
                      if use_flush else None)
    rest_keys = [k for k in defs if k != "blocks"]

    def grad_fn(params, mb):
        leaves, td = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        kw = {} if flush_segments is None else {"flush_segments": flush_segments}
        loss, metrics = model.loss(gather_top(unflatten(td, ps)), mb,
                                   gather=gather_layer, **kw)
        grads = torch.autograd.grad(loss, ps)
        # f32 gradients from here on, as in the reference: f32 accumulation
        # and an f32 wire for every comm mode
        return (loss.detach(), _detached(metrics)), unflatten(
            td, [g.float() for g in grads])

    def psum_replicated(grads, dims_):
        # the shards' in-pod reduction ran in the backward; the replicated
        # leaves still need theirs
        return map_with_dims(lambda g, d: psum_group(g, mesh.data_group)
                             if d is None else g, grads, dims_)

    def local_sync(grads):
        # local SGD: the cross-pod stage stays inside the site (LAN only);
        # the WAN exchange is the K-step delta sync
        if zero:
            pods = (mesh.pod_group if site_groups is None
                    else mesh.site_group([list(g) for g in site_groups]))
            return tree_map(lambda g: psum_group(g, pods),
                            psum_replicated(grads, dims))
        return local_site_allreduce(grads, path, mesh, dims,
                                    site_groups=site_groups)

    def sync(grads):
        if local_only:
            with record():
                return local_sync(grads)
        if use_flush:
            # the blocks were synced in the backward by the flush hooks;
            # the rest bucket (embedding, final norm) is left
            rest = {k: grads[k] for k in rest_keys}
            rest_dims = {k: dims[k] for k in rest_keys}
            i = len(plan.layer_buckets)
            with record(i) as log:
                rest = streamed_psum(psum_replicated(rest, rest_dims), path,
                                     mesh, dims=rest_dims, log=log,
                                     site_groups=site_groups,
                                     tel_key=f"{path.key}/bkt{i}")
            return {**rest, "blocks": grads["blocks"]}
        if bucketed:
            with record() as log:
                return bk.bucketed_sync(
                    psum_replicated(grads, dims), path, mesh,
                    stacked=stacked_tree, dims=dims, site_groups=site_groups,
                    log=log, timer=lambda i: record(i, total=False))
        with record() as log:
            if zero:   # only the 1/D shards cross the pod axis
                return streamed_psum(psum_replicated(grads, dims), path, mesh,
                                     dims=dims, site_groups=site_groups,
                                     log=log, tp_view=tp_view)
            return wide_allreduce(grads, path, mesh, dims=dims,
                                  site_groups=site_groups, log=log,
                                  tp_view=tp_view)

    def fn(state: dict, batch: dict):
        params = state["params"]
        mbs = split_microbatches(batch, m_micro)
        cur.update(sync_s=0.0, log=[], bucket_s={})
        inpod.update(inpod_stats())
        loss, metrics, grads = accum_grads(grad_fn, params, mbs, sync=sync,
                                           overlap=m_micro > 1)
        grads = tree_map(lambda g: g.div_(sync_world), grads)
        lr = lr_at(state["opt"]["step"], tc, device=dev)
        # the step donates its state, as the reference's jit does: AdamW
        # writes the new moments into the old ones
        new_params, new_opt, stats = adamw_update(
            grads, state["opt"], params, tc, lr, dims=dims_or_none,
            group=dp_group if zero else None, buckets=plan,
            stacked=stacked_flags, tp_dims=tp_dims,
            tp_group=None if tp is None else tp.group)
        if mesh.world_group is not None:
            lh = loss.detach().float().reshape(1).cpu()
            loss = (psum_group(lh, mesh.world_group) / dp_world).reshape(()).to(dev)
        log = cur["log"]
        out = {"loss": loss, "lr": lr, **stats,
               "aux_loss": metrics.get("aux_loss", torch.zeros((), device=dev)),
               "sync_s": cur["sync_s"], "chunks": log,
               "wire_bytes": sum(c["wire_bytes"] for c in log),
               "sent_bytes": sum(c["sent_bytes"] for c in log), **inpod,
               "bucket_mode": ("flush" if use_flush else "tail") if bucketed else None,
               "buckets": [] if plan is None else _bucket_rows(
                   plan, log, cur["bucket_s"])}
        return {"params": new_params, "opt": new_opt}, out

    return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                      device=dev, mesh=mesh, dims=dims if zero else None,
                      zero=zero, bucket_plan=plan, replan=replan,
                      tp_dims=tp_dims)


def _refuse_on_model_axis(rc: RunConfig, *, route=None, site_groups=None,
                          local_only: bool = False) -> None:
    """Raise, naming ROADMAP.md's item, for what a model axis does not run
    yet in the training step."""
    what = None
    if rc.comm.bucket_mb > 0:
        what = f"bucket_mb = {rc.comm.bucket_mb} (the bucketed sync)"
    elif rc.comm.algo != "psum":
        what = f"algo = {rc.comm.algo!r}"
    elif site_groups is not None:
        what = "site groups"
    elif route is not None:
        what = "a route"
    elif local_only:
        what = "local SGD"
    if what is not None:
        raise queued(f"{what} over model ranks", TP_ITEM)


def build_delta_sync(rc: RunConfig, mesh, bundle: StepBundle, *,
                     site_groups, member_pods, member_gateways):
    """Local SGD's cross-site reconciliation for one membership epoch:
    ``fn(params, anchor) -> params`` on this rank's parameters (under ZeRO
    its shards), :func:`repro_torch.core.localsgd.delta_sync` over
    `bundle`'s path with the stored state's scatter dims.  None when there
    is nothing to reconcile (one pod, no site groups, or fewer than two
    member sites), as the reference's.  The Trainer builds one per epoch:
    the members are constants of it.  `rc` is the reference's argument;
    the path's knobs come from `bundle`."""
    from repro_torch.core.localsgd import delta_sync
    del rc
    if (mesh is None or mesh.pod_group is None or site_groups is None
            or len(member_gateways) < 2):
        return None
    groups = [list(g) for g in site_groups]
    pods, gws = list(member_pods), list(member_gateways)

    def fn(params, anchor):
        return delta_sync(params, anchor, bundle.path, mesh, dims=bundle.dims,
                          site_groups=groups, member_pods=pods,
                          member_gateways=gws)
    return fn


def build_catchup(mesh, bundle: StepBundle, *, source_pod: int, target_pods):
    """A rejoined site's catch-up: ``fn(params) -> params`` cloning
    `source_pod`'s parameters (a surviving gateway) onto `target_pods`
    (:func:`repro_torch.core.localsgd.catchup`); the other pods' pass
    through untouched.  None with one pod or no target."""
    from repro_torch.core.localsgd import catchup
    del bundle
    if mesh is None or mesh.pod_group is None or not target_pods:
        return None
    targets = list(target_pods)

    def fn(params):
        return catchup(params, mesh, source_pod=source_pod, target_pods=targets)
    return fn


def build_serve_step(rc: RunConfig, kind: Optional[str] = None, *,
                     device="cuda", mesh=None) -> StepBundle:
    """kind: "decode" (one token per row against a ``(B, seq_len)`` cache:
    ``fn(params, cache, pos, tokens) -> (logits, cache)``, the cache updated
    in place; the audio family's cache holds ``xk``/``xv`` too) or
    "prefill" (``fn(params, batch) -> (logits, cache)``, the batch
    ``{"tokens": (B, S)}`` with the family's stub inputs as the JAX
    package's batch template has them: ``patch_embeds`` (B, vision_tokens,
    d) for the vlm family, ``source_frames`` (B, source_len, d) for the
    audio family).

    `mesh` (the reference's argument; None: one device) with a model axis
    serves with tensor and expert parallelism: the parameters are each
    rank's TP shards (``bundle.tp_dims``; un-ZeRO'd while the TP shard is
    under 8 GiB, as the reference keeps them), the cache holds the rank's
    K/V heads (the reference's ``cache_spec``: kv_heads over ``model``), the
    batch is whole on every model rank and so are the logits.  A mesh's
    device is the step's.  On a mesh of more than one data-parallel rank,
    a seq-sharded cache (K/V heads that do not divide over the model ranks)
    and a TP shard over 8 GiB with ZeRO raise, naming ROADMAP.md's item."""
    kind = kind or rc.shape.kind
    tp = TensorParallel.of(mesh)
    if mesh is not None:
        device = mesh.device
        if mesh.pod * mesh.data > 1:
            raise queued(f"serving over {mesh.pod * mesh.data} data-parallel "
                         f"ranks", TP_ITEM)
    if tp is not None:
        shard_bytes = 2 * rc.model.param_count() // tp.size
        if shard_bytes > 8 * 2**30 and rc.train.zero1 and mesh.data > 1:
            raise queued("ZeRO-scattered serving parameters", TP_ITEM)
        kv = max(rc.model.num_kv_heads, 1)
        if rc.model.num_kv_heads and kv % tp.size:
            raise queued(f"a seq-sharded cache ({kv} K/V heads over "
                         f"{tp.size} model ranks)", TP_ITEM)
    dev = resolve_device(device)
    model = build_model(rc.model, tp)
    defs = model.param_defs()
    tp_dims = tree_tp_dims(defs, tp.size) if tp is not None else None
    path = WidePath(axis="pod", comm=rc.comm, name="serve")
    if kind == "decode":
        fn = torch.inference_mode()(model.decode_step)
        return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                          device=dev, mesh=mesh, tp_dims=tp_dims,
                          cache_defs=model.cache_defs(rc.shape.global_batch,
                                                      rc.shape.seq_len))
    if kind != "prefill":
        raise ValueError(f"serve step kind must be 'decode' or 'prefill', "
                         f"got {kind!r}")
    fn = torch.inference_mode()(model.prefill)
    return StepBundle(fn=fn, model=model, param_defs=defs, path=path,
                      device=dev, mesh=mesh, tp_dims=tp_dims)
