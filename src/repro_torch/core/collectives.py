"""Wide-area collectives: the paper's transfer engine on ``torch.distributed``
process groups.

The port of the JAX package's ``core/collectives.py``.
The axes of the mesh (:class:`repro_torch.launch.mesh.PodMesh`) are process
groups: the pod group over this data index's pod ranks (the WAN axis), the
data group over this pod's ranks, and the world.  Each WidePath stream is a
process group of its own over the pod group's ranks (the JAX package's
independent chains of chunk collectives), created once per mesh.

Modes (``CommConfig.mode``):
  flat          one all-reduce over the world per leaf, unchunked: the
                single-stream baseline.
  hierarchical  in-pod reduce-scatter -> streamed/chunked cross-pod psum on
                the 1/D shards -> in-pod all-gather; with one data rank per
                pod the in-pod stages are the identity.
  gateway       in-pod all-reduce, the cross-pod psum carried by data rank
                0's values alone (the other data ranks run it on zeros, as
                the reference does), then an in-pod sum of the gateway-only
                values: the user-space Forwarder, faithfully inefficient.

The in-pod stages (:func:`all_gather_dim`, :func:`reduce_scatter_dim`,
:func:`psum_group`) cross through host copies, as the pod groups' do
(``core/compress.py``), and sum in rank order: every rank of a group gets
the same bits, and a two-way sum is the reference's bit for bit.

Within the cross-pod stage each chunk's all-reduce is the algorithm
``CommConfig.algo`` selects: "psum" is one collective per chunk (gather-based
when compressed: per-pod wire bytes grow linearly in pod count), "ring" and
"ring2" the bandwidth-optimal point-to-point rings of
:mod:`repro_torch.core.ring` (int8 requantized per hop; ring2 bidirectional).
With ``site_groups`` the stage is site-hierarchical
(:func:`site_allreduce`): the pods of a site sum first over their site's
group, then only the site gateways' sums cross the WAN.

A multi-hop path (a Forwarder route, ``WidePath.hops``) syncs with the
bottleneck hop's knobs and notes a traffic plan for every hop
(:func:`_note_hop_plans`), as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import compress as comp
from repro_torch.core import ring as rg
from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.path import WidePath
from repro_torch.core.ring import ALGOS, wire_bytes_per_pod
from repro_torch.core.tree import flatten, unflatten

# ROADMAP.md queue A's item for what a model axis does not run yet
TP_ITEM = "tensor parallelism and the production meshes"


def queued(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue A, {item!r})")


@dataclass(frozen=True)
class TPView:
    """The leaves of a sync as the JAX package's GSPMD sees them on a mesh
    with a model axis: leaf i is block `index` of `size` equal blocks of a
    whole leaf along ``dims[i]`` (None: the leaf is whole on every model
    rank).  The reference then plans its chunks on the whole leaves, and
    each device moves its part of each chunk; a sync given a view does the
    same (:func:`streamed_psum`).  `group` is the model group."""
    dims: tuple
    size: int
    index: int
    group: object

    def whole(self, leaves: list) -> list:
        """``meta`` tensors of the whole leaves' shapes, f32."""
        out = []
        for x, t in zip(leaves, self.dims):
            shape = list(x.shape)
            if t is not None:
                shape[t] *= self.size
            out.append(torch.empty(shape, dtype=torch.float32, device="meta"))
        return out

    def part(self, c: st.Chunk, x: torch.Tensor) -> Optional[st.Chunk]:
        """This rank's part of chunk `c` of a whole leaf, as a chunk of its
        block `x` (`c` itself where the leaf is whole on every model rank),
        or None when it holds none of it."""
        t = self.dims[c.leaf]
        if t is None or x.dim() == 0:
            return c
        start, size = c.start, c.size
        if c.dim == t:
            n = x.shape[t]
            lo = max(c.start, self.index * n)
            hi = min(c.start + c.size, (self.index + 1) * n)
            if hi <= lo:
                return None
            start, size = lo - self.index * n, hi - lo
        nbytes = (x.numel() // x.shape[c.dim]) * size * x.element_size()
        return replace(c, start=start, size=size, nbytes=nbytes)


def streamed_psum(tree, path: WidePath, mesh, dims=None, site_groups=None,
                  tel_key=None, subgroup=None, chunks=None, log=None,
                  tp_view: Optional[TPView] = None):
    """Chunked, streamed, paced psum of a tree over the pod axis of `mesh`.

    MPW_Send/Recv semantics for an all-reduce payload: the payload is split
    into chunks (MPW_setChunkSize), the chunks are LPT-balanced over
    `path.streams` channels, each channel a process group of its own, and
    pacing (MPW_setPacingRate) lets only ``ceil(streams * pacing)`` channels
    run at once.  Every chunk's collective is issued with ``async_op=True``
    in stream order; a wave is waited for before the next one starts.  With
    ``algo="ring"``/``"ring2"`` each chunk is a ring all-reduce
    (:func:`repro_torch.core.ring.allreduce_steps`) on its stream's group,
    and the rings of a wave advance hop by hop together.  The traffic plan is
    noted in telemetry as the JAX package notes it.

    With `site_groups` (lists of pod indices, one per site, from
    ``Topology.pod_groups``) the sync is :func:`site_allreduce`.
    `subgroup` (pod indices: the site gateways) scopes the exchange: a ring
    runs among its members only (a rank outside posts nothing, sends 0
    bytes and keeps its values, which the caller masks), a psum still runs
    over the whole pod group on values the caller masked; either way the
    modeled wire is the members' ring averaged over the pod axis, as only
    they carry WAN traffic.

    `chunks` overrides the planner.  `log`, a list, receives one dict per
    chunk: leaf, dim, start, size, stream, payload_bytes (f32 bytes of the
    chunk), wire_bytes (the modeled per-pod link bytes of the chunk that was
    sent, ``wire_bytes_per_pod`` of its bytes under `algo`) and sent_bytes
    (what this rank handed to the group, summed over a ring's hops: int8
    payload plus scales and block padding, or bf16 / f32 bytes).  With one
    pod (no pod group) the tree is returned as it is.

    `tp_view` (a :class:`TPView`) plans and notes the chunks of the whole
    leaves, as the reference does when the model axis is GSPMD's: each rank
    reduces its part of each chunk, and its log's bytes are its part's (the
    model ranks' logs sum to the plan's).  A chunk cut along a leaf's TP dim
    with a wire codec is quantized whole, as GSPMD quantizes it: the model
    ranks gather that leaf, reduce the whole chunk and keep their part.
    Only the psum algorithm takes a view."""
    algo = path.comm.algo
    if algo not in ALGOS:
        raise ValueError(f"unknown comm algo {algo!r}; have {ALGOS}")
    if mesh is None or mesh.pod_group is None:
        return tree   # axis absent (single pod): nothing to cross
    if site_groups is not None:
        return site_allreduce(tree, path, mesh, site_groups, dims=dims,
                              chunks=chunks, tel_key=tel_key, log=log)
    leaves, td = flatten(tree)
    dim_list = st.normalize_dims(leaves, dims)
    if tp_view is not None and algo != "psum":
        raise queued(f"the {algo!r} algorithm over model ranks", TP_ITEM)
    planned = leaves if tp_view is None else tp_view.whole(leaves)
    if chunks is None:
        chunks = st.plan_chunks(planned, dim_list, path.chunk_bytes)
    buckets = st.assign_streams(chunks, path.streams)
    world = mesh.pod
    members = [int(p) for p in subgroup] if subgroup else None
    eff_world = len(members) if members else world
    compress = path.comm.compress
    # only the members carry WAN traffic: their ring, averaged over the axis
    share = eff_world / world
    wire = wire_bytes_per_pod(sum(c.nbytes for c in chunks), eff_world,
                              algo=algo, compress=compress) * share
    tel.note_plan(tel_key or path.key, **st.plan_summary(
        chunks, buckets, path.streams, path.chunk_bytes, path.comm.pacing,
        algo=algo, world=eff_world, compress=compress,
        wire_bytes=int(round(wire))))
    if path.hops:
        _note_hop_plans(path, leaves, dim_list)
    # a rank outside a ring's subgroup posts nothing
    idle = algo != "psum" and members is not None and mesh.pod_index not in members

    # pacing: only ceil(streams * pacing) streams in flight per wave
    pace = max(0.0, min(1.0, float(path.comm.pacing)))
    per_wave = max(1, int(round(len(buckets) * pace))) if buckets else 1
    groups = mesh.stream_groups(len(buckets))

    done: dict[int, list] = {i: [] for i in range(len(leaves))}
    if algo == "psum":
        view = tp_view or TPView((None,) * len(leaves), 1, 0, None)
        _psum_waves(leaves, buckets, per_wave, groups, view, compress,
                    eff_world, share, done, log)
    else:
        for w0 in range(0, len(buckets), per_wave):
            wave = [(c, s, st.slice_chunk(leaves[c.leaf], c))
                    for s in range(w0, min(w0 + per_wave, len(buckets)))
                    for c in buckets[s]]
            if idle:
                landed = [(x, 0) for _, _, x in wave]
            else:
                landed = rg.drive(rg.lockstep([
                    rg.allreduce_steps(x, c.dim, groups[s], compress=compress,
                                       bidirectional=algo == "ring2", tag=2 * k,
                                       members=members)
                    for k, (c, s, x) in enumerate(wave)]))
            # the wave has landed before the next one starts
            for (c, s, x), (r, sent) in zip(wave, landed):
                done[c.leaf].append((c, r))
                if log is not None:
                    log.append({"leaf": c.leaf, "dim": c.dim, "start": c.start,
                                "size": c.size, "stream": s,
                                "payload_bytes": c.nbytes,
                                "wire_bytes": wire_bytes_per_pod(
                                    x.numel() * x.element_size(), eff_world,
                                    algo=algo, compress=compress) * share,
                                "sent_bytes": sent})
        # the last wave's lists hold its chunks' results: let them go, so
        # that stitching gives each chunk's memory back as it is placed
        wave = landed = None
    out = [st.stitch_leaf(leaf, done[i]) if done[i] else leaf
           for i, leaf in enumerate(leaves)]
    return unflatten(td, out)


def _psum_waves(leaves, buckets, per_wave, groups, view: TPView, compress,
                eff_world, share, done, log) -> None:
    """:func:`streamed_psum`'s waves with the psum algorithm: each chunk's
    part that this rank holds (`view`; the whole chunk without a model
    axis) reduced over its stream's group, the results appended to `done`
    and noted in `log`."""
    whole: dict[int, torch.Tensor] = {}    # leaves gathered over the model group

    def source(c):
        """(this rank's part of `c`, the tensor it reduces, whether that is
        the whole chunk gathered over the model group)."""
        x = leaves[c.leaf]
        part = view.part(c, x)
        if part is None:
            return None, None, False
        if compress == "none" or view.dims[c.leaf] != c.dim:
            return part, st.slice_chunk(x, part), False
        if c.leaf not in whole:
            whole[c.leaf] = all_gather_dim(x.contiguous(), c.dim, view.group)
        return part, st.slice_chunk(whole[c.leaf], c), True

    for w0 in range(0, len(buckets), per_wave):
        wave = [(c, s, *source(c))
                for s in range(w0, min(w0 + per_wave, len(buckets)))
                for c in buckets[s]]
        issued = [None if x is None else
                  comp.reduce_start(x, c.dim, groups[s], compress)
                  for c, s, _, x, _ in wave]
        # the wave has landed before the next one starts
        for (c, s, part, x, full), p in zip(wave, issued):
            sent = nb = 0
            if p is not None:
                r, sent = p.finish(), p.sent_bytes
                nb = part.nbytes if full else x.numel() * x.element_size()
                if full:     # this rank's rows of the whole chunk
                    r = r.narrow(c.dim, part.start + view.index
                                 * leaves[c.leaf].shape[c.dim] - c.start, part.size)
                done[c.leaf].append((part, r))
            if log is not None:
                log.append({"leaf": c.leaf, "dim": c.dim, "start": c.start,
                            "size": c.size, "stream": s,
                            "payload_bytes": 0 if part is None else part.nbytes,
                            "wire_bytes": wire_bytes_per_pod(
                                nb, eff_world, algo="psum", compress=compress) * share,
                            "sent_bytes": sent})


def site_allreduce(tree, path: WidePath, mesh, site_groups, dims=None,
                   chunks=None, tel_key=None, log=None):
    """Topology-aware hierarchical psum over the pod axis: reduce intra-site
    before crossing the slow hop, as the reference's ``site_allreduce``.

    `site_groups` partitions the pod indices into sites (from
    ``Topology.pod_groups``).  Three stages:

      1. **intra-site reduce**: the rank-order sum over this rank's site
         group (``PodMesh.site_group``; two pods a site sum as the
         reference does, bit for bit);
      2. **gateway mask**: only the first pod of each site keeps its value;
      3. **cross-site exchange** with the path's knobs.  ``algo="ring"`` /
         ``"ring2"``: the chunked, streamed ring among the gateways only
         (the other pods post nothing), then the masked intra-site sum as
         the broadcast.  ``algo="psum"``: the chunked, streamed psum of the
         gateway-masked values over the whole pod group, which doubles as
         the in-site broadcast.

    The stages' plans land under ``{key}/intra`` and ``{key}/wan``; the
    ``/wan`` wire bytes are the gateways' ring averaged over the axis for
    both algorithms (S of P pods carry the WAN bytes).  `chunks` plans the
    WAN stage; `log` takes its chunks (:func:`streamed_psum`)."""
    groups = [list(g) for g in site_groups]
    if len({len(g) for g in groups}) > 1:
        raise ValueError(
            f"site_allreduce needs equal pods per site, got sizes "
            f"{[len(g) for g in groups]}; give every site the same n_pods "
            f"(routing/forwarding has no such constraint)")
    if mesh is None or mesh.pod_group is None:
        return tree
    leaves, td = flatten(tree)
    dim_list = st.normalize_dims(leaves, dims)
    key = tel_key or path.key
    site = mesh.site_group(groups)
    reduced = [psum_group(l, site) for l in leaves]
    intra = st.plan_chunks(leaves, dim_list, path.chunk_bytes)
    tel.note_plan(f"{key}/intra", **st.plan_summary(
        intra, st.assign_streams(intra, 1), 1, path.chunk_bytes, 1.0,
        world=len(groups[0])))
    if len(groups) == 1:
        return unflatten(td, reduced)          # one site: no WAN hop
    gateways = [g[0] for g in groups]
    is_gw = mesh.pod_index in gateways
    mask = lambda l: l if is_gw else torch.zeros_like(l)
    # a route notes its per-hop plans instead of a /wan one
    wan_key = None if path.hops else f"{key}/wan"
    if path.comm.algo in ("ring", "ring2"):
        exchanged = streamed_psum(unflatten(td, reduced), path, mesh,
                                  dims=dim_list, tel_key=wan_key,
                                  subgroup=gateways, chunks=chunks, log=log)
        return unflatten(td, [psum_group(mask(l), site)
                              for l in flatten(exchanged)[0]])
    return streamed_psum(unflatten(td, [mask(l) for l in reduced]), path,
                         mesh, dims=dim_list, tel_key=wan_key,
                         subgroup=gateways, chunks=chunks, log=log)


def _note_hop_plans(path: WidePath, leaves, dim_list) -> None:
    """Record a per-hop traffic plan for a multi-hop path: the same payload
    crosses every hop, but each hop chunks it with its own knobs."""
    for i, hop in enumerate(path.route):
        chunks = st.plan_chunks(leaves, dim_list, hop.chunk_bytes)
        buckets = st.assign_streams(chunks, hop.streams)
        tel.note_plan(path.hop_key(i), **st.plan_summary(
            chunks, buckets, hop.streams, hop.chunk_bytes, hop.comm.pacing,
            algo="shift"))


# ---------------------------------------------------------------------------
# in-pod stages
# ---------------------------------------------------------------------------

def _gathered(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` over `group`, stacked in rank order on x's device."""
    out, work = comp._gather(x, group)
    work.wait()
    return out.to(x.device)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather of `x` over `group` along `dim` (rank r's block at
    position r): ``jax.lax.all_gather(..., tiled=True)``."""
    if group is None:
        return x
    return torch.cat(_gathered(x, group).unbind(0), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled reduce-scatter of `x` over `group` along `dim`: this rank's
    block of the sum, ``jax.lax.psum_scatter(..., tiled=True)``.  One
    all-to-all moves each block to its rank (gloo has it on every torch the
    port runs on), and the blocks are summed in rank order in x's dtype."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter_dim: dim {dim} of shape "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    send = comp._host(torch.stack(x.chunk(n, dim=dim), 0))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return comp._rank_sum(recv.to(x.device))


def psum_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` in rank order, in x's dtype: the same bits
    on every rank."""
    if group is None:
        return x
    return comp._rank_sum(_gathered(x, group))


def flat_allreduce(tree, mesh):
    """One unchunked all-reduce per leaf over every rank of the mesh."""
    group = None if mesh is None else mesh.world_group
    if group is None:
        return tree
    leaves, td = flatten(tree)
    pending = [comp.psum_start(x, group) for x in leaves]
    return unflatten(td, [p.finish() for p in pending])


def _around_pod(tree, mesh, dims, keep_scattered: bool, cross):
    """RS(data) -> cross(scattered leaves, their dims) -> AG(data): the
    in-pod stages around a cross-pod one.  A leaf whose dim is None, or
    does not divide over the data ranks, is psummed over data instead; with
    `keep_scattered` the final all-gather is skipped."""
    group = None if mesh is None else mesh.data_group
    leaves, td = flatten(tree)
    dim_list = flatten(dims)[0] if dims is not None else [None] * len(leaves)
    n = mesh.data if mesh is not None else 1

    def rs(g, d):
        if group is None:
            return g
        if d is None or g.dim() == 0 or g.shape[d] % n:
            return psum_group(g, group)
        return reduce_scatter_dim(g, d, group)

    synced = cross([rs(g, d) for g, d in zip(leaves, dim_list)], dim_list)
    if keep_scattered or group is None:
        return unflatten(td, synced)
    return unflatten(td, [all_gather_dim(g, d, group) if g.shape != g0.shape
                          else g for g, g0, d in zip(synced, leaves, dim_list)])


def hierarchical_allreduce(tree, path: WidePath, mesh, dims,
                           keep_scattered: bool = False, site_groups=None,
                           log=None, tp_view: Optional[TPView] = None):
    """RS(data) -> streamed cross-pod psum -> AG(data).

    `dims` is the per-leaf scatter-dim tree (``param.tree_fsdp_dims``).  A
    leaf whose dim is None, or does not divide over the data ranks, is
    psummed over data instead.  With `keep_scattered` the final all-gather is
    skipped (ZeRO: the optimizer updates shards).  `tp_view`: see
    :func:`streamed_psum`."""
    return _around_pod(tree, mesh, dims, keep_scattered, lambda scat, dim_list:
                       streamed_psum(scat, path, mesh, dims=dim_list,
                                     site_groups=site_groups, log=log,
                                     tp_view=tp_view))


def local_site_allreduce(tree, path: WidePath, mesh, dims,
                         keep_scattered: bool = False, site_groups=None):
    """The local-SGD step sync: RS(data) -> *intra-site* pod sum -> AG(data),
    as :func:`hierarchical_allreduce` but the cross-pod stage never leaves
    the site: each site's pods sum in rank order over their site group, so
    the sites diverge until a delta sync merges them.  Without
    `site_groups` the whole pod axis is one site (a full sync, summed in
    rank order over the pod group).  No chunks and no WAN bytes."""
    pods = None if mesh is None else mesh.pod_group
    if pods is not None and site_groups is not None:
        groups = [list(g) for g in site_groups]
        if len({len(g) for g in groups}) > 1:
            raise ValueError(
                f"local_site_allreduce needs equal pods per site, got sizes "
                f"{[len(g) for g in groups]}")
        pods = mesh.site_group(groups)
    return _around_pod(tree, mesh, dims, keep_scattered, lambda scat, _:
                       [psum_group(g, pods) for g in scat])


def gateway_allreduce(tree, path: WidePath, mesh, log=None,
                      tp_view: Optional[TPView] = None):
    """The user-space Forwarder: the pod's data rank 0 relays all WAN
    traffic.  In-pod all-reduce; the streamed cross-pod psum, which every
    data rank runs over its own pod group, the non-gateway ranks on zeros;
    then the in-pod sum of the gateway-only values (the in-pod broadcast)."""
    group = None if mesh is None else mesh.data_group
    leaves, td = flatten(tree)
    leaves = [psum_group(g, group) for g in leaves]
    if mesh is None or mesh.pod_group is None:
        return unflatten(td, leaves)
    if group is None:
        return streamed_psum(unflatten(td, leaves), path, mesh, log=log,
                             tp_view=tp_view)
    is_gw = mesh.data_index == 0
    masked = [g if is_gw else torch.zeros_like(g) for g in leaves]
    crossed = flatten(streamed_psum(unflatten(td, masked), path, mesh,
                                    log=log, tp_view=tp_view))[0]
    return unflatten(td, [psum_group(g if is_gw else torch.zeros_like(g), group)
                          for g in crossed])


def wide_allreduce(tree, path: WidePath, mesh, *, dims=None, site_groups=None,
                   log=None, tp_view: Optional[TPView] = None):
    """Dispatch on ``CommConfig.mode``: the one entry point the runtime uses."""
    mode = path.comm.mode
    if mode == "flat":
        return flat_allreduce(tree, mesh)
    if mode == "gateway":
        return gateway_allreduce(tree, path, mesh, log=log, tp_view=tp_view)
    if mode == "hierarchical":
        return hierarchical_allreduce(tree, path, mesh, dims,
                                      site_groups=site_groups, log=log,
                                      tp_view=tp_view)
    raise ValueError(f"unknown comm mode {mode!r}")


# ---------------------------------------------------------------------------
# the model axis: tensor and expert parallelism
# ---------------------------------------------------------------------------
#
# Megatron's conjugate pairs over a model group.  The model ranks compute the
# same loss, so the cotangent of a tensor that every rank holds whole is the
# same on every rank: a sum in the forward passes it through unchanged, and
# an identity whose outputs feed rank-local work sums their cotangents.  The
# sums run in rank order through host copies (:func:`psum_group`), so every
# rank gets the same bits.

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_group(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return psum_group(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Tiled all-gather along `dim` forward; the backward keeps this rank's
    block of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None


class _SplitToGroup(torch.autograd.Function):
    """This rank's block along `dim` forward; the backward all-gathers the
    blocks' cotangents."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"split: dim {dim} of shape {tuple(x.shape)} does "
                             f"not split over {n} ranks")
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=False)``
    over `group`: `x` is (n, ...) with block j bound for rank j; the result's
    block j is rank j's block bound for this rank.  Through a host copy (a
    pinned one from the card), as the in-pod stages."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"group's {dist.get_world_size(group)} ranks")
    send = comp._host(x)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, whose backward is the same exchange of the
    cotangents (the reverse all-to-all)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, whose gradient is summed over `group` (the input of column-parallel
    work, a replicated weight used on rank-local tokens); `x` without a
    group."""
    return x if group is None else _CopyToGroup.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` (the output of row-parallel work), whose
    gradient passes through; `x` without a group."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` joined along `dim` in rank order; its gradient is
    this rank's block.  `x` without a group."""
    return x if group is None else _GatherFromGroup.apply(x, dim, group)


def tp_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of `x` along `dim`; its gradient is gathered from
    every rank's.  `x` without a group."""
    return x if group is None else _SplitToGroup.apply(x, dim, group)


def tp_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`all_to_all`."""
    return _AllToAll.apply(x, group)


def tp_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `x` over `group`, not differentiated."""
    if group is None:
        return x.detach()
    return _gathered(x.detach().contiguous(), group).amax(0)
