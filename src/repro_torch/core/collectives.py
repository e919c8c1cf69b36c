"""Wide-area collectives: the paper's transfer engine on ``torch.distributed``
process groups.

The port of the JAX package's ``core/collectives.py`` for ``algo="psum"``.
The pod axis of the mesh (:class:`repro_torch.launch.mesh.PodMesh`) is a
process group over the pod ranks, and each WidePath stream is a process
group of its own over the same ranks (the JAX package's independent chains
of chunk collectives), created once per mesh.

Modes (``CommConfig.mode``):
  flat          one all-reduce over the pod group per leaf, unchunked: the
                single-stream baseline.
  hierarchical  in-pod reduce-scatter -> streamed/chunked cross-pod psum ->
                in-pod all-gather; with one data rank per pod the in-pod
                stages are the identity and this is :func:`streamed_psum`.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``algo="ring"``/``"ring2"``, ``site_groups``, ``subgroup``, multi-hop
paths, the gateway mode, and ``data > 1``.
"""
from __future__ import annotations

from repro_torch.core import compress as comp
from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.path import WidePath
from repro_torch.core.ring import wire_bytes_per_pod
from repro_torch.core.tree import flatten, unflatten

ALGOS = ("psum", "ring", "ring2")


def queued(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md queue A, {item!r})")


def streamed_psum(tree, path: WidePath, mesh, dims=None, site_groups=None,
                  tel_key=None, subgroup=None, chunks=None, log=None):
    """Chunked, streamed, paced psum of a tree over the pod axis of `mesh`.

    MPW_Send/Recv semantics for an all-reduce payload: the payload is split
    into chunks (MPW_setChunkSize), the chunks are LPT-balanced over
    `path.streams` channels, each channel a process group of its own, and
    pacing (MPW_setPacingRate) lets only ``ceil(streams * pacing)`` channels
    run at once.  Every chunk's collective is issued with ``async_op=True``
    in stream order; a wave is waited for before the next one starts.  The
    traffic plan is noted in telemetry as the JAX package notes it.

    `chunks` overrides the planner.  `log`, a list, receives one dict per
    chunk: leaf, dim, start, size, stream, payload_bytes (f32 bytes of the
    chunk), wire_bytes (the modeled per-pod link bytes of the chunk that was
    sent, ``wire_bytes_per_pod`` of its bytes) and sent_bytes (what this rank
    handed to the group: int8 payload plus scales and block padding, or
    bf16 / f32 bytes).  With one pod (no pod group) the tree is returned as
    it is."""
    algo = path.comm.algo
    if algo not in ALGOS:
        raise ValueError(f"unknown comm algo {algo!r}; have {ALGOS}")
    if algo != "psum":
        raise queued(f"algo={algo!r}", "ring and ring2 collectives")
    if site_groups is not None or subgroup:
        raise queued("site groups and gateway subgroups",
                     "gateway mode and site groups")
    if path.hops:
        raise queued("multi-hop paths (Forwarder routes)",
                     "facade, relays, files, checkpoints")
    if mesh is None or mesh.pod_group is None:
        return tree   # axis absent (single pod): nothing to cross
    leaves, td = flatten(tree)
    dim_list = st.normalize_dims(leaves, dims)
    if chunks is None:
        chunks = st.plan_chunks(leaves, dim_list, path.chunk_bytes)
    buckets = st.assign_streams(chunks, path.streams)
    world = mesh.pod
    compress = path.comm.compress
    wire = wire_bytes_per_pod(sum(c.nbytes for c in chunks), world,
                              algo=algo, compress=compress)
    tel.note_plan(tel_key or path.key, **st.plan_summary(
        chunks, buckets, path.streams, path.chunk_bytes, path.comm.pacing,
        algo=algo, world=world, compress=compress,
        wire_bytes=int(round(wire))))

    # pacing: only ceil(streams * pacing) streams in flight per wave
    pace = max(0.0, min(1.0, float(path.comm.pacing)))
    per_wave = max(1, int(round(len(buckets) * pace))) if buckets else 1
    groups = mesh.stream_groups(len(buckets))

    done: dict[int, list] = {i: [] for i in range(len(leaves))}
    for w0 in range(0, len(buckets), per_wave):
        issued = []
        for s in range(w0, min(w0 + per_wave, len(buckets))):
            for c in buckets[s]:
                x = st.slice_chunk(leaves[c.leaf], c)
                issued.append((c, s, x, comp.reduce_start(x, c.dim, groups[s],
                                                          compress)))
        for c, s, x, pending in issued:   # the wave lands before the next starts
            done[c.leaf].append((c, pending.finish()))
            if log is not None:
                log.append({"leaf": c.leaf, "dim": c.dim, "start": c.start,
                            "size": c.size, "stream": s,
                            "payload_bytes": c.nbytes,
                            "wire_bytes": wire_bytes_per_pod(
                                x.numel() * x.element_size(), world,
                                algo=algo, compress=compress),
                            "sent_bytes": pending.sent_bytes})

    out = [st.stitch_leaf(leaf, done[i]) if done[i] else leaf
           for i, leaf in enumerate(leaves)]
    return unflatten(td, out)


def flat_allreduce(tree, mesh):
    """One unchunked all-reduce per leaf over the pod group."""
    if mesh is None or mesh.pod_group is None:
        return tree
    leaves, td = flatten(tree)
    pending = [comp.psum_start(x, mesh.pod_group) for x in leaves]
    return unflatten(td, [p.finish() for p in pending])


def hierarchical_allreduce(tree, path: WidePath, mesh, dims, site_groups=None,
                           log=None):
    """RS(data) -> streamed cross-pod psum -> AG(data).  With one data rank
    per pod (the only layout ported) the in-pod stages are the identity."""
    if mesh is not None and mesh.data > 1:
        raise queued(f"data = {mesh.data} (in-pod reduce-scatter and ZeRO)",
                     "data > 1 with ZeRO and reduce-scatter")
    dim_list = flatten(dims)[0] if dims is not None else None
    return streamed_psum(tree, path, mesh, dims=dim_list,
                         site_groups=site_groups, log=log)


def gateway_allreduce(tree, path: WidePath, mesh):
    raise queued("the gateway (Forwarder) mode", "gateway mode and site groups")


def wide_allreduce(tree, path: WidePath, mesh, *, dims=None, site_groups=None,
                   log=None):
    """Dispatch on ``CommConfig.mode``: the one entry point the runtime uses."""
    mode = path.comm.mode
    if mode == "flat":
        return flat_allreduce(tree, mesh)
    if mode == "gateway":
        return gateway_allreduce(tree, path, mesh)
    if mode == "hierarchical":
        return hierarchical_allreduce(tree, path, mesh, dims,
                                      site_groups=site_groups, log=log)
    raise ValueError(f"unknown comm mode {mode!r}")
