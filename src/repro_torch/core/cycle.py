"""Point-to-point and relay primitives over the pod ring (MPW_Send/Recv
between endpoints, MPW_Cycle, MPW_Relay), plus the multi-hop Forwarder data
plane (:func:`forward`): the port of the JAX package's ``core/cycle.py``.

Pods form a ring over the pod group of a
:class:`repro_torch.launch.mesh.PodMesh`; a shift sends this rank's payload
to the pod ``shift`` places on and receives the one from ``shift`` places
back, as the reference's ``ppermute`` with the permutation
``[(i, (i + shift) % n)]`` does.  The payload is chunked with the path's (or
the hop's) knobs, the chunks balanced over the path's streams, each stream
one process group of the pod group's (``PodMesh.stream_groups``): one
``dist.batch_isend_irecv`` per chunk on its stream's group, the peers given
as global ranks, as ``core/ring.py``'s hops are.  Chunks of a stream go in
order; the streams' k-th chunks are in flight together.  The buffers are
pageable host memory, freed as each wave lands: a shift moves whole trees
(the facade's messages), and pinned buffers of every size it uses would
stay in PyTorch's pinned pool for the life of the process.

A multi-hop :class:`~repro_torch.core.path.WidePath` (a Forwarder route)
runs as one store-and-forward :func:`pod_shift` per hop, each with that
hop's own chunking and stream knobs and its own telemetry slot
(``path.hop_key(i)``).  With one pod (no pod group) every verb returns the
tree as it is, as the reference does where the pod axis is absent.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.path import WidePath
from repro_torch.core.tree import flatten, unflatten


class ShiftPending:
    """A posted shift: its gloo works and what ``finish()`` assembles.  The
    non-blocking exchange's token (``MPW.ISendRecv``): ``is_completed()``
    polls the works, ``finish()`` waits for them and returns the tree."""

    def __init__(self, works: list, pieces: list, stitch):
        self.works = works
        self._pieces = pieces
        self._stitch = stitch
        self._out = None

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def finish(self):
        if self._out is None:
            for w in self.works:
                w.wait()
            self._out = self._stitch(self._pieces)
        return self._out


def _peers(mesh, group, shift: int) -> tuple[int, int]:
    """Global ranks of the pod `shift` places on (dst) and back (src)."""
    n = mesh.pod
    me = mesh.pod_index
    return (dist.get_global_rank(group, (me + shift) % n),
            dist.get_global_rank(group, (me - shift) % n))


def _post(chunks: list, leaves: list, groups: list, mesh, shift: int):
    """Post one chunk each of `chunks` ((chunk, stream) pairs): send the
    chunk's host copy to the pod `shift` on and receive its twin from the
    pod `shift` back on the stream's group.  Returns (works, [(chunk, host
    receive buffer, device)])."""
    works, landed = [], []
    for k, (c, s) in enumerate(chunks):
        x = st.slice_chunk(leaves[c.leaf], c)
        send = x.detach().to("cpu", copy=True).contiguous()
        recv = torch.empty(send.shape, dtype=send.dtype)
        dst, src = _peers(mesh, groups[s], shift)
        works += dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer=dst, group=groups[s], tag=k),
            dist.P2POp(dist.irecv, recv, peer=src, group=groups[s], tag=k)])
        landed.append((c, recv, x.device))
    return works, landed


def _plan(leaves, dims, path: WidePath, mesh, chunk_bytes, streams, pacing,
          tel_key):
    dim_list = st.normalize_dims(leaves, dims)
    cb = chunk_bytes if chunk_bytes is not None else path.chunk_bytes
    ns = streams if streams is not None else path.streams
    pc = pacing if pacing is not None else path.comm.pacing
    chunks = st.plan_chunks(leaves, dim_list, cb)
    buckets = st.assign_streams(chunks, ns)
    tel.note_plan(tel_key or path.key,
                  **st.plan_summary(chunks, buckets, ns, cb, pc,
                                    algo="shift", world=mesh.pod))
    return buckets


def _stitcher(leaves, td):
    def stitch(pieces):
        done: dict[int, list] = {i: [] for i in range(len(leaves))}
        for c, recv, dev in pieces:
            done[c.leaf].append((c, recv.to(dev)))
        return unflatten(td, [st.stitch_leaf(l, done[i]) if done[i] else l
                              for i, l in enumerate(leaves)])
    return stitch


def _absent(mesh) -> bool:
    return mesh is None or mesh.pod_group is None


def pod_shift(tree, path: WidePath, mesh, shift: int = 1, dims=None,
              chunk_bytes: Optional[int] = None,
              streams: Optional[int] = None,
              tel_key: Optional[str] = None, pacing: Optional[float] = None):
    """Send the payload to the pod `shift` positions ahead on the ring,
    receive from the one behind (chunked over the path's streams).

    `dims` carries each leaf's scatter dim, as ``streamed_psum`` takes it;
    leaves without a stated dim are chunked along dim 0.  Multi-hop paths
    relay hop by hop (store-and-forward); `shift` then scales the whole
    route.  A shift of a multiple of the pod count is the identity, as the
    reference's permutation is."""
    if _absent(mesh):
        return tree
    if path.hops:
        out = tree
        for _ in range(max(1, abs(int(shift)))):
            out = forward(out, path, mesh, dims=dims, reverse=shift < 0)
        return out
    leaves, td = flatten(tree)
    buckets = _plan(leaves, dims, path, mesh, chunk_bytes, streams, pacing,
                    tel_key)
    if shift % mesh.pod == 0:
        return tree
    groups = mesh.stream_groups(len(buckets))
    pieces = []
    # the k-th chunk of every stream in flight together; a stream's chunks
    # in order; a wave's host buffers are freed before the next is posted
    for k in range(max((len(b) for b in buckets), default=0)):
        wave = [(b[k], s) for s, b in enumerate(buckets) if k < len(b)]
        works, landed = _post(wave, leaves, groups, mesh, shift)
        for w in works:
            w.wait()
        pieces += [(c, recv.to(dev), dev) for c, recv, dev in landed]
    return _stitcher(leaves, td)(pieces)


def pod_shift_start(tree, path: WidePath, mesh, shift: int = 1,
                    dims=None) -> ShiftPending:
    """Post a single-link shift without waiting: every chunk of every stream
    at once, each on its own tag.  ``finish()`` on the result waits and
    returns what :func:`pod_shift` returns."""
    if path.hops:
        raise ValueError(f"a non-blocking shift runs over one link; path "
                         f"{path.key!r} has {path.n_hops} hops")
    leaves, td = flatten(tree)
    if _absent(mesh):
        return ShiftPending([], [], lambda _: tree)
    buckets = _plan(leaves, dims, path, mesh, None, None, None, None)
    if shift % mesh.pod == 0:
        return ShiftPending([], [], lambda _: tree)
    groups = mesh.stream_groups(len(buckets))
    works, landed = _post([(c, s) for s, b in enumerate(buckets) for c in b],
                          leaves, groups, mesh, shift)
    return ShiftPending(works, landed, _stitcher(leaves, td))


def forward(tree, path: WidePath, mesh, dims=None, reverse: bool = False):
    """Store-and-forward relay along `path.route` (the Forwarder data plane).

    Each hop is an independent chunked transfer with the hop's own knobs:
    the relay holds the full message between hops, as the paper's Forwarder
    does with its receive/send buffer pair.  Per-hop traffic plans land in
    per-hop telemetry slots (`path.hop_key(i)`).  `reverse` runs the route
    back to front with negated shifts (the return direction)."""
    if _absent(mesh):
        return tree
    route = path.route
    order = range(len(route) - 1, -1, -1) if reverse else range(len(route))
    out = tree
    for i in order:
        hop = route[i]
        out = pod_shift(out, path.with_(hops=()), mesh,
                        -hop.shift if reverse else hop.shift, dims=dims,
                        chunk_bytes=hop.chunk_bytes, streams=hop.streams,
                        pacing=hop.comm.pacing, tel_key=path.hop_key(i))
    return out


def sendrecv(send_tree, path: WidePath, mesh, shift: int = 1, dims=None):
    """MPW_SendRecv: symmetric exchange with the ring neighbour.  Returns the
    payload received from the pod `shift` behind."""
    return pod_shift(send_tree, path, mesh, shift, dims=dims)


def cycle(recv_from_path: WidePath, send_on_path: WidePath, tree, mesh,
          dims=None):
    """MPW_Cycle: receive a buffer over one path, forward it over another:
    data arrives from the previous pod on path A and continues to the next
    pod on path B."""
    received = pod_shift(tree, recv_from_path, mesh, 1, dims=dims)
    return pod_shift(received, send_on_path, mesh, 1, dims=dims)


def relay(tree, path: WidePath, mesh, hops: int, dims=None):
    """MPW_Relay: sustained forwarding for `hops` ring steps.  A multi-hop
    path relays along its own route instead (its hop count governs)."""
    if path.hops:
        return forward(tree, path, mesh, dims=dims)
    out = tree
    for _ in range(max(1, hops)):
        out = pod_shift(out, path, mesh, 1, dims=dims)
    return out


def barrier(mesh, axes: Sequence[str] = ("pod", "data")) -> torch.Tensor:
    """MPW_Barrier: synchronize across the wide area; returns the number of
    ranks over `axes` as a 0-d f32 tensor on the mesh's device (the
    reference's scalar psum of ones)."""
    tok = torch.ones((), dtype=torch.float32)
    group = None if mesh is None else mesh.group_of(tuple(axes))
    if group is not None:
        tok = tok.reshape(1)
        dist.all_reduce(tok, group=group)
        tok = tok.reshape(())
    dev = torch.device("cpu") if mesh is None else mesh.device
    return tok.to(dev)
