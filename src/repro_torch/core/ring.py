"""Bandwidth-optimal ring collectives over a pod group: the port of the JAX
package's ``core/ring.py``.

The gather-based compressed all-reduce (``compress.compressed_psum_start``)
ships every pod's full chunk to every other pod: per-pod wire traffic grows
as ``(P-1) * n_wire``.  A ring reduce-scatter + all-gather moves only
``2 * (P-1)/P * n_wire`` per pod, in 2(P-1) point-to-point steps.

Compression is applied *per ring step*: the reduce-scatter requantizes the
running partial sum before every hop, so int8 (not f32) crosses the wire at
every hop; the all-gather quantizes each finished segment once at its owner
and forwards the identical int8 payload hop by hop, so every pod decodes the
same bytes.  Per hop the order is the reference's: the partial sum,
quantize, send, dequantize, then add the own segment.

Two algorithms:
  ring   unidirectional: one chain of 2(P-1) steps.
  ring2  bidirectional: the payload is halved and the halves circulate in
         opposite directions at once, two chains of 2(P-1) steps whose hops
         are posted together.

A hop is ``dist.batch_isend_irecv`` on the chunk's stream group (peers as
global ranks, ``dist.get_global_rank``), its buffers in host memory as gloo
takes them (pinned when the chunk is on the card); the codec's quantize and
dequantize run on the chunk's device.  A chain is a generator that posts a
hop, yields its works, and resumes once they have completed;
:func:`lockstep` advances many chains together (the halves of ``ring2``,
every chunk of a wave of :func:`repro_torch.core.collectives.streamed_psum`),
so their hops are in flight at once.

A subgroup ring (the site gateways' exchange) runs among the members only:
its peers are the members' global ranks in the same group (point-to-point
operations need no group of their own), and a rank outside the subgroup
posts nothing.
"""
from __future__ import annotations

from typing import Generator, Optional

import torch
import torch.distributed as dist

from repro_torch.core import compress as comp
from repro_torch.kernels import ops

QBLOCK = comp.QBLOCK

ALGOS = ("psum", "ring", "ring2")

# bytes per f32 element that actually cross the wire, per compress mode.
# int8 additionally ships one f32 scale per QBLOCK elements (+4/QBLOCK =
# +1.6% — a sideband the model below deliberately excludes, like headers).
WIRE_FACTOR = {"none": 1.0, "bf16": 0.5, "int8": 0.25}

# a chain: yields the works of each hop it posts, returns its result
Chain = Generator[list, None, object]


def wire_bytes_per_pod(payload_bytes: float, world: int, *,
                       algo: str = "psum", compress: str = "none") -> float:
    """Modeled per-pod link bytes to all-reduce `payload_bytes` (f32 bytes)
    over `world` pods.

      ring/ring2   2*(world-1)/world * wire   (bandwidth-optimal)
      psum+none    2*(world-1)/world * wire   (XLA lowers its own ring)
      psum+bf16/int8   (world-1) * wire       (gather-based: every pod
                                               receives world-1 remote
                                               shards — linear in P)
      shift        wire                       (one ppermute send/recv)
    """
    wire = float(payload_bytes) * WIRE_FACTOR.get(compress, 1.0)
    if algo == "shift":
        return wire
    if world <= 1:
        return 0.0
    if algo in ("ring", "ring2") or compress == "none":
        return 2.0 * (world - 1) / world * wire
    return (world - 1.0) * wire


# ---------------------------------------------------------------------------
# wire codecs: what one ring step actually ships
# ---------------------------------------------------------------------------

def _wire_block(m: int) -> int:
    """Quantization block for a segment-axis extent of m elements:
    min(QBLOCK, m), so short segment rows are their own block instead of
    being zero-padded to QBLOCK.  The block depends only on the segment
    extent along the scatter dim, which layer-bucket slicing never changes,
    so bucketed ring transfers stay bit-identical."""
    return max(1, min(QBLOCK, int(m)))


def _q_wire(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a segment to the int8 wire format: blocks run along the
    segment axis (dim 0, moved last and padded to the wire block), one block
    row per coordinate of the other dims."""
    y = seg.movedim(0, -1) if seg.dim() > 1 else seg
    block = _wire_block(seg.shape[0])
    pad = (-y.shape[-1]) % block
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
    return ops.quant_int8(y, block=block)


def _dq_wire(q: torch.Tensor, s: torch.Tensor, like: torch.Size) -> torch.Tensor:
    """The f32 segment of shape `like` from its int8 wire format."""
    n = like[0]
    y = ops.dequant_int8(q, s, block=_wire_block(n), dtype=torch.float32)
    if len(like) > 1:
        return y[..., :n].movedim(-1, 0)
    return y[:n]


def _recv_like(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=dev.type == "cuda")


class _Link:
    """One direction of a ring over `group`, or over its `members` (group
    ranks, in ring order) when given: this rank sends to the member `shift`
    positions on and receives from the one `shift` positions back.  `sent`
    counts the bytes this rank handed to the group."""

    def __init__(self, group, shift: int, tag: int, members=None):
        if members is None:
            members = range(dist.get_world_size(group))
        members = [int(m) for m in members]
        self.group = group
        self.world = len(members)
        self.pos = members.index(dist.get_rank(group))
        self.shift = shift
        self.tag = tag
        self.dst = dist.get_global_rank(
            group, members[(self.pos + shift) % self.world])
        self.src = dist.get_global_rank(
            group, members[(self.pos - shift) % self.world])
        self.sent = 0

    def post(self, sends: list, recvs: list) -> list:
        """Post one hop: every send to the next member, every receive from
        the previous one; returns the works."""
        ops_ = [dist.P2POp(dist.isend, t, peer=self.dst, group=self.group,
                           tag=self.tag) for t in sends]
        ops_ += [dist.P2POp(dist.irecv, t, peer=self.src, group=self.group,
                            tag=self.tag) for t in recvs]
        self.sent += sum(t.numel() * t.element_size() for t in sends)
        return dist.batch_isend_irecv(ops_)

    def seg(self, t: int) -> int:
        """The segment index this rank handles at chain step t."""
        return (self.pos - self.shift * t) % self.world


# ---------------------------------------------------------------------------
# ring mechanics
# ---------------------------------------------------------------------------

def _hop(seg: torch.Tensor, link: _Link, compress: str) -> Chain:
    """One ring step: encode to the wire dtype, send on, receive from the
    previous member, decode to f32 on seg's device.  With int8 this is the
    per-step requantization of the partial sum."""
    dev = seg.device
    if compress == "int8":
        q, s = _q_wire(seg)
        sends = [comp._host(q), comp._host(s)]
    elif compress == "bf16":
        sends = [comp._host(seg.to(torch.bfloat16))]
    else:
        sends = [comp._host(seg)]
    recvs = [_recv_like(t, dev) for t in sends]
    yield link.post(sends, recvs)
    if compress == "int8":
        return _dq_wire(recvs[0].to(dev), recvs[1].to(dev), seg.shape)
    return recvs[0].to(dev).float()


def _rs_chain(y: torch.Tensor, link: _Link, compress: str) -> Chain:
    """Reduce-scatter on stacked segments y: (world, m, ...).  Returns the
    fully-reduced segment this rank owns (segment index = its position): at
    step t each rank forwards its running partial (requantized on the wire)
    and folds in its own contribution to the next segment."""
    seg = y[link.seg(1)]
    for t in range(link.world - 1):
        seg = yield from _hop(seg, link, compress)
        seg = seg + y[link.seg(t + 2)]
    return seg


def _ag_chain(seg: torch.Tensor, out: torch.Tensor, link: _Link,
              compress: str) -> Chain:
    """All-gather of per-rank owned segments into `out` (world, m, ...).
    Each segment is encoded once at its owner and the identical wire bytes
    are forwarded hop by hop, so every rank decodes the same values."""
    dev = seg.device
    if compress == "int8":
        q, sc = _q_wire(seg)
        out[link.seg(0)] = _dq_wire(q, sc, seg.shape)
        wire = [comp._host(q), comp._host(sc)]
    else:
        w = seg.to(torch.bfloat16) if compress == "bf16" else seg
        out[link.seg(0)] = w.float()
        wire = [comp._host(w)]
    for t in range(link.world - 1):
        recvs = [_recv_like(x, dev) for x in wire]
        yield link.post(wire, recvs)
        wire = recvs
        if compress == "int8":
            got = _dq_wire(wire[0].to(dev), wire[1].to(dev), seg.shape)
        else:
            got = wire[0].to(dev).float()
        out[link.seg(t + 1)] = got
    return out


def _allreduce_1d(y: torch.Tensor, link: _Link, compress: str) -> Chain:
    """Ring all-reduce of y along dim 0 (any extent: padded to a multiple of
    the world, sliced back).  f32 accumulation; returns f32."""
    world = link.world
    n = y.shape[0]
    pad = (-n) % world
    y = y.float()
    if pad:
        y = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))], 0)
    y = y.reshape((world, (n + pad) // world) + tuple(y.shape[1:]))
    seg = yield from _rs_chain(y, link, compress)
    out = yield from _ag_chain(seg, torch.zeros_like(y), link, compress)
    return out.reshape((-1,) + tuple(out.shape[2:]))[:n]


def lockstep(chains: list) -> Chain:
    """One chain of many: each step posts every live chain's next hop,
    yields all their works, and resumes them together once those are done.
    Returns the chains' results in order."""
    out = [None] * len(chains)
    live = list(enumerate(chains))
    while live:
        step, works = [], []
        for i, g in live:
            try:
                works += next(g)
            except StopIteration as stop:
                out[i] = stop.value
                continue
            step.append((i, g))
        live = step
        if live:
            yield works
    return out


def drive(chain: Chain):
    """Run a chain to its end, waiting for each hop's works; its result."""
    try:
        while True:
            for w in next(chain):
                w.wait()
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def allreduce_steps(x: torch.Tensor, dim: int, group, *, compress: str = "none",
                    bidirectional: bool = False, tag: int = 0,
                    members=None) -> Chain:
    """The chain of a ring all-reduce of `x` over `group` (over its
    `members`, group ranks, when given: only they may run the chain),
    segmented along `dim`; returns (the reduced x in x's dtype, the bytes
    this rank sent).  `tag` (and tag + 1 for the second direction) tells
    this chain's hops from those of other chains posted beside it on the
    same group."""
    if compress not in WIRE_FACTOR:
        raise ValueError(f"unknown wire codec {compress!r}; have "
                         f"{sorted(WIRE_FACTOR)}")
    if x.dim() == 0:
        # scalars have no dim to segment and nothing to save: the sum of
        # every member's value in rank order, gathered over the group or,
        # for a subgroup, around its ring
        if members is None:
            out, work = comp._gather(x, group)
            yield [work]
            return (comp._rank_sum(out.to(x.device)).to(x.dtype),
                    x.element_size())
        link = _Link(group, +1, tag, members)
        y = x.reshape(1).float()
        out = yield from _ag_chain(
            y, y.new_zeros((link.world, 1)), link, "none")
        return comp._rank_sum(out).reshape(()).to(x.dtype), link.sent
    d = dim % x.dim()
    y = x.movedim(d, 0)
    n = y.shape[0]
    if bidirectional and n >= 2:
        half = n // 2
        fwd = _Link(group, +1, tag, members)
        bwd = _Link(group, -1, tag + 1, members)
        a, b = yield from lockstep([_allreduce_1d(y[:half], fwd, compress),
                                    _allreduce_1d(y[half:], bwd, compress)])
        z, sent = torch.cat([a, b], 0), fwd.sent + bwd.sent
    else:
        link = _Link(group, +1, tag, members)
        z = yield from _allreduce_1d(y, link, compress)
        sent = link.sent
    return z.movedim(0, d).to(x.dtype), sent


def ring_allreduce(x: torch.Tensor, dim: int, group, *, compress: str = "none",
                   bidirectional: bool = False,
                   subgroup: Optional[list] = None) -> torch.Tensor:
    """Bandwidth-optimal all-reduce of `x` over `group`, segmented along
    `dim` (the leaf's scatter dim).  `bidirectional` is the "ring2"
    algorithm.  Any world size >= 2 (odd rings pad the extent to a multiple
    of the world); a group of one (None) returns `x`.  `subgroup` (group
    ranks: pod indices on a pod group) restricts the ring to its members;
    a rank outside it posts nothing and gets `x` back, which the caller
    masks (the site gateways' exchange,
    :func:`repro_torch.core.collectives.site_allreduce`)."""
    if group is None:
        return x
    members = None if subgroup is None else [int(m) for m in subgroup]
    world = dist.get_world_size(group) if members is None else len(members)
    if world <= 1 or (members is not None
                      and dist.get_rank(group) not in members):
        return x
    return drive(allreduce_steps(x, dim, group, compress=compress,
                                 bidirectional=bidirectional,
                                 members=members))[0]


def ring_reduce_scatter(x: torch.Tensor, dim: int, group, *,
                        compress: str = "none") -> torch.Tensor:
    """Ring reduce-scatter: this rank's tile of the sum along `dim` (rank r
    keeps tile r), ``jax.lax.psum_scatter(..., tiled=True)`` built from
    point-to-point steps.  Requires ``x.shape[dim] % world == 0``."""
    if group is None or dist.get_world_size(group) <= 1:
        return x
    link = _Link(group, +1, 0)
    d = dim % x.dim()
    if x.shape[d] % link.world:
        raise ValueError(f"reduce_scatter dim {d} extent {x.shape[d]} not "
                         f"divisible by world {link.world}")
    y = x.movedim(d, 0).float()
    y = y.reshape((link.world, y.shape[0] // link.world) + tuple(y.shape[1:]))
    seg = drive(_rs_chain(y, link, compress))
    return seg.movedim(0, d).to(x.dtype)


def ring_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Ring all-gather: ``jax.lax.all_gather(..., tiled=True)`` built from
    point-to-point steps (tiles land in rank order along `dim`)."""
    if group is None or dist.get_world_size(group) <= 1:
        return x
    link = _Link(group, +1, 0)
    d = dim % x.dim()
    y = x.movedim(d, 0).float()
    out = torch.zeros((link.world,) + tuple(y.shape), dtype=torch.float32,
                      device=x.device)
    out = drive(_ag_chain(y, out, link, "none")).to(x.dtype)
    return out.reshape((-1,) + tuple(y.shape[1:])).movedim(0, d)
