"""KV-cache shipping over a WidePath (disaggregated prefill/decode).

Prefill runs on one site, decode on another; the prefilled KV cache crosses
the WAN as just another payload for the MPWide machinery: the chunk planner
cuts each KV leaf along its stacked ``layers`` dim, chunks are LPT-balanced
over the path's streams, multi-hop routes store-and-forward with per-hop
knobs, and the optional wire codec (``bf16`` / ``int8``) reduces wire bytes.

The transfer *plan* is frozen once per cache geometry (:func:`plan_kv_ship`)
and reused for every request — per-request work is slicing, encoding, and
telemetry.  The KV stays a device tensor through the codec: a chunk is a view
of the prefilled cache, and the int8 codec runs the quant and dequant
kernels on the device, with no host round trip.

Telemetry: each shipped request records under ``serve/req{rid}/kv`` (end to
end) and ``serve/req{rid}/kv/hop{i}:{leg}`` (per hop), with *exact* encoded
wire bytes (``numel * element_size`` of what the codec emits), which must
equal the plan's byte for byte.  Transfer seconds are deterministic modeled
seconds (`simulate_transfer_s`), never wall clock (mpwlint R5).

Not ported yet: shipping under a topology route's fault schedules (reship,
reroute, :class:`ShipError`), which waits for the topology and chaos port
(ROADMAP.md queue A).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import simulate_transfer_s
from repro_torch.core.path import WidePath
from repro_torch.core.streams import (Chunk, assign_streams, leaf_bytes,
                                      plan_chunks, slice_chunk, stitch_leaf)

QBLOCK = 256   # int8 wire blocking (matches the JAX package's core/compress.py)


def kv_cache_bytes(n_layers: int, kv_heads: int, head_dim: int,
                   prompt_len: int, *, itemsize: int = 2,
                   leaves: int = 2) -> int:
    """Logical bytes of one request's prefilled KV cache (k + v leaves)."""
    return leaves * n_layers * prompt_len * kv_heads * head_dim * itemsize


def _encoded_nbytes(n_elems: int, itemsize: int, compress: str) -> int:
    """Exact wire bytes of one encoded chunk."""
    if compress == "none":
        return n_elems * itemsize
    if compress == "bf16":
        return n_elems * 2
    if compress == "int8":
        pad = (-n_elems) % QBLOCK
        n = n_elems + pad
        return n + (n // QBLOCK) * 4          # int8 payload + f32 scales
    raise ValueError(f"unknown KV wire codec {compress!r}; "
                     f"have none|bf16|int8")


def _dtype_str(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


@dataclass(frozen=True)
class KVShipPlan:
    """Frozen per-session transfer plan for one cache geometry."""
    path: WidePath
    leaf_names: tuple          # cache dict keys, sorted ("k", "v", ...)
    shapes: tuple              # per-leaf single-request KV shape
    dtype: str                 # the JAX package's dtype string ("bfloat16")
    chunks: tuple              # tuple[Chunk, ...] over the flat leaves
    streams_used: int
    load_balance: float
    payload_bytes: int         # logical bytes (pre-codec)
    wire_bytes_hop: int        # exact encoded bytes per hop

    @property
    def n_hops(self) -> int:
        return self.path.n_hops

    @property
    def wire_bytes_total(self) -> int:
        """Wire bytes summed over every hop of the route."""
        return self.wire_bytes_hop * self.n_hops


@dataclass(frozen=True)
class KVShipResult:
    rid: int
    wire_bytes_hop: int
    wire_bytes_total: int
    modeled_s: float           # end-to-end (store-and-forward sum)
    per_hop_s: tuple
    n_chunks: int


def plan_kv_ship(kv_template: dict, path: WidePath) -> KVShipPlan:
    """Plan the KV transfer once for a cache geometry.

    `kv_template`: one request's KV leaves (tensors, or tensors on the
    ``meta`` device), e.g. ``{"k": (nL, S_p, KH, Dh), "v": ...}`` with the
    batch dim already squeezed out.  Chunks are cut along dim 0 (the stacked
    layers dim), so a chunk is a contiguous run of whole layers."""
    names = tuple(sorted(kv_template))
    if not names:
        raise ValueError(f"kv_template must hold at least one KV leaf, "
                         f"got keys {names}")
    leaves = [kv_template[n] for n in names]
    dt = leaves[0].dtype
    for n, x in zip(names, leaves):
        if x.dtype != dt:
            raise ValueError(f"KV leaves must share one dtype, got "
                             f"{x.dtype} for {n!r} vs {dt}")
        if x.dim() < 2:
            raise ValueError(f"KV leaf {n!r} must be at least 2-D "
                             f"(layers leading), got shape {tuple(x.shape)}")
    chunks = plan_chunks(leaves, [0] * len(leaves), path.chunk_bytes)
    buckets = assign_streams(chunks, path.streams)
    loads = [sum(c.nbytes for c in b) for b in buckets]
    mean = sum(loads) / len(loads) if loads else 0.0
    itemsize = dt.itemsize
    wire_hop = sum(_encoded_nbytes(c.nbytes // itemsize, itemsize,
                                   path.comm.compress)
                   for c in chunks)
    return KVShipPlan(
        path=path, leaf_names=names,
        shapes=tuple(tuple(x.shape) for x in leaves), dtype=_dtype_str(dt),
        chunks=tuple(chunks), streams_used=len(buckets),
        load_balance=(max(loads) / mean) if mean > 0 else 1.0,
        payload_bytes=sum(leaf_bytes(x) for x in leaves),
        wire_bytes_hop=int(wire_hop))


def _encode_decode(arr: torch.Tensor, compress: str) -> tuple:
    """One chunk through the wire codec: returns (decoded tensor, wire bytes).

    ``none`` hands the chunk on unchanged; ``bf16``/``int8`` round-trip
    through the wire dtype on the chunk's device (int8 flattens to 1-D and
    pads to the quantization block, so padding waste never exceeds
    QBLOCK-1 elements per chunk)."""
    if compress == "none":
        return arr, leaf_bytes(arr)
    if compress == "bf16":
        wire = arr.to(torch.bfloat16)
        return wire.to(arr.dtype), leaf_bytes(wire)
    if compress != "int8":
        raise ValueError(f"unknown KV wire codec {compress!r}; "
                         f"have none|bf16|int8")
    from repro_torch.kernels import ops
    flat = arr.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = ops.quant_int8(flat, block=QBLOCK)
    wire = leaf_bytes(q) + leaf_bytes(s)
    y = ops.dequant_int8(q, s, block=QBLOCK, dtype=torch.float32)
    y = y[:arr.numel()].reshape(arr.shape).to(arr.dtype)
    return y, wire


def ship_kv(kv: dict, plan: KVShipPlan, rid: int, *,
            step=None) -> tuple[dict, KVShipResult]:
    """Ship one request's KV leaves along the plan's path.

    Store-and-forward over the route: each hop re-encodes every chunk with
    the hop's wire codec (``none`` arrives bit-identical), records its exact
    encoded bytes and modeled seconds under the request's telemetry keys, and
    hands the decoded payload to the next hop.  Returns (reconstructed KV
    dict of device tensors, :class:`KVShipResult`)."""
    path = plan.path
    arrs = []
    for name, shape in zip(plan.leaf_names, plan.shapes):
        if name not in kv:
            raise ValueError(f"kv is missing leaf {name!r} the plan was "
                             f"built for (have {sorted(kv)})")
        a = kv[name]
        if tuple(a.shape) != shape:
            raise ValueError(f"kv leaf {name!r} has shape {tuple(a.shape)} "
                             f"but the plan was frozen for {shape} — "
                             f"re-plan on cache-geometry change")
        arrs.append(a)
    key = f"serve/req{rid}/kv"
    tel.note_plan(key, payload_bytes=plan.payload_bytes,
                  n_chunks=len(plan.chunks),
                  streams_used=plan.streams_used,
                  streams_configured=path.streams,
                  chunk_bytes=path.chunk_bytes, pacing=path.comm.pacing,
                  load_balance=plan.load_balance, algo="shift",
                  wire_bytes=plan.wire_bytes_hop)
    per_hop_s = []
    total_s = 0.0
    for i, hop in enumerate(path.route):
        hop_bytes = 0
        pieces: list[list[tuple[Chunk, torch.Tensor]]] = [[] for _ in arrs]
        for c in plan.chunks:
            decoded, wire = _encode_decode(slice_chunk(arrs[c.leaf], c),
                                           hop.comm.compress)
            hop_bytes += wire
            pieces[c.leaf].append((c, decoded))
        if hop_bytes != plan.wire_bytes_hop and hop.comm.compress == path.comm.compress:
            raise RuntimeError(
                f"hop {i} encoded {hop_bytes} wire bytes but the plan "
                f"promised {plan.wire_bytes_hop} — plan and codec disagree")
        arrs = [stitch_leaf(a, p) for a, p in zip(arrs, pieces)]
        hop_s = simulate_transfer_s(
            hop_bytes, hop.link, streams=hop.streams,
            chunk_bytes=hop.chunk_bytes, pacing=hop.comm.pacing)
        per_hop_s.append(hop_s)
        total_s += hop_s
        tel.record(f"{key}/hop{i}:{hop.name}", hop_s, nbytes=hop_bytes,
                   step=step)
    n_hops = len(per_hop_s)
    tel.record(key, total_s, nbytes=plan.wire_bytes_hop * n_hops, step=step)
    return (
        {n: a for n, a in zip(plan.leaf_names, arrs)},
        KVShipResult(rid=rid, wire_bytes_hop=plan.wire_bytes_hop,
                     wire_bytes_total=plan.wire_bytes_hop * n_hops,
                     modeled_s=total_s, per_hop_s=tuple(per_hop_s),
                     n_chunks=len(plan.chunks)))
