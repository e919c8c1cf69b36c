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

Under a topology route's fault schedules (``ship_kv(route=, step=)``) a
dead or corrupting hop burns the watchdog and reships after a seeded
backoff, then reroutes the remaining hops over the topology's surviving
links, or raises :class:`ShipError` when none is left, as the reference
does; the KV stays on its device throughout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import simulate_hop_s, simulate_transfer_s
from repro_torch.core.path import WidePath
from repro_torch.core.retry import KVSHIP_RETRY
from repro_torch.core.streams import (Chunk, assign_streams, leaf_bytes,
                                      plan_chunks, slice_chunk, stitch_leaf)

QBLOCK = 256   # int8 wire blocking (matches the JAX package's core/compress.py)

# cap on fault responses within one ship — a schedule that keeps cutting
# every attempt raises ShipError instead of spinning
_MAX_SHIP_FAULTS = 64


class ShipError(RuntimeError):
    """A KV ship exhausted its reships and found no surviving route."""


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
    modeled_s: float           # end-to-end (store-and-forward sum, incl.
    per_hop_s: tuple           # watchdog timeouts + retry backoffs)
    n_chunks: int
    reships: int = 0           # failed-hop retries this ship needed
    reroutes: int = 0          # route replans this ship needed
    route: tuple = ()          # site names traversed (when routed)


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
    QBLOCK-1 elements per chunk).  The int8 kernels take the chunk in its
    own dtype and give it back in that dtype, with no cast pass around them:
    widening bf16 to f32 is exact, and the dequant rounds its f32 product to
    the chunk's dtype to nearest even, as the reference's cast does."""
    if compress == "none":
        return arr, leaf_bytes(arr)
    if compress == "bf16":
        wire = arr.to(torch.bfloat16)
        return wire.to(arr.dtype), leaf_bytes(wire)
    if compress != "int8":
        raise ValueError(f"unknown KV wire codec {compress!r}; "
                         f"have none|bf16|int8")
    from repro_torch.kernels import ops
    flat = arr.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = ops.quant_int8(flat, block=QBLOCK)
    wire = leaf_bytes(q) + leaf_bytes(s)
    y = ops.dequant_int8(q, s, block=QBLOCK, dtype=arr.dtype)
    return y[:arr.numel()].reshape(arr.shape), wire


def _corrupts(health, rid: int, hop: int, attempt: int) -> bool:
    """Deterministic per-attempt corruption draw against the hop's active
    ``error_rate`` (seeded by the fault schedule — replays bit-identically,
    like the file-transfer checksum path)."""
    if health.error_rate <= 0.0:
        return False
    x = ((health.seed * 1000003) ^ (rid * 8191 + hop * 131 + attempt * 7))
    x &= 0x7FFFFFFF
    return (x % 10000) / 10000.0 < health.error_rate


def ship_kv(kv: dict, plan: KVShipPlan, rid: int, *,
            step=None, route=None, retry=None, max_reships: int = 2,
            topo=None, log=None,
            timeout_s: float = 30.0) -> tuple[dict, KVShipResult]:
    """Ship one request's KV leaves along the plan's path.

    Store-and-forward over the route: each hop re-encodes every chunk with
    the hop's wire codec (``none`` arrives bit-identical), records its exact
    encoded bytes and modeled seconds under the request's telemetry keys, and
    hands the decoded payload to the next hop.  Returns (reconstructed KV
    dict of device tensors, :class:`KVShipResult`).

    With ``route`` (the ``core/topology.py`` ``Route`` the path was compiled
    from, its ``LinkProfile`` fault schedules) and ``step``, the fault clock
    applies per hop: a dead hop, or one whose ``error_rate`` corrupts this
    attempt (a deterministic seeded draw, counted as a checksum error),
    burns the ``timeout_s`` watchdog and retries after a seeded ``retry``
    backoff (``core/retry.py`` ``KVSHIP_RETRY`` by default), logging a
    ``reship`` incident to ``log``; after ``max_reships`` failures the
    remaining hops replan from the stranded site over ``topo``'s surviving
    links (``reroute``).  With no route left, :class:`ShipError` is raised:
    the batcher's cue to degrade to collocated serving.  The fault gate runs
    on the host before a hop moves any byte; the KV stays on its device."""
    path = plan.path
    if max_reships < 0:
        raise ValueError(f"max_reships must be >= 0, got {max_reships}")
    if route is not None and len(route.profiles) != path.n_hops:
        raise ValueError(f"route has {len(route.profiles)} hops but the "
                         f"plan's path has {path.n_hops} — re-plan after "
                         f"a topology change")
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
    pol = KVSHIP_RETRY if retry is None else retry
    hops = list(path.route)
    profs = list(route.profiles) if route is not None else [None] * len(hops)
    sites = list(route.sites) if route is not None else []
    avoid: set = set()
    per_hop_s = []
    total_s = 0.0
    reships = reroutes = faults = 0
    i = 0
    while i < len(hops):
        hop = hops[i]
        prof = profs[i]
        # fault gate: a dead hop or a corrupted attempt burns the watchdog
        # and retries; exhausted retries replan the remaining hops
        attempt = 0
        while prof is not None and step is not None:
            if faults > _MAX_SHIP_FAULTS:
                raise ShipError(f"req{rid}: ship exceeded {_MAX_SHIP_FAULTS} "
                                f"fault responses at hop {i} ({hop.name})")
            health = prof.health(int(step) + attempt)
            corrupt = health.alive and _corrupts(health, rid, i, attempt)
            if health.alive and not corrupt:
                break
            faults += 1
            total_s += float(timeout_s)
            if corrupt:
                tel.note_checksum_error(f"{key}/hop{i}:{hop.name}")
            if attempt < max_reships:
                backoff = pol.delay_s(attempt, key=rid * 31 + i)
                total_s += backoff
                reships += 1
                attempt += 1
                if log is not None:
                    log.add(int(step) + attempt, "reship", hop.name,
                            {"rid": rid,
                             "reason": "corrupt" if corrupt else "dead",
                             "attempt": attempt,
                             "backoff_s": round(backoff, 6)})
                continue
            # reships exhausted: replan from the stranded site
            if topo is None:
                raise ShipError(
                    f"req{rid}: hop {i} ({hop.name}) still faulty after "
                    f"{max_reships} reship(s) and no topology to replan on")
            avoid.add((sites[i], sites[i + 1]))
            avoid.add((sites[i + 1], sites[i]))
            try:
                nr = topo.route(sites[i], sites[-1], avoid=frozenset(avoid))
            except (KeyError, ValueError):
                raise ShipError(
                    f"req{rid}: no surviving route {sites[i]} -> "
                    f"{sites[-1]} after {reships} reship(s)")
            reroutes += 1
            if log is not None:
                log.add(int(step) + attempt, "reroute", hop.name,
                        {"rid": rid, "route": list(nr.sites)})
            hops = hops[:i] + list(nr.as_hops(base_comm=path.comm))
            profs = profs[:i] + list(nr.profiles)
            sites = sites[:i] + list(nr.sites)
            hop = hops[i]
            prof = profs[i]
            attempt = 0
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
        if prof is not None and step is not None:
            hop_s = simulate_hop_s(
                hop_bytes, prof, int(step) + attempt, streams=hop.streams,
                chunk_bytes=hop.chunk_bytes, pacing=hop.comm.pacing,
                timeout_s=timeout_s)
        else:
            hop_s = simulate_transfer_s(
                hop_bytes, hop.link, streams=hop.streams,
                chunk_bytes=hop.chunk_bytes, pacing=hop.comm.pacing)
        per_hop_s.append(hop_s)
        total_s += hop_s
        tel.record(f"{key}/hop{i}:{hop.name}", hop_s, nbytes=hop_bytes,
                   step=step)
        i += 1
    n_hops = len(per_hop_s)
    tel.record(key, total_s, nbytes=plan.wire_bytes_hop * n_hops, step=step)
    if reships or reroutes:
        tel.note_ship_retry(key, reships=reships, reroutes=reroutes)
    return (
        {n: a for n, a in zip(plan.leaf_names, arrs)},
        KVShipResult(rid=rid, wire_bytes_hop=plan.wire_bytes_hop,
                     wire_bytes_total=plan.wire_bytes_hop * n_hops,
                     modeled_s=total_s, per_hop_s=tuple(per_hop_s),
                     n_chunks=len(plan.chunks), reships=reships,
                     reroutes=reroutes, route=tuple(sites)))
