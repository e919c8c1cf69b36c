"""Ring collectives over the pod axis: so far only the wire-byte model.

The ring, ring2 and subgroup collectives and their per-hop int8 codec are
queued (ROADMAP.md queue A, the WAN comm engine on `torch.distributed`).  What
is here is the pure arithmetic the autotuner and the plan summaries read.
"""
from __future__ import annotations


# bytes per f32 element that actually cross the wire, per compress mode.
# int8 additionally ships one f32 scale per QBLOCK elements (+4/QBLOCK =
# +1.6% — a sideband the model below deliberately excludes, like headers).
WIRE_FACTOR = {"none": 1.0, "bf16": 0.5, "int8": 0.25}


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
