"""WidePath: the MPWide communication-path abstraction, adapted to TPU.

A path in the paper is (endpoint pair, S tcp streams, chunk size, pacing,
window).  Here a path is (mesh axis, S chunk-streams, chunk bytes, pacing,
compression): every transfer over the path is split into chunks, chunks are
round-robined onto S *streams*, chunks within one stream are ordered (like
bytes on one TCP connection) while distinct streams are independent HLO ops
the XLA latency-hiding scheduler may run concurrently and overlap with
compute.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.configs.base import CommConfig


from typing import Optional as _Optional


@dataclass(frozen=True)
class LinkSpec:
    """alpha-beta link model (per device).

    `window`: per-stream in-flight byte cap (TCP congestion window) — the
    mechanism behind the paper's ">=32 streams on WANs": one stream moves at
    most window/RTT.  None for links without per-channel caps (TPU fabrics).
    """
    name: str
    latency_s: float          # alpha: per-op launch + one-way latency
    bandwidth_Bps: float      # beta^-1: per-device link bandwidth
    window: _Optional[float] = None

    def transfer_s(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


# hardware constants (assignment): TPU v5e
ICI = LinkSpec("ici", 1e-6, 50e9)               # intra-pod, per link
INTERPOD = LinkSpec("interpod", 50e-6, 6.25e9)  # cross-pod DCN-class link
# WAN regimes from the paper's experiments (for the table-1 benchmark);
# windows ~64KB reproduce the paper's observed single-stream (scp) rates
WAN_LONDON_POZNAN = LinkSpec("lon-poz", 12e-3, 125e6, window=64 << 10)
WAN_POZNAN_GDANSK = LinkSpec("poz-gda", 5e-3, 156e6, window=64 << 10)
WAN_POZNAN_AMS = LinkSpec("poz-ams", 9e-3, 70e6, window=64 << 10)
WAN_UCL_HECTOR = LinkSpec("ucl-hector", 5.5e-3, 120e6, window=64 << 10)


@dataclass(frozen=True)
class Hop:
    """One leg of a multi-hop route: the link it traverses, the comm knobs
    that leg runs with, and the pod-axis shift that executes it.

    A Forwarder route (site A -> relay -> site B) is a tuple of Hops; each
    hop is an independent transfer with its own chunking/streams/pacing —
    the paper tunes every path leg separately (32 streams on the WAN leg,
    1 on the LAN leg of the same route).
    """
    name: str                     # label, e.g. "ams->tokyo"
    link: LinkSpec = INTERPOD
    comm: CommConfig = CommConfig()
    shift: int = 1                # pod-ring delta this hop traverses

    @property
    def streams(self) -> int:
        return max(1, int(self.comm.streams))

    @property
    def chunk_bytes(self) -> int:
        return max(1 << 16, int(self.comm.chunk_mb * (1 << 20)))

    def with_(self, **kw) -> "Hop":
        comm_kw = {k: v for k, v in kw.items() if hasattr(self.comm, k)}
        hop_kw = {k: v for k, v in kw.items()
                  if k in ("name", "link", "shift")}
        comm = replace(self.comm, **comm_kw) if comm_kw else self.comm
        return replace(self, comm=comm, **hop_kw)


@dataclass(frozen=True)
class WidePath:
    """A configured communication path over one mesh axis.

    With `hops` set, the path is a multi-hop route (a Forwarder chain):
    transfers store-and-forward through each hop with that hop's own comm
    knobs, and the path-level knob properties (`streams`, `chunk_bytes`)
    read from — and `with_` writes to — the *bottleneck* hop, so existing
    single-link tuning code (Trainer retune, setChunkSize) transparently
    tunes the hop that dominates.
    """
    axis: str = "pod"
    comm: CommConfig = CommConfig()
    link: LinkSpec = INTERPOD
    name: Optional[str] = None    # telemetry label (defaults to the axis)
    hops: tuple = ()              # tuple[Hop, ...]; empty = single-link path

    @property
    def route(self) -> tuple:
        """The hop sequence: explicit hops, or the implicit single hop."""
        if self.hops:
            return self.hops
        return (Hop(name=self.link.name, link=self.link, comm=self.comm,
                    shift=1),)

    @property
    def n_hops(self) -> int:
        return len(self.route)

    @property
    def bottleneck(self) -> int:
        """Index of the slowest hop (lowest bandwidth, then highest alpha)."""
        r = self.route
        return min(range(len(r)),
                   key=lambda i: (r[i].link.bandwidth_Bps,
                                  -r[i].link.latency_s))

    def hop_key(self, i: int) -> str:
        """Telemetry key for hop i (sorts under the path's own key)."""
        return f"{self.key}/hop{i}:{self.route[i].name}"

    def hop_keys(self) -> list:
        return [self.hop_key(i) for i in range(self.n_hops)]

    @property
    def streams(self) -> int:
        if self.hops:
            return self.route[self.bottleneck].streams
        return max(1, int(self.comm.streams))

    @property
    def chunk_bytes(self) -> int:
        if self.hops:
            return self.route[self.bottleneck].chunk_bytes
        return max(1 << 16, int(self.comm.chunk_mb * (1 << 20)))

    @property
    def bucket_bytes(self) -> int:
        """Gradient-sync bucket size in bytes; 0 = bucketing disabled."""
        return max(0, int(self.comm.bucket_mb * (1 << 20)))

    @property
    def key(self) -> str:
        """Registry key for this path's telemetry slot."""
        return f"{self.name or self.axis}:{self.link.name}"

    def with_(self, **kw) -> "WidePath":
        comm_kw = {k: v for k, v in kw.items() if hasattr(self.comm, k)}
        path_kw = {k: v for k, v in kw.items()
                   if k in ("axis", "link", "name", "hops")}
        comm = replace(self.comm, **comm_kw) if comm_kw else self.comm
        out = replace(self, comm=comm, **path_kw)
        if out.hops and comm_kw and "hops" not in path_kw:
            # knob writes target the bottleneck hop (see class docstring)
            out = out.with_hop(out.bottleneck, **comm_kw)
        return out

    def with_hop(self, i: int, **kw) -> "WidePath":
        """Replace knobs of hop i (comm fields, link, name, shift)."""
        r = list(self.route)
        r[i] = r[i].with_(**kw)
        return replace(self, hops=tuple(r))

    def with_hops(self, hops) -> "WidePath":
        """Attach an explicit hop route; `link` becomes the bottleneck's
        link so `key` and alpha-beta warm starts describe the slow hop."""
        p = replace(self, hops=tuple(hops))
        return replace(p, link=p.route[p.bottleneck].link)


def local_path(comm: Optional[CommConfig] = None) -> WidePath:
    """Single-stream path over the intra-pod fabric (paper: 1 stream local)."""
    comm = comm or CommConfig(streams=1, chunk_mb=64.0, compress="none")
    return WidePath(axis="data", comm=comm, link=ICI)
