"""Multi-site WAN topology: sites, heterogeneous links, route planning, and
the store-and-forward Forwarder (the paper's mechanism for connecting
supercomputers *without direct connectivity* — the CosmoGrid runs spanned up
to four machines on two continents by relaying through intermediate hosts).

Mapping onto the mesh: each *site* owns one or more coordinates on the "pod"
mesh axis (its pods); links connect sites with per-hop :class:`LinkProfile`s
(distinct alpha/beta/window *and* distinct comm knobs — the paper tunes each
leg separately: >=32 streams on the WAN leg, 1 on the LAN leg of the same
route).  A :class:`Route` is a site sequence with per-hop profiles; the
:class:`Forwarder` compiles it into a multi-hop :class:`~repro_torch.core.path.WidePath`
whose transfers store-and-forward hop by hop (`repro_torch.core.cycle.forward`).

The port's copy of the JAX package's ``core/topology.py``: only the package
name in its imports differs.  The port uses its site groups (the
site-hierarchical gradient sync), its routes and the :class:`Forwarder`
(training over a route, the MPW facade, mpw-cp and the checkpoint replicas),
and its fault schedules and link health (the chaos monitor, elastic
membership and the KV ship under faults).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from repro_torch.configs.base import CommConfig
from repro_torch.core.path import Hop, LinkSpec, WidePath


@dataclass(frozen=True)
class Fault:
    """One scheduled fault on a link.  Everything is derived from the
    schedule fields plus `seed`, so a fault run replays bit-identically:
    the chaos suite's scenarios are scripts, not dice rolls.

    Kinds:
      * ``"drop"``      — the link is dead for steps in [start, stop).
      * ``"degrade"``   — bandwidth is multiplied by `factor` and a
                          deterministic `error_rate` fraction of chunks is
                          corrupted for steps in [start, stop).
      * ``"partition"`` — the link is dead *and* `site` is declared
                          unreachable (whole-site loss: the failover case).
    """
    kind: str
    start: int = 0                 # first step the fault is active
    stop: Optional[int] = None     # first healed step (None: never heals)
    factor: float = 1.0            # degrade: bandwidth multiplier in (0, 1]
    error_rate: float = 0.0        # degrade: fraction of chunks corrupted
    site: Optional[str] = None     # partition: the site cut off
    seed: int = 0                  # drives which chunks corrupt

    def active(self, step: int) -> bool:
        return step >= self.start and (self.stop is None or step < self.stop)


@dataclass(frozen=True)
class LinkHealth:
    """A link's effective condition at one step: the fold of every active
    :class:`Fault` on its profile."""
    alive: bool = True
    bandwidth_factor: float = 1.0
    error_rate: float = 0.0
    partitioned: tuple = ()        # sites the active faults cut off
    seed: int = 0

    @property
    def faulty(self) -> bool:
        return (not self.alive or self.bandwidth_factor < 1.0
                or self.error_rate > 0.0 or bool(self.partitioned))


@dataclass(frozen=True)
class LinkProfile:
    """One heterogeneous WAN hop: the alpha-beta/window link model plus the
    comm knobs (streams / chunk / pacing) transfers over this hop should run
    with.  `LinkSpec` is the bare physics; the profile adds the tuning."""
    name: str
    latency_s: float              # alpha: one-way latency
    bandwidth_Bps: float          # beta^-1: attainable path capacity
    window: Optional[float] = None  # per-stream in-flight cap (TCP window)
    streams: int = 32
    chunk_mb: float = 8.0
    pacing: float = 1.0
    faults: tuple = field(default=())   # tuple[Fault, ...], step-scheduled

    @property
    def spec(self) -> LinkSpec:
        return LinkSpec(self.name, self.latency_s, self.bandwidth_Bps,
                        self.window)

    def comm(self, base: Optional[CommConfig] = None) -> CommConfig:
        base = base or CommConfig()
        return replace(base, streams=self.streams, chunk_mb=self.chunk_mb,
                       pacing=self.pacing)

    # -- fault schedule ------------------------------------------------------
    def with_fault(self, fault: Fault) -> "LinkProfile":
        return replace(self, faults=self.faults + (fault,))

    def drop(self, at_step: int, until: Optional[int] = None,
             seed: int = 0) -> "LinkProfile":
        """Schedule the link to die at `at_step` (heal at `until`, if set)."""
        return self.with_fault(Fault("drop", start=at_step, stop=until,
                                     seed=seed))

    def degrade(self, factor: float, window: tuple,
                error_rate: float = 0.0, seed: int = 0) -> "LinkProfile":
        """Scale bandwidth by `factor` over steps [window[0], window[1]),
        corrupting a deterministic `error_rate` fraction of chunks."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"degrade factor must be in (0, 1], got {factor}")
        return self.with_fault(Fault("degrade", start=window[0],
                                     stop=window[1], factor=factor,
                                     error_rate=error_rate, seed=seed))

    def partition(self, site: str, at_step: int = 0,
                  until: Optional[int] = None, seed: int = 0) -> "LinkProfile":
        """Schedule a partition: the link dies and `site` is declared lost
        (distinguishes re-routable hop death from whole-site failover)."""
        return self.with_fault(Fault("partition", start=at_step, stop=until,
                                     site=site, seed=seed))

    def health(self, step: int) -> LinkHealth:
        """Fold every fault active at `step` into one :class:`LinkHealth`."""
        alive, factor, err = True, 1.0, 0.0
        parts: list = []
        seed = 0
        for f in self.faults:
            if not f.active(step):
                continue
            seed = (seed * 1000003) ^ (f.seed + 77 * f.start + hash(f.kind))
            if f.kind == "drop":
                alive = False
            elif f.kind == "partition":
                alive = False
                if f.site:
                    parts.append(f.site)
            elif f.kind == "degrade":
                factor = min(factor, f.factor)
                err = max(err, f.error_rate)
            else:
                raise ValueError(f"unknown fault kind {f.kind!r}")
        return LinkHealth(alive, factor, err, tuple(parts), seed & 0x7FFFFFFF)

    def transfer_s(self, nbytes: float, step: Optional[int] = None) -> float:
        """Modeled seconds to move `nbytes` over this hop (stream-aware:
        window-capped links deliver streams * window/RTT up to capacity).
        With `step`, the fault schedule applies: a dead link models as
        ``inf``; a degraded one as proportionally less capacity."""
        bw_factor = 1.0
        if step is not None:
            h = self.health(step)
            if not h.alive:
                return math.inf
            bw_factor = h.bandwidth_factor
        if self.window:
            per_stream = self.window / (2 * self.latency_s)
            bw = min(self.bandwidth_Bps, max(1, self.streams) * per_stream)
        else:
            bw = self.bandwidth_Bps
        return self.latency_s + nbytes / max(1.0, bw * bw_factor)


# intra-site fabric: pods at one site talk over the local interconnect
LAN = LinkProfile("lan", 50e-6, 6.25e9, streams=1, chunk_mb=64.0)


@dataclass(frozen=True)
class Site:
    """A named site owning contiguous coordinates on the pod axis."""
    name: str
    pods: tuple = (0,)

    @property
    def gateway(self) -> int:
        """The pod that fronts this site's WAN traffic (paper: the Forwarder
        host / the one machine with external connectivity)."""
        return self.pods[0]


@dataclass(frozen=True)
class Route:
    """A planned path through the topology: the site sequence, the profile of
    each hop, and the pod-axis shift each hop executes as."""
    sites: tuple                    # tuple[str, ...], len n+1
    profiles: tuple                 # tuple[LinkProfile, ...], len n
    shifts: tuple                   # tuple[int, ...], len n

    @property
    def n_hops(self) -> int:
        return len(self.profiles)

    @property
    def bottleneck(self) -> int:
        """Index of the slowest hop (lowest bandwidth, then highest alpha)."""
        return min(range(self.n_hops),
                   key=lambda i: (self.profiles[i].bandwidth_Bps,
                                  -self.profiles[i].latency_s))

    def as_hops(self, base_comm: Optional[CommConfig] = None,
                bottleneck_comm: Optional[CommConfig] = None) -> tuple:
        """Compile to :class:`~repro_torch.core.path.Hop`s.  Each hop takes its
        profile's comm knobs; `bottleneck_comm` (e.g. the RunConfig's tuned
        comm) overrides the slow hop — the slot the autotuner drives."""
        hops = []
        for i, (prof, shift) in enumerate(zip(self.profiles, self.shifts)):
            comm = prof.comm(base_comm)
            if bottleneck_comm is not None and i == self.bottleneck:
                comm = bottleneck_comm
            hops.append(Hop(name=f"{self.sites[i]}->{self.sites[i + 1]}",
                            link=prof.spec, comm=comm, shift=shift))
        return tuple(hops)

    def modeled_s(self, nbytes: float, store_and_forward: bool = True) -> float:
        """Seconds to relay `nbytes` end to end.  Store-and-forward: each
        relay holds the full message before sending (serial hops — the
        paper's Forwarder semantics); else the pipeline bound (bottleneck
        bandwidth + per-hop latencies)."""
        if store_and_forward:
            return sum(p.transfer_s(nbytes) for p in self.profiles)
        alphas = sum(p.latency_s for p in self.profiles)
        return alphas + self.profiles[self.bottleneck].transfer_s(nbytes) \
            - self.profiles[self.bottleneck].latency_s

    def describe(self) -> str:
        legs = [self.sites[0]]
        for s, p in zip(self.sites[1:], self.profiles):
            legs.append(f"--[{p.name}]--> {s}")
        return " ".join(legs)


class Topology:
    """A graph of sites and heterogeneous links with route planning.

    Routing metrics:
      * ``"hops"``    — fewest hops (BFS).
      * ``"latency"`` — minimum summed one-way latency (Dijkstra on alpha).
      * ``"width"``   — widest path: maximize the bottleneck bandwidth
                        (Dijkstra on -min(bandwidth)); what a bulk DataGather
                        mirror wants.
    """

    def __init__(self) -> None:
        self._sites: dict[str, Site] = {}
        self._links: dict[tuple, LinkProfile] = {}
        self._down: set[tuple] = set()       # directed (a, b) pairs taken out
        self._next_pod = 0

    # -- construction --------------------------------------------------------
    def add_site(self, name: str, pods: Optional[Sequence[int]] = None,
                 n_pods: int = 1) -> Site:
        if name in self._sites:
            raise ValueError(f"duplicate site {name!r}")
        if pods is None:
            pods = tuple(range(self._next_pod, self._next_pod + n_pods))
        site = Site(name, tuple(pods))
        taken = {p for s in self._sites.values() for p in s.pods}
        if taken & set(site.pods):
            raise ValueError(f"pods {taken & set(site.pods)} already assigned")
        self._sites[name] = site
        self._next_pod = max([self._next_pod, *[p + 1 for p in site.pods]])
        return site

    def connect(self, a: str, b: str, profile: LinkProfile,
                bidirectional: bool = True) -> None:
        for n in (a, b):
            if n not in self._sites:
                raise KeyError(f"unknown site {n!r}")
        self._links[(a, b)] = profile
        if bidirectional:
            self._links[(b, a)] = profile

    # -- link liveness (the chaos layer drives these) ------------------------
    def fail_link(self, a: str, b: str, bidirectional: bool = True) -> None:
        """Take the a->b link out of route planning (the detector's response
        to a dead hop).  The profile stays registered for later restore."""
        if (a, b) not in self._links:
            raise KeyError(f"no link {a!r} -> {b!r}")
        self._down.add((a, b))
        if bidirectional and (b, a) in self._links:
            self._down.add((b, a))

    def restore_link(self, a: str, b: str, bidirectional: bool = True) -> None:
        self._down.discard((a, b))
        if bidirectional:
            self._down.discard((b, a))

    def fail_site(self, name: str) -> list:
        """Whole-site loss: every link touching `name` goes down.  Returns
        the directed pairs taken out."""
        if name not in self._sites:
            raise KeyError(f"unknown site {name!r}")
        hit = [(a, b) for (a, b) in self._links if name in (a, b)]
        self._down.update(hit)
        return hit

    def restore_site(self, name: str) -> list:
        """Undo :meth:`fail_site`: links touching `name` come back, except
        those whose *other* endpoint is itself still failed (all of that
        site's links down) — a rejoining site must not silently resurrect a
        still-dead peer.  Returns the directed pairs restored."""
        if name not in self._sites:
            raise KeyError(f"unknown site {name!r}")

        def site_dead(s: str) -> bool:
            touching = [(a, b) for (a, b) in self._links if s in (a, b)]
            return bool(touching) and all(p in self._down for p in touching)

        dead_peers = {s for s in self._sites
                      if s != name and site_dead(s)}
        hit = [(a, b) for (a, b) in self._down
               if name in (a, b) and not ({a, b} & dead_peers)]
        self._down.difference_update(hit)
        return hit

    def is_down(self, a: str, b: str) -> bool:
        return (a, b) in self._down

    def down_links(self) -> frozenset:
        return frozenset(self._down)

    # -- accessors -----------------------------------------------------------
    def site(self, name: str) -> Site:
        return self._sites[name]

    @property
    def sites(self) -> list:
        return list(self._sites.values())

    @property
    def n_pods(self) -> int:
        return 1 + max(p for s in self._sites.values() for p in s.pods)

    def link(self, a: str, b: str) -> Optional[LinkProfile]:
        return self._links.get((a, b))

    def neighbors(self, name: str) -> list:
        return [b for (a, b) in self._links if a == name]

    def pod_groups(self) -> list:
        """Site pod groups covering every pod — `axis_index_groups` for the
        intra-site reduction stage of the hierarchical collective."""
        groups = [list(s.pods) for s in self._sites.values()]
        covered = sorted(p for g in groups for p in g)
        if covered != list(range(len(covered))):
            raise ValueError(f"site pods must tile the pod axis, got {covered}")
        return groups

    def gateways(self) -> list:
        return [s.gateway for s in self._sites.values()]

    def site_of_pod(self, pod: int) -> Site:
        for s in self._sites.values():
            if pod in s.pods:
                return s
        raise KeyError(f"pod {pod} belongs to no site")

    # -- route planning ------------------------------------------------------
    def route(self, src: str, dst: str, metric: str = "latency",
              avoid: frozenset = frozenset()) -> Route:
        """Plan a route src -> dst; raises KeyError when disconnected.

        ``avoid`` holds extra directed ``(a, b)`` pairs treated as down for
        this search only — callers (e.g. the serving tier's reroute path)
        can steer around a faulted hop without mutating the topology.
        """
        if metric not in ("hops", "latency", "width"):
            raise ValueError(f"unknown metric {metric!r}")
        for n in (src, dst):
            if n not in self._sites:
                raise KeyError(f"unknown site {n!r}")
        if src == dst:
            # a 0-hop Route would silently degrade (WidePath.hops=() means
            # "implicit single hop", i.e. a real ring shift, not a no-op)
            raise ValueError(f"route {src} -> {dst}: src and dst coincide")
        prev = self._search(src, dst, metric, avoid)
        if dst not in prev:
            raise KeyError(f"no route {src} -> {dst}")
        names = [dst]
        while names[-1] != src:
            names.append(prev[names[-1]])
        names.reverse()
        profiles, shifts = [], []
        for a, b in zip(names, names[1:]):
            profiles.append(self._links[(a, b)])
            shifts.append(self._sites[b].gateway - self._sites[a].gateway)
        return Route(tuple(names), tuple(profiles), tuple(shifts))

    def _search(self, src: str, dst: str, metric: str,
                avoid: frozenset = frozenset()) -> dict:
        # Dijkstra over (cost, site); "hops" degenerates to BFS via unit cost
        def edge_cost(prof: LinkProfile) -> float:
            if metric == "hops":
                return 1.0
            if metric == "latency":
                return prof.latency_s
            return 0.0                      # width handled via bottleneck key

        def merge(acc: float, prof: LinkProfile) -> float:
            if metric == "width":           # cost = -bottleneck bandwidth
                return max(acc, -prof.bandwidth_Bps)
            return acc + edge_cost(prof)

        start_cost = -float("inf") if metric == "width" else 0.0
        best = {src: start_cost}
        prev: dict[str, str] = {}
        q: list = [(start_cost, src)]
        while q:
            cost, u = heapq.heappop(q)
            if cost > best.get(u, float("inf")):
                continue
            if u == dst:
                break
            for (a, b), prof in self._links.items():
                if a != u or (a, b) in self._down or (a, b) in avoid:
                    continue
                c = merge(cost, prof)
                if c < best.get(b, float("inf")):
                    best[b] = c
                    prev[b] = u
                    heapq.heappush(q, (c, b))
        return prev


class Forwarder:
    """The paper's Forwarder: relays traffic between sites with no direct
    connectivity by composing per-hop :class:`~repro_torch.core.path.WidePath`
    transfers with store-and-forward semantics.

    Holds the planned :class:`Route` and the compiled multi-hop ``path``;
    calling the forwarder inside the manual-DP shard_map relays a pytree
    end to end (each hop re-chunks with its own knobs — a relay site holds
    the full message before sending it on, as the real Forwarder process
    does with its receive/send buffer pair).
    """

    def __init__(self, topo: Topology, src: str, dst: str, *,
                 metric: str = "latency", axis: str = "pod",
                 comm: Optional[CommConfig] = None,
                 name: Optional[str] = None) -> None:
        self.topo = topo
        self.src, self.dst = src, dst
        self.route = topo.route(src, dst, metric)
        base = WidePath(axis=axis, comm=comm or CommConfig(),
                        name=name or f"fwd-{src}-{dst}")
        self.path = base.with_hops(self.route.as_hops(base_comm=comm))

    def __call__(self, tree, dims=None):
        # note: `from repro_torch.core import cycle` would resolve to the cycle()
        # *function* the package re-exports, not the module
        from repro_torch.core.cycle import forward
        return forward(tree, self.path, dims=dims)

    def modeled_s(self, nbytes: float) -> float:
        return self.route.modeled_s(nbytes)

    def describe(self) -> str:
        return self.route.describe()


def cosmogrid_topology(pods_per_site: int = 1,
                       backup_links: bool = False) -> Topology:
    """The 4-site CosmoGrid-style testbed (arXiv:1101.0605): a star around
    Amsterdam — the 10 Gbps light path to Tokyo, and regular internet to
    Espoo and Edinburgh.  Tokyo<->Espoo has *no* direct link: reaching it is
    the paper's Forwarder scenario (2 hops via Amsterdam).

    `backup_links=True` adds a slow commodity-internet Tokyo<->Edinburgh
    link (the chaos scenarios' detour): when the Amsterdam-Tokyo light path
    dies, routing can heal around it instead of declaring Tokyo lost."""
    t = Topology()
    for name in ("amsterdam", "tokyo", "espoo", "edinburgh"):
        t.add_site(name, n_pods=pods_per_site)
    t.connect("amsterdam", "tokyo",
              LinkProfile("ams-tokyo-lightpath", 135e-3, 1.25e9,
                          window=4 << 20, streams=16, chunk_mb=16.0))
    t.connect("amsterdam", "espoo",
              LinkProfile("ams-espoo", 22e-3, 115e6, window=64 << 10,
                          streams=64, chunk_mb=8.0))
    t.connect("amsterdam", "edinburgh",
              LinkProfile("ams-edinburgh", 14e-3, 90e6, window=64 << 10,
                          streams=64, chunk_mb=8.0))
    if backup_links:
        t.connect("tokyo", "edinburgh",
                  LinkProfile("tokyo-edinburgh-backup", 160e-3, 60e6,
                              window=64 << 10, streams=64, chunk_mb=4.0))
    return t
