"""Elastic site membership: lease-based liveness, epochs, quorum.

The port's copy of the JAX package's ``core/membership.py`` (host-only;
only the package name in its imports differs).

MPWide's flagship runs (CosmoGrid: four supercomputers, two continents)
are long enough that a site *will* drop out mid-run.  The chaos layer
(``core/chaos.py``) heals a dead link by re-routing, but the world itself
stayed static: a site that is gone for good kept its slot in every
collective.  This module makes the world elastic:

  * **Leases** — every site's liveness is a lease renewed by deterministic
    heartbeat probes, modeled over the existing :class:`~repro_torch.core.
    topology.LinkProfile` hops on the chaos fault clock (steps — never
    wall time, mpwlint R5).  A probe that times out marks the site
    *suspect*; a fault that outlives ``lease_steps`` evicts it.
  * **Epochs** — the membership version.  Strictly monotonic: every
    *applied* join/leave/evict bumps it by exactly one; observers (the
    Trainer) compare epochs to know when to re-form their world.
  * **Quorum** — a configurable :class:`QuorumPolicy` over the *live*
    members only; evicted and departed sites can never satisfy it.
  * **Rejoin** — an evicted site whose links heal for ``rejoin_after``
    consecutive probes rejoins (catch-up from the replica is the
    Trainer's side — see ``runtime/train_loop.py``).

Probes retry per a :class:`~repro_torch.core.retry.RetryPolicy` before a
failure is reported, so a single modeled blip does not start the lease
clock.  All transitions land in the :class:`~repro_torch.core.chaos.
IncidentLog` (``evict`` / ``join`` / ``leave`` kinds), giving resize
scenarios the same golden-timeline determinism as link faults.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.autotune import simulate_hop_s
from repro_torch.core.retry import PROBE_RETRY, RetryPolicy
from repro_torch.core.topology import Topology

ACTIVE = "active"
SUSPECT = "suspect"      # lease clock running; still a member
EVICTED = "evicted"
LEFT = "left"            # graceful departure (drained, no fault)


@dataclass(frozen=True)
class QuorumPolicy:
    """Membership quorum: how many *live* sites a run needs to proceed.

    `required(total)` is ``max(min_sites, ceil(fraction * total))`` where
    `total` counts every site the membership has ever known — evicted and
    departed sites still raise the bar but can never help clear it.
    """
    min_sites: int = 1
    fraction: float = 0.5

    def __post_init__(self) -> None:
        if self.min_sites < 1:
            raise ValueError(
                f"QuorumPolicy.min_sites must be >= 1, got {self.min_sites}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"QuorumPolicy.fraction must be in [0, 1], got {self.fraction}")

    def required(self, total: int) -> int:
        return max(self.min_sites, math.ceil(self.fraction * max(0, total)))

    def satisfied(self, live: int, total: int) -> bool:
        return live >= self.required(total)


class SiteMembership:
    """Lease-based liveness over a :class:`~repro_torch.core.topology.Topology`.

    One designated `coordinator` site (the chief, in the workers/ps/chief
    sense) probes every other site once per step along the raw link graph
    — *raw* meaning fault schedules apply but administrative down-links do
    not, so a healed link on an evicted site is visible and drives rejoin.
    All state transitions are deterministic functions of (topology fault
    schedules, step, seed): a resize scenario replays bit-identically.

    The trainer-facing contract is the `epoch`: strictly monotonic,
    bumped by exactly one on every applied join/leave/evict.  Helpers
    (:meth:`member_pod_groups`, :meth:`member_gateways`) give the current
    epoch's collective subgroup in the shape the transfer engines take.
    """

    def __init__(self, topo: Topology, coordinator: str, *,
                 lease_steps: int = 4, rejoin_after: int = 3,
                 quorum: Optional[QuorumPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 probe_bytes: int = 1 << 20, timeout_s: float = 30.0,
                 seed: int = 0, log=None) -> None:
        if coordinator not in [s.name for s in topo.sites]:
            raise KeyError(f"unknown coordinator site {coordinator!r}")
        from repro_torch.core.chaos import get_incident_log
        self.topo = topo
        self.coordinator = coordinator
        self.lease_steps = max(1, int(lease_steps))
        self.rejoin_after = max(1, int(rejoin_after))
        self.quorum = quorum or QuorumPolicy()
        self.retry = retry or PROBE_RETRY
        self.probe_bytes = int(probe_bytes)
        self.timeout_s = float(timeout_s)
        self.seed = int(seed)
        self.log = log or get_incident_log()
        self.epoch = 0
        self._names = [s.name for s in topo.sites]
        self._state = {n: ACTIVE for n in self._names}
        self._suspect_since: dict[str, int] = {}
        self._streak: dict[str, int] = {}       # healthy probes while evicted
        self._last_step: Optional[int] = None

    # -- queries -------------------------------------------------------------
    def state(self, name: str) -> str:
        if name not in self._state:
            raise KeyError(f"unknown site {name!r}")
        return self._state[name]

    def members(self) -> list:
        """Live members, in site order (active + suspect: a suspect site
        still holds its lease)."""
        return [n for n in self._names
                if self._state[n] in (ACTIVE, SUSPECT)]

    def is_member(self, name: str) -> bool:
        return self.state(name) in (ACTIVE, SUSPECT)

    def evicted(self) -> list:
        return [n for n in self._names if self._state[n] == EVICTED]

    def has_quorum(self) -> bool:
        return self.quorum.satisfied(len(self.members()), len(self._names))

    def member_pod_groups(self) -> list:
        """`Topology.pod_groups` restricted to live members — the
        intra-site groups of the current epoch's collective."""
        groups = self.topo.pod_groups()
        return [g for s, g in zip(self.topo.sites, groups)
                if self._state[s.name] in (ACTIVE, SUSPECT)]

    def member_gateways(self) -> list:
        """Gateway pod per live member — the WAN exchange subgroup."""
        return [s.gateway for s in self.topo.sites
                if self._state[s.name] in (ACTIVE, SUSPECT)]

    # -- the per-step liveness pass ------------------------------------------
    def on_step(self, step: int) -> None:
        """Run one probe round at `step` (idempotent per step: the Trainer
        and an attached ChaosMonitor may both drive it)."""
        if self._last_step is not None and step <= self._last_step:
            return
        self._last_step = step
        for name in self._names:
            if name == self.coordinator:
                continue
            st = self._state[name]
            if st == LEFT:
                continue
            alive = self.probe(name, step)
            if st == ACTIVE and not alive:
                self.suspect(name, step, reason="probe-timeout")
            elif st == SUSPECT:
                if alive:
                    self._reinstate(name)
                elif step - self._suspect_since[name] >= self.lease_steps:
                    self.evict(name, step, reason="lease-expired")
            elif st == EVICTED:
                if alive:
                    self._streak[name] = self._streak.get(name, 0) + 1
                    if self._streak[name] >= self.rejoin_after:
                        self.join(name, step)
                else:
                    self._streak[name] = 0

    def probe(self, name: str, step: int) -> bool:
        """One heartbeat: modeled transfer of `probe_bytes` along every hop
        of the raw coordinator->site path, retried per the RetryPolicy.
        True iff some attempt completes under the watchdog timeout."""
        profiles = self._probe_path(name)
        if not profiles:
            return False
        key = self._names.index(name)
        for attempt, _delay in enumerate(self.retry.schedule(key=key)):
            ok = True
            for h, prof in enumerate(profiles):
                secs = simulate_hop_s(
                    self.probe_bytes, prof, step, timeout_s=self.timeout_s,
                    seed=self.seed + 31 * key + 7 * h + 104729 * attempt)
                if secs >= self.timeout_s:
                    ok = False
                    break
            if ok:
                return True
        return False

    def _probe_path(self, name: str) -> list:
        """Hop profiles of the shortest raw-graph path coordinator->site.
        BFS over `Topology.neighbors` (which ignores administrative downs —
        only the fault schedules decide what a probe sees)."""
        if name not in self._state:
            raise KeyError(f"unknown site {name!r}")
        prev: dict[str, str] = {}
        queue = [self.coordinator]
        seen = {self.coordinator}
        while queue:
            u = queue.pop(0)
            if u == name:
                break
            for v in self.topo.neighbors(u):
                if v not in seen:
                    seen.add(v)
                    prev[v] = u
                    queue.append(v)
        if name not in prev:
            return []
        hops = [name]
        while hops[-1] != self.coordinator:
            hops.append(prev[hops[-1]])
        hops.reverse()
        return [self.topo.link(a, b) for a, b in zip(hops, hops[1:])]

    # -- transitions (each applied one bumps the epoch by exactly 1) ---------
    def suspect(self, name: str, step: int, reason: str = "") -> bool:
        """Start `name`'s lease clock (no epoch bump — the site is still a
        member until the lease expires).  Idempotent while suspect."""
        if self.state(name) != ACTIVE or name == self.coordinator:
            return False
        self._state[name] = SUSPECT
        self._suspect_since[name] = step
        self.log.add(step, "detect", name,
                     {"signal": "lease", "reason": reason,
                      "lease_steps": self.lease_steps})
        return True

    def _reinstate(self, name: str) -> None:
        # the lease renewed before expiry: back to active, no epoch change
        self._state[name] = ACTIVE
        self._suspect_since.pop(name, None)

    def evict(self, name: str, step: int, reason: str = "") -> bool:
        """Remove a site whose fault outlived its lease.  Fails its links
        in the topology so route planning and the trainer's world resize
        see the same picture."""
        if name == self.coordinator:
            raise ValueError(
                f"cannot evict the coordinator site {name!r}")
        if self.state(name) not in (ACTIVE, SUSPECT):
            return False
        self._state[name] = EVICTED
        self._suspect_since.pop(name, None)
        self._streak[name] = 0
        self.topo.fail_site(name)
        self.epoch += 1
        self.log.add(step, "evict", name,
                     {"epoch": self.epoch, "reason": reason,
                      "members": self.members()})
        return True

    def leave(self, name: str, step: int) -> bool:
        """Graceful departure: the site drained and said goodbye — same
        resize as an evict, but it will not be probed for rejoin."""
        if name == self.coordinator:
            raise ValueError(
                f"cannot remove the coordinator site {name!r}")
        if self.state(name) not in (ACTIVE, SUSPECT):
            return False
        self._state[name] = LEFT
        self._suspect_since.pop(name, None)
        self.topo.fail_site(name)
        self.epoch += 1
        self.log.add(step, "leave", name,
                     {"epoch": self.epoch, "members": self.members()})
        return True

    def join(self, name: str, step: int) -> bool:
        """A site (re)joins: restore its links, bump the epoch.  The
        trainer notices the epoch change and runs replica catch-up before
        folding the site into the next delta sync."""
        if self.state(name) in (ACTIVE, SUSPECT):
            return False
        self._state[name] = ACTIVE
        self._streak.pop(name, None)
        self.topo.restore_site(name)
        self.epoch += 1
        self.log.add(step, "join", name,
                     {"epoch": self.epoch, "members": self.members()})
        return True
