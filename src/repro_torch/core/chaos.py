"""Chaos layer: fault injection, detection, and self-healing routing.

The port of the JAX package's ``core/chaos.py``.  It is host-only and a
copy, the package name in its imports aside:

  * :class:`IncidentLog`: a process-global, step-ordered record of every
    fault event and every automatic response (inject -> detect -> replan /
    failover -> recover), with recovery latency.  ``MPW.Report`` appends it
    as the incident timeline; ``MPW.Incidents`` returns the raw rows.
  * :class:`ChaosDetector`: telemetry-side anomaly detection: a per-key
    baseline (median of healthy samples) plus a consecutive-sample window;
    a hop whose modeled seconds collapse by ``collapse``x (or hit the
    absolute timeout, a dead link) for ``window`` samples in a row fires
    once.
  * :class:`ChaosMonitor`: the trainer-side controller.  Hooked into the
    Trainer between steps, it simulates each route hop under the fault
    schedule (:func:`repro_torch.core.autotune.simulate_hop_s`), records
    the result as telemetry, and on detection: reverts any in-flight tuner
    probe, takes the dead link out of the topology, replans the route
    (``Trainer.apply_route``) or, when the far site is unreachable on any
    route, fails the trainer over to its checkpoint replica
    (``Trainer.failover_to_replica``).
  * :func:`healing_transfer` / :func:`link_fault_hook`: the file-transfer
    side: chunks crossing a faulty hop fail their CRC; when retries
    exhaust, the engine's reroute callback replans around the hop and
    requeues the remaining chunks.

Determinism: every fault is a :class:`repro_torch.core.topology.Fault`
schedule (step ranges + integer seeds), the simulator is seeded, and events
are stamped with *steps*, not wall time, so a chaos scenario replays
bit-identically from its script.  The port's Trainer runs one process per
rank, each with its own monitor and incident log: they reach the same
decisions at the same steps because every input is such a schedule, and
the Trainer checks that they did (``runtime/train_loop.py``).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from statistics import median
from typing import Callable, Optional

from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import _lcg01, simulate_hop_s
from repro_torch.core.retry import RetryPolicy
from repro_torch.core.topology import Route, Topology


# ---------------------------------------------------------------------------
# incident timeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Incident:
    """One timeline row: what happened, to which link/route, at which step."""
    step: int
    kind: str
    subject: str                  # "a->b" link or route the event is about
    detail: dict = field(default_factory=dict)
    seq: int = 0                  # global arrival order (capped-log merge key)


class IncidentLog:
    """Step-ordered, thread-safe record of faults and responses.

    Event kinds (the timeline's vocabulary):
      * ``inject``   — a scheduled fault became active
      * ``detect``   — the detector (throughput collapse / timeout) or the
                       transfer engine (checksum exhaustion) flagged a hop
      * ``replan``   — the topology found a detour; new route in `detail`
      * ``retune``   — tuners restarted on the replanned route
      * ``requeue``  — a file job moved its remaining chunks to the new route
      * ``failover`` — no route left: the trainer fell back to its replica
      * ``recover``  — the system has been healthy for the post-heal window;
                       `detail["latency_steps"]` is recover - inject
      * ``evict``    — a site's liveness lease expired: removed from the
                       membership (``core/membership.py``)
      * ``join``     — a site (re)joined the membership
      * ``leave``    — a site left gracefully (drained, not evicted)
      * ``resize``   — the trainer re-formed its world on an epoch change
      * ``catchup``  — a rejoining site restored state from the replica
      * ``timeout``  — a serving request blew its ``deadline_steps`` and was
                       terminated (``core/serving.py``)
      * ``shed``     — admission control rejected a request (queue full, or
                       the modeled completion already blows the deadline)
      * ``reship``   — a KV ship failed on a faulted hop and is being
                       retried on the same route after a seeded backoff
      * ``reroute``  — KV shipping exhausted ``max_reships`` and replanned
                       over the topology's surviving links
      * ``serve_failover`` — the batcher moved its prefill/decode role off
                       an evicted site; in-flight requests drained to QUEUED
      * ``degrade``  — no cross-site route survives: the serving tier fell
                       back to collocated mono-site serving

    Storage is a capped ring buffer *per kind*: the first `keep_first` and
    last `keep_last` events of each kind are retained, the middle is
    dropped (counted in :meth:`dropped`).  A million-step run with a
    flapping link keeps ``MPW.Report(formatted=True)`` O(1) instead of
    accumulating one row per flap; short runs (fewer than
    ``keep_first + keep_last`` events per kind — every golden-timeline
    test) see the identical, complete timeline.
    """

    KINDS = ("inject", "detect", "replan", "retune", "requeue", "failover",
             "recover", "evict", "join", "leave", "resize", "catchup",
             "timeout", "shed", "reship", "reroute", "serve_failover",
             "degrade")

    def __init__(self, keep_first: int = 64, keep_last: int = 64) -> None:
        self._lock = threading.Lock()
        self.keep_first = max(1, int(keep_first))
        self.keep_last = max(1, int(keep_last))
        self._seq = 0
        self._head: dict[str, list] = {}
        self._tail: dict[str, deque] = {}
        self._dropped: dict[str, int] = {}

    def add(self, step: int, kind: str, subject: str,
            detail: Optional[dict] = None) -> Incident:
        if kind not in self.KINDS:
            raise ValueError(f"unknown incident kind {kind!r}")
        with self._lock:
            self._seq += 1
            ev = Incident(int(step), kind, subject, dict(detail or {}),
                          self._seq)
            head = self._head.setdefault(kind, [])
            if len(head) < self.keep_first:
                head.append(ev)
            else:
                tail = self._tail.setdefault(
                    kind, deque(maxlen=self.keep_last))
                if len(tail) == self.keep_last:
                    self._dropped[kind] = self._dropped.get(kind, 0) + 1
                tail.append(ev)
        return ev

    def events(self, kind: Optional[str] = None) -> list:
        with self._lock:
            evs = []
            for k, head in self._head.items():
                evs.extend(head)
                evs.extend(self._tail.get(k, ()))
        evs.sort(key=lambda e: e.seq)      # global arrival order
        return [e for e in evs if e.kind == kind] if kind else evs

    def dropped(self, kind: Optional[str] = None) -> int:
        """Events elided by the ring buffer (0 on any short run)."""
        with self._lock:
            if kind is not None:
                return self._dropped.get(kind, 0)
            return sum(self._dropped.values())

    def timeline(self) -> list[dict]:
        """JSON-friendly rows (what ``MPW.Incidents()`` returns and the CI
        chaos job uploads as its artifact)."""
        return [{"step": e.step, "event": e.kind, "subject": e.subject,
                 "detail": dict(e.detail)} for e in self.events()]

    def recovery_latencies(self) -> list[tuple[str, int]]:
        """(subject, latency in steps) per completed incident."""
        return [(e.subject, int(e.detail.get("latency_steps", 0)))
                for e in self.events("recover")]

    def format_timeline(self) -> str:
        """Markdown table of the timeline (the `MPW.Report` appendix)."""
        evs = self.events()
        if not evs:
            return "(no incidents)"
        rows = ["| step | event | subject | detail |",
                "|---|---|---|---|"]
        for e in evs:
            det = " ".join(f"{k}={e.detail[k]}" for k in sorted(e.detail))
            rows.append(f"| {e.step} | {e.kind} | {e.subject} | {det} |")
        n_drop = self.dropped()
        if n_drop:
            rows.append(f"| … | (elided) | — | {n_drop} events dropped by "
                        f"the ring buffer |")
        return "\n".join(rows)

    def clear(self) -> None:
        with self._lock:
            self._seq = 0
            self._head.clear()
            self._tail.clear()
            self._dropped.clear()


_LOG = IncidentLog()


def get_incident_log() -> IncidentLog:
    return _LOG


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

class ChaosDetector:
    """Per-key throughput-collapse detector over telemetry samples.

    A key's *baseline* is the median of its healthy samples (available once
    `min_baseline` have arrived).  A sample is anomalous when it exceeds
    ``collapse * baseline`` — or ``abs_timeout_s`` regardless of baseline
    (a dead link models as the watchdog timeout, which must be detectable
    even before a baseline exists).  `window` consecutive anomalies fire
    the detector once per key (re-arm with :meth:`reset`).

    A mild degrade below the collapse factor deliberately does *not* fire:
    slow-but-alive links are the online tuner's job; re-routing is reserved
    for collapse and death.

    Hysteresis: a fired key stays latched while samples are unhealthy, but
    `rearm_after` *consecutive healthy* samples un-latch it — a path that
    healed (link restored, detour absorbed the traffic) can alarm again on
    a later, distinct fault instead of going permanently blind.
    """

    def __init__(self, collapse: float = 8.0, window: int = 3,
                 min_baseline: int = 2,
                 abs_timeout_s: Optional[float] = None,
                 rearm_after: int = 8) -> None:
        self.collapse = float(collapse)
        self.window = max(1, int(window))
        self.min_baseline = max(1, int(min_baseline))
        self.abs_timeout_s = abs_timeout_s
        self.rearm_after = max(1, int(rearm_after))
        self._state: dict[str, dict] = {}

    def _anomalous(self, st: dict, seconds: float) -> bool:
        if self.abs_timeout_s is not None and seconds >= self.abs_timeout_s:
            return True
        if len(st["good"]) >= self.min_baseline:
            return seconds >= self.collapse * max(median(st["good"]), 1e-12)
        return False

    def observe(self, key: str, seconds: float) -> bool:
        """Feed one sample; True exactly when the key trips the detector."""
        st = self._state.setdefault(
            key, {"good": [], "bad": 0, "fired": False, "heal": 0})
        seconds = float(seconds)
        bad = self._anomalous(st, seconds)
        if st["fired"]:
            # latched: never re-fire on the *same* incident, but count
            # healthy samples toward re-arming (hysteresis)
            if bad:
                st["heal"] = 0
                return False
            st["heal"] += 1
            st["good"].append(seconds)
            del st["good"][:-32]
            if st["heal"] >= self.rearm_after:
                st["fired"] = False
                st["bad"] = 0
                st["heal"] = 0
            return False
        if bad:
            st["bad"] += 1
            if st["bad"] >= self.window:
                st["fired"] = True
                st["heal"] = 0
                return True
        else:
            st["bad"] = 0
            st["good"].append(seconds)
            del st["good"][:-32]          # rolling healthy window
        return False

    def baseline(self, key: str) -> Optional[float]:
        st = self._state.get(key)
        if not st or len(st["good"]) < self.min_baseline:
            return None
        return median(st["good"])

    def reset(self, key: Optional[str] = None) -> None:
        if key is None:
            self._state.clear()
        else:
            self._state.pop(key, None)


# ---------------------------------------------------------------------------
# trainer-side monitor: watch -> detect -> heal
# ---------------------------------------------------------------------------

class ChaosMonitor:
    """Self-healing controller for a routed :class:`~repro_torch.runtime.
    train_loop.Trainer` (pass as ``Trainer(chaos=...)``).

    Once per executed step (between steps — mid-step-safe by construction)
    it simulates every hop of the live route under the fault schedule,
    records the modeled seconds as hop telemetry (a dead link shows up as
    the watchdog timeout; a degraded one as achieved-GB/s collapse), and
    feeds the detector.  On detection it responds in order:

      1. revert any in-flight autotuner probe (its cost window measured a
         dying path);
      2. take the dead link (and any partitioned site) out of the topology;
      3. replan ``src -> dst``: a detour found means ``apply_route`` (the
         tuner restarts its climb on the new route = re-tune); no route
         left means ``failover_to_replica``;
      4. after `recover_after` consecutive healthy steps, record the
         ``recover`` event with the incident's latency in steps.

    With a :class:`~repro_torch.core.membership.SiteMembership` attached
    (``membership=``), the monitor also escalates: every detected fault
    marks the sites behind the dead hop *suspect* (their lease clock
    starts), and the membership's own per-step probing evicts them when
    the fault outlives the lease — the trainer then resizes its world
    instead of hammering a dead site forever.
    """

    def __init__(self, topo: Topology, src: str, dst: str, *,
                 metric: str = "latency",
                 detector: Optional[ChaosDetector] = None,
                 log: Optional[IncidentLog] = None,
                 payload_bytes: Optional[int] = None,
                 timeout_s: float = 30.0, recover_after: int = 2,
                 membership=None,
                 seed: int = 0) -> None:
        self.topo = topo
        self.src, self.dst = src, dst
        self.metric = metric
        self.timeout_s = float(timeout_s)
        self.detector = detector or ChaosDetector(abs_timeout_s=self.timeout_s)
        if self.detector.abs_timeout_s is None:
            self.detector.abs_timeout_s = self.timeout_s
        self.log = log or get_incident_log()
        self.payload_bytes = payload_bytes
        self.recover_after = max(1, int(recover_after))
        self.membership = membership
        self.seed = int(seed)
        self._injected: set[tuple] = set()
        self._inject_ticks: dict[str, tuple] = {}   # subject -> (step, tick)
        # guards _pending/_tick: the mirror/file-transfer threads call back
        # into the monitor while the trainer thread drives on_step
        self._state_lock = threading.Lock()
        self._pending: Optional[dict] = None   # incident awaiting recovery
        # monotonic count of on_step calls: latency is measured on this, not
        # on trainer.step, which rolls BACK when a failover restores an
        # older checkpoint (a latency of recover_step - inject_step could
        # go negative across a rollback; elapsed ticks cannot)
        self._tick = 0

    # -- the per-step hook ---------------------------------------------------
    def on_step(self, trainer, log: Callable[[str], None] = print) -> None:
        with self._state_lock:
            self._tick += 1
        step = trainer.step
        if self.membership is not None:
            # liveness probing runs even while failed over (route None):
            # lease expiry and rejoin detection must not stall with the
            # data plane
            self.membership.on_step(step)
        self._heal_progress(trainer, step)
        route = trainer.route
        if route is None:                 # failed over: nothing to watch
            return
        path = trainer.bundle.path
        t = tel.get_telemetry()
        nbytes = self.payload_bytes
        if nbytes is None:
            plan = t.path(path.key).plan
            nbytes = ((plan.wire_bytes or plan.payload_bytes) if plan
                      else 64 << 20)
        bad: Optional[int] = None
        for i, prof in enumerate(route.profiles):
            a, b = route.sites[i], route.sites[i + 1]
            self._note_injections(prof, a, b, step)
            secs = simulate_hop_s(nbytes, prof, step,
                                  timeout_s=self.timeout_s, seed=self.seed)
            key = path.hop_key(i)
            t.record(key, secs, step=step)
            if self.detector.observe(key, secs) and bad is None:
                bad = i
        if bad is not None:
            self._respond(trainer, route, bad, step, log)

    # -- mechanics -----------------------------------------------------------
    def _note_injections(self, prof, a: str, b: str, step: int) -> None:
        for f in prof.faults:
            fkey = (a, b, f.kind, f.start, f.stop)
            if f.active(step) and fkey not in self._injected:
                self._injected.add(fkey)
                self._inject_ticks.setdefault(f"{a}->{b}", (step, self._tick))
                detail = {"kind": f.kind, "link": prof.name, "start": f.start}
                if f.site:
                    detail["site"] = f.site
                if f.kind == "degrade":
                    detail["factor"] = f.factor
                    detail["error_rate"] = f.error_rate
                self.log.add(step, "inject", f"{a}->{b}", detail)

    def _respond(self, trainer, route: Route, hop: int, step: int,
                 log: Callable[[str], None]) -> None:
        a, b = route.sites[hop], route.sites[hop + 1]
        subject = f"{a}->{b}"
        health = route.profiles[hop].health(step)
        self.log.add(step, "detect", subject, {
            "hop": hop, "link": route.profiles[hop].name,
            "signal": "timeout" if not health.alive else "collapse",
            "window": self.detector.window})
        if trainer.tuner is not None:
            reverted = trainer.tuner.abort_probe()
            if reverted is not None:
                trainer._retune(reverted, log)   # re-pin the incumbent
        try:
            self.topo.fail_link(a, b)
        except KeyError:
            pass
        for site in health.partitioned:
            self.topo.fail_site(site)
        new_route: Optional[Route] = None
        if self.src not in health.partitioned \
                and self.dst not in health.partitioned:
            try:
                new_route = self.topo.route(self.src, self.dst, self.metric)
            except (KeyError, ValueError):
                new_route = None
        if self.membership is not None:
            # escalate: the far endpoint and every partitioned site start
            # their lease clock; membership probing evicts them if the
            # fault outlives the lease
            for site in {b, *health.partitioned} - {self.src}:
                self.membership.suspect(site, step, reason="route-fault")
        inject_step, inject_tick = self._inject_ticks.get(
            subject, (step, self._tick))
        if new_route is not None:
            self.log.add(step, "replan", f"{self.src}->{self.dst}",
                         {"route": new_route.describe()})
            trainer.apply_route(new_route, log=log)
            knobs = (trainer.tuner.config() if trainer.tuner is not None
                     else {"hops": new_route.n_hops})
            tel.get_telemetry().path(trainer.bundle.path.key).note_retune(
                step, dict(knobs))
            self.log.add(step, "retune", f"{self.src}->{self.dst}",
                         {"knobs": knobs})
            mode = "reroute"
        else:
            outcome = trainer.failover_to_replica(log=log)
            self.log.add(step, "failover", self.dst,
                         {"outcome": outcome, "resume_step": trainer.step})
            mode = "failover"
        with self._state_lock:
            self._pending = {"subject": subject, "inject_step": inject_step,
                             "inject_tick": inject_tick, "detect_step": step,
                             "streak": 0, "mode": mode}

    def _heal_progress(self, trainer, step: int) -> None:
        p = self._pending
        if p is None:
            return
        route = trainer.route
        healthy = True
        if route is not None:
            healthy = all(not prof.health(step).faulty
                          for prof in route.profiles)
        if not healthy:
            p["streak"] = 0
            return
        p["streak"] += 1
        if p["streak"] >= self.recover_after:
            self.log.add(step, "recover", p["subject"],
                         {"inject_step": p["inject_step"],
                          "detect_step": p["detect_step"],
                          "latency_steps": self._tick - p["inject_tick"],
                          "mode": p["mode"]})
            with self._state_lock:
                self._pending = None


# ---------------------------------------------------------------------------
# file-transfer-side healing
# ---------------------------------------------------------------------------

def _flip(payload: bytes) -> bytes:
    """Deterministically corrupt a chunk payload (first byte inverted)."""
    if not payload:
        return b"\xff"
    return bytes([payload[0] ^ 0xFF]) + payload[1:]


def link_fault_hook(route: Route, clock: Callable[[], int],
                    log: Optional[IncidentLog] = None) -> Callable:
    """``FileTransfer.fault_hook`` applying a route's fault schedules.

    A chunk crossing a hop whose link is dead at ``clock()`` is corrupted
    (its CRC fails at the relay — exactly how a dead socket surfaces to the
    data plane); a degraded hop corrupts a deterministic ``error_rate``
    fraction of chunks, keyed by the fault seed and the chunk index.  The
    first corruption per hop records the ``inject`` incident.
    """
    ilog = log or get_incident_log()
    injected: set[str] = set()

    def hook(chunk, hop_index: int, payload: bytes) -> bytes:
        if hop_index >= len(route.profiles):
            return payload
        step = clock()
        health = route.profiles[hop_index].health(step)
        corrupt = (not health.alive
                   or (health.error_rate > 0.0
                       and _lcg01(health.seed + 7919 * chunk.leaf)
                       < health.error_rate))
        if not corrupt:
            return payload
        subject = f"{route.sites[hop_index]}->{route.sites[hop_index + 1]}"
        if subject not in injected:
            injected.add(subject)
            ilog.add(step, "inject", subject,
                     {"kind": "drop" if not health.alive else "degrade",
                      "link": route.profiles[hop_index].name})
        return _flip(payload)

    return hook


def healing_transfer(topo: Topology, src: str, dst: str, *,
                     comm=None, metric: str = "latency",
                     clock: Optional[Callable[[], int]] = None,
                     log: Optional[IncidentLog] = None,
                     retry: Optional[RetryPolicy] = None, **engine_kw):
    """A self-healing mpw-cp engine over ``topo``'s ``src -> dst`` route.

    The engine's ``fault_hook`` applies the route profiles' fault schedules
    at ``clock()`` and its ``reroute`` callback closes the healing loop:
    when a chunk exhausts its CRC retries on a hop, the hop's link is taken
    out of the topology, the route is replanned, the engine's path and
    fault hook move to the detour, and the job requeues its remaining
    chunks — each stage recorded in the incident log (detect via checksum
    exhaustion -> replan -> requeue).  When no detour exists the callback
    declines and :class:`~repro_torch.core.filetransfer.ChecksumError` propagates
    as before.

    Retry behavior (per-chunk CRC re-reads *and* the pause before a
    requeue lands on the replanned route) follows one
    :class:`~repro_torch.core.retry.RetryPolicy` — exponential backoff instead
    of the old immediate-requeue hammering of a degraded link; the
    modeled backoff seconds appear in the ``requeue`` incident detail.
    """
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.filetransfer import FileTransfer
    from repro_torch.core.path import WidePath

    ilog = log or get_incident_log()
    clock = clock or (lambda: 0)
    retry = retry or RetryPolicy(
        max_attempts=engine_kw.pop("max_retries", 3) + 1)
    route = topo.route(src, dst, metric)
    base = WidePath(axis="pod", comm=comm or CommConfig(),
                    name=f"heal-{src}-{dst}")
    state = {"route": route, "reroute_n": 0}

    def reroute(engine, failed_hop: int) -> bool:
        r = state["route"]
        if failed_hop >= len(r.profiles):
            return False
        a, b = r.sites[failed_hop], r.sites[failed_hop + 1]
        step = clock()
        errors = tel.get_telemetry().path(
            engine.path.hop_key(failed_hop)).checksum_errors
        ilog.add(step, "detect", f"{a}->{b}",
                 {"signal": "checksum", "errors": errors,
                  "link": r.profiles[failed_hop].name})
        try:
            topo.fail_link(a, b)
            new_route = topo.route(src, dst, metric)
        except (KeyError, ValueError):
            return False
        ilog.add(step, "replan", f"{src}->{dst}",
                 {"route": new_route.describe()})
        state["route"] = new_route
        engine.path = base.with_hops(new_route.as_hops(base_comm=comm))
        engine.fault_hook = link_fault_hook(new_route, clock, log=ilog)
        if engine.tuner is not None:
            engine.tuner.abort_probe()
        state["reroute_n"] += 1
        backoff = retry.delay_s(state["reroute_n"], key=failed_hop)
        ilog.add(step, "requeue", f"{src}->{dst}",
                 {"hops": new_route.n_hops,
                  "backoff_s": round(backoff, 4)})
        return True

    engine = FileTransfer(base.with_hops(route.as_hops(base_comm=comm)),
                          reroute=reroute, retry=retry, **engine_kw)
    engine.fault_hook = link_fault_hook(route, clock, log=ilog)
    return engine
