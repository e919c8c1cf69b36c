"""Continuous-batching serving scheduler over WidePaths (deterministic).

The paper's third claim is "very fast connections in client-server
environments"; this module is the client-server tier's brain.  A
:class:`ContinuousBatcher` owns a fixed set of *decode slots* and fills free
slots from an admission-controlled request queue every step — instead of
running fixed batches to completion — while each admitted request walks the
disaggregated pipeline::

    queued -> prefill (site A) -> ship (KV over the WidePath) -> decode
           (site B) -> done

All time is a virtual step clock (one decode token per step per slot); WAN
legs take :func:`modeled_ship_steps` derived from the deterministic
alpha-beta link model (`repro_torch.core.autotune.simulate_transfer_s`) — no wall
clock anywhere, so a given arrival trace replays bit-identically (the golden
schedule test in tests/test_serving.py pins one).  The runtime engine
(`repro_torch.runtime.serving.ServingEngine`) drives the same bookkeeping with
*real* prefill/ship/decode work instead of modeled durations.

Fault tolerance (tests/test_serve_chaos.py pins the golden timeline):

* **Deadlines** — a request carries ``deadline_steps``; the per-step sweep
  moves anything older to the terminal ``TIMEOUT`` state, freeing whatever
  stage resource it held.
* **SLO-aware admission** — `submit` *sheds* (terminal ``SHED``) when the
  modeled queue + prefill + ship + decode delay under current link health
  already blows the deadline, so a degraded WAN degrades goodput gracefully
  instead of building an unbounded queue.
* **Fault-aware shipping** — a :class:`FaultAwareShipper` walks the
  topology route under the `LinkProfile` fault schedules: a failed hop
  retries through a seeded :class:`~repro_torch.core.retry.RetryPolicy`
  (``reship``), reroutes over surviving links after ``max_reships``
  (``reroute``, mirroring the file copier's ``healing_transfer``), and recovers to the
  primary route once it heals.
* **Serve failover** — on a `SiteMembership` eviction of the prefill or
  decode site, in-flight requests drain back to QUEUED and the role moves
  to a surviving member (``serve_failover``); with no surviving pair the
  batcher collocates both roles and flags itself ``degraded`` in
  :meth:`ContinuousBatcher.stats`.

Every transition lands in the :class:`~repro_torch.core.chaos.IncidentLog`
(kinds ``timeout``/``shed``/``reship``/``reroute``/``serve_failover``/
``degrade``) and therefore in ``MPW.Report``.

Thread-safety: `submit` may be called from a frontend thread while a driver
thread steps the clock, so every state transition runs under the instance
lock (mpwlint R2; an RLock — helpers re-enter it so their writes stay
lexically under a ``with`` block).
"""
from __future__ import annotations

import inspect
import math
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import simulate_hop_s, simulate_transfer_s
from repro_torch.core.path import WidePath
from repro_torch.core.retry import KVSHIP_RETRY, RetryPolicy

# request lifecycle states
QUEUED = "queued"        # admitted, waiting for a free decode slot
PREFILL = "prefill"      # slot claimed; waiting for / running site-A prefill
SHIP = "ship"            # KV cache in flight over the WidePath
DECODE = "decode"        # occupying a decode slot on site B
DONE = "done"
REJECTED = "rejected"    # admission: queue full
TIMEOUT = "timeout"      # blew its deadline_steps mid-flight
SHED = "shed"            # admission: modeled completion blows the deadline

_TERMINAL = (DONE, REJECTED, TIMEOUT, SHED)

# an unroutable ship models as "longer than any deadline" — the admission
# path sheds against it and the deadline sweep times out anything in flight
_UNROUTABLE_STEPS = 1 << 30
# safety cap on fault responses within one modeled ship: a schedule that
# keeps cutting every attempt ends the ship as failed instead of spinning
_MAX_SHIP_FAULTS = 64


@dataclass(frozen=True)
class Request:
    """One serving request (arrival is a virtual step index).

    ``deadline_steps`` is the SLO: the request must be DONE strictly fewer
    than that many steps after arrival, or the sweep times it out (None —
    no deadline)."""
    rid: int
    arrival: int
    prompt_len: int
    max_new: int
    deadline_steps: Optional[int] = None


@dataclass
class _Track:
    """Mutable per-request bookkeeping (timestamps are virtual steps)."""
    req: Request
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: int = 0                  # generated so far (first from prefill)
    t_prefill: Optional[int] = None  # prefill started
    t_ship: Optional[int] = None     # prefill done / ship started
    t_ship_end: Optional[int] = None
    t_decode: Optional[int] = None   # decode started == first token
    t_done: Optional[int] = None
    reships: int = 0                 # ship retries this request needed
    reroutes: int = 0                # route replans this request needed


def _wants_step(fn: Callable) -> bool:
    """Duration callables may take (req) or (req, step); the two-argument
    form gets the virtual step clock threaded through, so a modeled
    duration can consult the fault schedules."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return True
    return n >= 2


def modeled_ship_steps(kv_bytes: int, path: Optional[WidePath] = None,
                       step_s: float = 1e-2, *,
                       step: Optional[int] = None,
                       route=None, timeout_s: float = 30.0) -> int:
    """Virtual steps one request's KV cache spends on the wire.

    Sums the deterministic per-hop transfer model over the path's route
    (store-and-forward, like `Forward`), then quantizes to the decode step
    clock.  0 bytes ship for free (the monolithic baseline).

    With ``route`` (a :class:`~repro_torch.core.topology.Route`, whose hops carry
    `LinkProfile` fault schedules) and ``step``, the *fault clock* applies:
    a hop dead at `step` models as a transfer that hangs for ``timeout_s``
    (the watchdog), a degraded hop as proportionally less capacity — this
    is the naive "wait the fault out" model; :class:`FaultAwareShipper`
    layers retries and reroutes on top of it."""
    if kv_bytes <= 0:
        return 0
    if step_s <= 0:
        raise ValueError(f"step_s must be > 0 to quantize ship time, "
                         f"got {step_s}")
    total = 0.0
    if route is not None:
        at = 0 if step is None else int(step)
        for prof in route.profiles:
            total += simulate_hop_s(kv_bytes, prof, at, timeout_s=timeout_s)
        return max(1, int(math.ceil(total / step_s)))
    if path is None:
        raise ValueError(f"modeled_ship_steps needs a WidePath or a topology "
                         f"route, got path={path!r} route={route!r}")
    for hop in path.route:
        total += simulate_transfer_s(
            kv_bytes, hop.link, streams=hop.streams,
            chunk_bytes=hop.chunk_bytes, pacing=hop.comm.pacing)
    return max(1, int(math.ceil(total / step_s)))


def _percentile(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclass(frozen=True)
class ShipOutcome:
    """Result of one modeled fault-aware KV ship.

    ``events`` holds (kind, step, subject, detail) incident rows in
    occurrence order — the shipper replays them into the attached
    :class:`~repro_torch.core.chaos.IncidentLog`."""
    ok: bool
    steps: int
    modeled_s: float
    reships: int = 0
    reroutes: int = 0
    route: tuple = ()
    events: tuple = ()


class FaultAwareShipper:
    """Models KV-cache shipping src -> dst under the topology's fault
    schedules, with seeded retries and reroutes (deterministic, replayable).

    A ship walks the current route store-and-forward on the virtual step
    clock.  A hop that is dead at its start — or cut by a ``drop`` fault
    while the transfer is still on the wire — costs the elapsed progress
    plus the ``timeout_s`` watchdog, then retries after a seeded
    `RetryPolicy` backoff (``reship``); after ``max_reships`` failures on
    one hop the route replans from the stranded site over surviving links
    (``reroute``, mirroring the file copier's ``healing_transfer``).  When no route
    survives the ship reports ``ok=False`` and the batcher degrades to
    collocated serving.  Once every primary hop is healthy again
    :meth:`on_step` falls back to the primary route and logs ``recover``.

    Per-request modeled seconds/bytes land in telemetry under
    ``serve/req{rid}/kv``; reship/reroute counts via
    `telemetry.note_ship_retry`.
    """

    def __init__(self, topo, src: str, dst: str, *,
                 kv_bytes: Union[int, Callable[[Request], int]],
                 step_s: float = 1e-2, metric: str = "latency",
                 retry: Optional[RetryPolicy] = None, max_reships: int = 2,
                 timeout_s: float = 0.5, log=None, seed: int = 0,
                 name: str = "serve"):
        if step_s <= 0:
            raise ValueError(f"step_s must be > 0, got {step_s}")
        if max_reships < 0:
            raise ValueError(f"max_reships must be >= 0, got {max_reships}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.topo = topo
        self.src, self.dst = src, dst
        self.metric = metric
        self.step_s = float(step_s)
        self.timeout_s = float(timeout_s)
        self.max_reships = int(max_reships)
        self.retry = KVSHIP_RETRY if retry is None else retry
        self.log = log
        self.seed = int(seed)
        self.name = name
        self._kv_bytes = kv_bytes
        self._lock = threading.RLock()
        primary = topo.route(src, dst, metric)
        self._primary = (primary.sites, primary.profiles)
        self._names = primary.sites
        self._profiles = primary.profiles
        self._avoid: set = set()
        self._detour_step: Optional[int] = None
        self._last_inject: Optional[int] = None
        self._injected: set = set()
        self.reships = 0
        self.reroutes = 0

    # -- route state ---------------------------------------------------------
    @property
    def route_names(self) -> tuple:
        """Site names of the route the next ship will attempt."""
        with self._lock:
            return tuple(self._names)

    @property
    def detoured(self) -> bool:
        with self._lock:
            return self._detour_step is not None

    def can_route(self, src: str, dst: str,
                  avoid: frozenset = frozenset()) -> bool:
        """True when the topology still offers a src -> dst route."""
        try:
            self.topo.route(src, dst, self.metric, avoid=frozenset(avoid))
        except (KeyError, ValueError):
            return False
        return True

    def retarget(self, src: Optional[str] = None, dst: Optional[str] = None,
                 avoid: frozenset = frozenset()) -> bool:
        """Re-plan the primary route (serve failover moved an endpoint).
        Returns False — state untouched — when no route survives."""
        with self._lock:
            nsrc = self.src if src is None else src
            ndst = self.dst if dst is None else dst
            try:
                r = self.topo.route(nsrc, ndst, self.metric,
                                    avoid=frozenset(avoid))
            except (KeyError, ValueError):
                return False
            self.src, self.dst = nsrc, ndst
            self._primary = (r.sites, r.profiles)
            self._names, self._profiles = r.sites, r.profiles
            self._avoid = set(avoid)
            self._detour_step = None
            return True

    # -- fault bookkeeping ---------------------------------------------------
    def _note_injections(self, step: int) -> None:
        """Log `inject` once per fault the first time it is seen active on
        the primary or current route (mirrors ChaosMonitor)."""
        with self._lock:
            profs = {}
            for prof in tuple(self._primary[1]) + tuple(self._profiles):
                profs[prof.name] = prof
            for prof in profs.values():
                for f in prof.faults:
                    fkey = (prof.name, f.kind, f.start, f.stop)
                    if fkey in self._injected or not f.active(step):
                        continue
                    self._injected.add(fkey)
                    self._last_inject = int(step)
                    if self.log is not None:
                        self.log.add(step, "inject", prof.name,
                                     {"kind": f.kind, "start": f.start,
                                      "stop": f.stop, "factor": f.factor,
                                      "error_rate": f.error_rate})

    def on_step(self, step: int) -> None:
        """Per-step housekeeping: log newly-active faults; once every
        primary hop is healthy again, abandon the detour and log
        ``recover`` (latency measured from the fault injection)."""
        with self._lock:
            self._note_injections(step)
            if self._detour_step is None or self._last_inject is None:
                # a detour taken against a not-yet-active fault (the ship
                # simulated into the fault window) holds until the fault is
                # actually observed — reverting early would just re-detour
                return
            names, profiles = self._primary
            if not all(p.health(step).alive for p in profiles):
                return
            self._names, self._profiles = names, profiles
            self._avoid.clear()
            detour_at = self._detour_step
            self._detour_step = None
            since = detour_at if self._last_inject is None \
                else self._last_inject
            if self.log is not None:
                self.log.add(step, "recover", f"{self.src}->{self.dst}",
                             {"mode": "reroute",
                              "latency_steps": int(step - since)})

    # -- shipping ------------------------------------------------------------
    def _nbytes(self, req: Request) -> int:
        n = (self._kv_bytes(req) if callable(self._kv_bytes)
             else int(self._kv_bytes))
        if n < 0:
            raise ValueError(f"kv_bytes must be >= 0, got {n} "
                             f"for req{req.rid}")
        return n

    def estimate_steps(self, req: Request, step: int) -> int:
        """Modeled ship steps under the fault schedules at `step` — the
        admission model's view.  Never logs or mutates; an unroutable ship
        reports a deadline-blowing duration."""
        with self._lock:
            out = self._simulate(self._nbytes(req), int(step), req.rid)
        return out.steps if out.ok else _UNROUTABLE_STEPS

    def ship(self, req: Request, step: int) -> ShipOutcome:
        """Run the modeled ship at `step`: log reship/reroute incidents,
        commit a route change, record ``serve/req{rid}/kv`` telemetry."""
        with self._lock:
            self._note_injections(step)
            nbytes = self._nbytes(req)
            out = self._simulate(nbytes, int(step), req.rid)
            if self.log is not None:
                for kind, at, subject, detail in out.events:
                    self.log.add(at, kind, subject, detail)
            if out.ok:
                if out.reroutes:
                    self._commit_route(out.route, int(step))
                self.reships += out.reships
                self.reroutes += out.reroutes
                tel.record(f"serve/req{req.rid}/kv", out.modeled_s,
                           nbytes=nbytes, step=step)
                if out.reships or out.reroutes:
                    tel.note_ship_retry(f"serve/req{req.rid}/kv",
                                        reships=out.reships,
                                        reroutes=out.reroutes)
            return out

    def _commit_route(self, names: tuple, step: int) -> None:
        """Adopt a rerouted path for subsequent ships (until recovery)."""
        with self._lock:
            profiles = tuple(self.topo.link(a, b)
                             for a, b in zip(names, names[1:]))
            self._names = tuple(names)
            self._profiles = profiles
            if self._detour_step is None:
                self._detour_step = int(step)

    def _cut_step(self, prof, hop_step: int, nbytes: int) -> Optional[int]:
        """Step at which this hop attempt fails, or None when it completes.
        Dead at the start fails immediately; a drop activating while the
        transfer is still on the wire cuts it mid-ship."""
        if not prof.health(hop_step).alive:
            return hop_step
        secs = simulate_hop_s(nbytes, prof, hop_step,
                              timeout_s=self.timeout_s, seed=self.seed)
        last = hop_step + int(math.ceil(secs / self.step_s))
        for s in range(hop_step + 1, last + 1):
            if not prof.health(s).alive:
                return s
        return None

    def _simulate(self, nbytes: int, start_step: int, key: int) -> ShipOutcome:
        """Deterministically walk the current route hop by hop under the
        fault schedules (store-and-forward).  Pure with respect to shipper
        state: `ship` commits the outcome, `estimate_steps` discards it."""
        if nbytes <= 0:
            return ShipOutcome(True, 0, 0.0, route=tuple(self._names))
        names = list(self._names)
        profiles = list(self._profiles)
        avoid = set(self._avoid)
        events: list = []
        t = 0.0
        i = 0
        attempts = 0
        reships = reroutes = failures = 0
        while i < len(profiles):
            if failures > _MAX_SHIP_FAULTS:
                return ShipOutcome(False, _UNROUTABLE_STEPS, t, reships,
                                   reroutes, tuple(names), tuple(events))
            prof = profiles[i]
            hop_step = start_step + int(t / self.step_s)
            cut = self._cut_step(prof, hop_step, nbytes)
            if cut is None:
                t += simulate_hop_s(nbytes, prof, hop_step,
                                    timeout_s=self.timeout_s, seed=self.seed)
                i += 1
                attempts = 0
                continue
            # the attempt failed: progress up to the cut is lost, then the
            # watchdog burns timeout_s before the sender learns
            failures += 1
            t += (cut - hop_step) * self.step_s + self.timeout_s
            subject = f"{names[i]}->{names[i + 1]}"
            now = start_step + int(t / self.step_s)
            if attempts < self.max_reships:
                delay = self.retry.delay_s(attempts, key=key * 31 + i)
                t += delay
                attempts += 1
                reships += 1
                events.append(("reship", now, subject,
                               {"rid": key, "attempt": attempts,
                                "backoff_s": round(delay, 6)}))
                continue
            # reships exhausted: replan from the stranded site over
            # whatever still routes (the healing_transfer move)
            avoid.add((names[i], names[i + 1]))
            avoid.add((names[i + 1], names[i]))
            try:
                nr = self.topo.route(names[i], names[-1], self.metric,
                                     avoid=frozenset(avoid))
            except (KeyError, ValueError):
                return ShipOutcome(False, _UNROUTABLE_STEPS, t, reships,
                                   reroutes, tuple(names), tuple(events))
            reroutes += 1
            attempts = 0
            events.append(("reroute", now, subject,
                           {"rid": key, "route": list(nr.sites)}))
            names = names[:i] + list(nr.sites)
            profiles = profiles[:i] + list(nr.profiles)
        steps = max(1, int(math.ceil(t / self.step_s)))
        return ShipOutcome(True, steps, t, reships, reroutes,
                           tuple(names), tuple(events))


class ContinuousBatcher:
    """Slot-based continuous batching with admission control.

    Parameters
    ----------
    max_slots: decode slots (the fixed decode batch width).
    queue_limit: queued requests beyond which `submit` rejects.
    prefill_steps: virtual steps one prefill takes — an int, or a callable
        of the :class:`Request` (optionally ``(req, step)``).  Prefill is a
        single site-A server: one request prefills at a time, but the
        decode slots keep ticking underneath — the disaggregation win.
    ship_steps: virtual steps the KV ship takes (int or callable); use
        :func:`modeled_ship_steps` to derive it from a real WidePath.
    step_s: modeled wall seconds of one decode step (converts the virtual
        clock into latency/goodput figures; never read from a real clock).
    deadline_steps: default SLO for requests submitted without one (int or
        callable of the Request; None — no deadline).
    shed: when True (default) admission sheds requests whose modeled
        completion under current link health already blows their deadline.
    shipper: a :class:`FaultAwareShipper` — overrides `ship_steps` with the
        fault-aware model and drives reship/reroute/recover incidents.
    log: a :class:`~repro_torch.core.chaos.IncidentLog` every transition lands in.
    membership: a :class:`~repro_torch.core.membership.SiteMembership` ticked each
        step; eviction of `prefill_site`/`decode_site` triggers failover.
    prefill_site / decode_site: the serving roles' site names (failover
        bookkeeping; the shipper holds the actual route).
    """

    def __init__(self, max_slots: int, queue_limit: int = 64, *,
                 prefill_steps: Union[int, Callable[[Request], int]] = 1,
                 ship_steps: Union[int, Callable[[Request], int]] = 0,
                 step_s: float = 1e-2, name: str = "serve",
                 deadline_steps: Union[int, Callable[[Request], int],
                                       None] = None,
                 shed: bool = True,
                 shipper: Optional[FaultAwareShipper] = None,
                 log=None, membership=None,
                 prefill_site: Optional[str] = None,
                 decode_site: Optional[str] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if queue_limit < 0:
            raise ValueError(f"queue_limit must be >= 0, got {queue_limit}")
        if isinstance(deadline_steps, int) and deadline_steps < 1:
            raise ValueError(f"deadline_steps must be >= 1, "
                             f"got {deadline_steps}")
        self.max_slots = int(max_slots)
        self.queue_limit = int(queue_limit)
        self.step_s = float(step_s)
        self.name = name
        self._prefill_steps = prefill_steps
        self._ship_steps = ship_steps
        self._deadline_steps = deadline_steps
        self._shed = bool(shed)
        self._shipper = shipper
        self._log = log
        self._membership = membership
        self._prefill_site = prefill_site
        self._decode_site = decode_site
        self._home_prefill = prefill_site
        self._home_decode = decode_site
        self._member_epoch = membership.epoch if membership is not None else 0
        self._degraded = False
        self._reships = 0
        self._reroutes = 0
        self._failovers = 0
        self._lock = threading.RLock()
        self._step = 0                      # current virtual step
        self._next_rid = 0
        self._reqs: dict[int, _Track] = {}
        self._queue: list[int] = []         # FIFO of QUEUED rids
        self._slots: list[Optional[int]] = [None] * self.max_slots
        self._prefill_fifo: list[int] = []  # slotted rids awaiting prefill
        self._prefill_rid: Optional[int] = None   # rid on the prefill server
        self._prefill_end = 0
        self._events: list[list] = []       # [kind, "req{rid}", step]

    # -- helpers (call with self._lock held) --------------------------------
    def _emit(self, kind: str, rid: int, step: int) -> None:
        self._events.append([kind, f"req{rid}", step])

    def _n_steps(self, which, req: Request, step: int = 0) -> int:
        if callable(which):
            n = which(req, step) if _wants_step(which) else which(req)
        else:
            n = int(which)
        if n < 0:
            raise ValueError(f"modeled duration must be >= 0, got {n} "
                             f"for req{req.rid}")
        return n

    def _deadline_of(self, req: Request) -> Optional[int]:
        if req.deadline_steps is not None:
            return int(req.deadline_steps)
        d = self._deadline_steps
        if d is None:
            return None
        n = int(d(req)) if callable(d) else int(d)
        if n < 1:
            raise ValueError(f"deadline_steps must be >= 1, got {n} "
                             f"for req{req.rid}")
        return n

    def _modeled_completion_steps(self, req: Request, at: int) -> int:
        """Admission model: a lower bound on steps to completion under the
        current backlog and link health.  The prefill server is serial, so
        everything queued or slotted-but-unprefilled is ahead of this
        request; decode is one token per step; the ship estimate consults
        the fault schedules through the shipper when one is attached."""
        backlog = 0
        if self._prefill_rid is not None:
            backlog += max(0, self._prefill_end - at)
        for rid in self._prefill_fifo:
            backlog += max(1, self._n_steps(self._prefill_steps,
                                            self._reqs[rid].req, at))
        for rid in self._queue:
            backlog += max(1, self._n_steps(self._prefill_steps,
                                            self._reqs[rid].req, at))
        own = max(1, self._n_steps(self._prefill_steps, req, at))
        if self._degraded:
            ship = 0
        elif self._shipper is not None:
            ship = self._shipper.estimate_steps(req, at + backlog + own)
        else:
            ship = self._n_steps(self._ship_steps, req, at)
        return backlog + own + ship + max(0, req.max_new - 1)

    def _start_decode(self, tr: _Track, step: int) -> None:
        tr.state = DECODE
        tr.t_decode = step
        tr.tokens = 1          # first token rides on the prefill logits
        self._emit("decode", tr.req.rid, step)
        if tr.tokens >= tr.req.max_new:
            self._finish(tr, step)

    def _ship_duration(self, tr: _Track, step: int) -> int:
        """Modeled ship steps: 0 when degraded (collocated — no WAN leg),
        the fault-aware shipper's outcome when one is attached, else the
        static/callable `ship_steps`."""
        if self._degraded:
            return 0
        if self._shipper is None:
            return self._n_steps(self._ship_steps, tr.req, step)
        out = self._shipper.ship(tr.req, step)
        if not out.ok:
            self._enter_degraded(
                step, reason=f"req{tr.req.rid}: no surviving route")
            return 0
        with self._lock:
            tr.reships = out.reships
            tr.reroutes = out.reroutes
            self._reships += out.reships
            self._reroutes += out.reroutes
        return out.steps

    def _start_ship(self, tr: _Track, step: int) -> None:
        tr.state = SHIP
        tr.t_ship = step
        self._emit("ship", tr.req.rid, step)
        ss = self._ship_duration(tr, step)
        if ss == 0:
            self._start_decode(tr, step)
        else:
            tr.t_ship_end = step + ss

    def _finish(self, tr: _Track, step: int) -> None:
        tr.state = DONE
        tr.t_done = step
        if tr.slot is not None:
            self._slots[tr.slot] = None
            tr.slot = None
        self._emit("complete", tr.req.rid, step)

    def _timeout(self, tr: _Track, step: int) -> None:
        """Terminal: the request blew its deadline.  Frees whatever stage
        resource it held (queue position, prefill server, decode slot)."""
        with self._lock:
            rid = tr.req.rid
            stage = tr.state
            if tr.slot is not None:
                self._slots[tr.slot] = None
                tr.slot = None
            if self._prefill_rid == rid:
                self._prefill_rid = None
            if rid in self._queue:
                self._queue.remove(rid)
            if rid in self._prefill_fifo:
                self._prefill_fifo.remove(rid)
            tr.state = TIMEOUT
            tr.t_done = step
            self._emit("timeout", rid, step)
            if self._log is not None:
                self._log.add(step, "timeout", f"req{rid}",
                              {"stage": stage, "tokens": tr.tokens})

    def _enter_degraded(self, step: int, reason: str) -> None:
        """No cross-site route survives: collocate prefill+decode (ships
        become free) and flag it — `stats()["degraded"]`."""
        with self._lock:
            if self._degraded:
                return
            self._degraded = True
            if self._log is not None:
                self._log.add(step, "degrade", self.name, {"reason": reason})

    def _try_exit_degraded(self, step: int) -> None:
        """A membership epoch changed while degraded: re-disaggregate onto
        the home sites when both are members and a route survives."""
        ms, sh = self._membership, self._shipper
        hp, hd = self._home_prefill, self._home_decode
        if sh is None or hp is None or hd is None or hp == hd:
            return
        if ms is not None and not (ms.is_member(hp) and ms.is_member(hd)):
            return
        if not sh.retarget(src=hp, dst=hd):
            return
        with self._lock:
            self._prefill_site = hp
            self._decode_site = hd
            self._degraded = False
            if self._log is not None:
                self._log.add(step, "recover", f"{hp}->{hd}",
                              {"mode": "degrade"})

    def _drain_inflight(self, step: int) -> int:
        """Send every in-flight request back to QUEUED, front of the queue
        in rid order — prefill/ship work is lost, decode restarts."""
        with self._lock:
            drained = []
            for rid in sorted(self._reqs):
                tr = self._reqs[rid]
                if tr.state not in (PREFILL, SHIP, DECODE):
                    continue
                if tr.slot is not None:
                    self._slots[tr.slot] = None
                    tr.slot = None
                tr.state = QUEUED
                tr.tokens = 0
                tr.t_prefill = None
                tr.t_ship = None
                tr.t_ship_end = None
                tr.t_decode = None
                drained.append(rid)
                self._emit("requeue", rid, step)
            self._prefill_rid = None
            self._prefill_fifo.clear()
            self._queue[:0] = drained
            return len(drained)

    def _serve_failover(self, role: str, step: int) -> None:
        """Move a serving role off an evicted site: drain in-flight back to
        QUEUED and re-plan onto a surviving member (the chaos monitor's
        replan move applied to serving); with no surviving pair, collocate
        and degrade."""
        with self._lock:
            ms = self._membership
            old = (self._prefill_site if role == "prefill"
                   else self._decode_site)
            other = (self._decode_site if role == "prefill"
                     else self._prefill_site)
            new = None
            avoid: set = set()
            if self._shipper is not None and other is not None:
                evicted = set(ms.evicted())
                for e in evicted:
                    for nb in self._shipper.topo.neighbors(e):
                        avoid.add((e, nb))
                        avoid.add((nb, e))
                for m in ms.members():
                    if m == old or m == other:
                        continue
                    src = m if role == "prefill" else other
                    dst = other if role == "prefill" else m
                    if src != dst and self._shipper.can_route(
                            src, dst, frozenset(avoid)):
                        new = m
                        break
            drained = self._drain_inflight(step)
            self._failovers += 1
            if new is None:
                # no surviving disaggregated pair: collocate on the peer
                if role == "prefill":
                    self._prefill_site = other
                else:
                    self._decode_site = other
                if self._log is not None:
                    self._log.add(step, "serve_failover",
                                  f"{role}:{old}->{other}",
                                  {"requeued": drained, "epoch": ms.epoch,
                                   "collocated": True})
                self._enter_degraded(
                    step, reason=f"{role} site {old} evicted; "
                                 f"no surviving pair")
                return
            if role == "prefill":
                self._prefill_site = new
                self._shipper.retarget(src=new, dst=other,
                                       avoid=frozenset(avoid))
            else:
                self._decode_site = new
                self._shipper.retarget(src=other, dst=new,
                                       avoid=frozenset(avoid))
            if self._log is not None:
                self._log.add(step, "serve_failover", f"{role}:{old}->{new}",
                              {"requeued": drained, "epoch": ms.epoch})
            if self._degraded:
                # the new pair routes (can_route just said so): the
                # collocated fallback ends with this failover
                self._degraded = False
                if self._log is not None:
                    self._log.add(step, "recover",
                                  f"{self._prefill_site}->{self._decode_site}",
                                  {"mode": "degrade"})

    def _tick_membership(self, step: int) -> None:
        """Advance the liveness clock; on an epoch change, fail the serving
        roles over off any evicted site (or recover from degraded)."""
        ms = self._membership
        ms.on_step(step)
        if ms.epoch == self._member_epoch:
            return
        with self._lock:
            self._member_epoch = ms.epoch
            for role in ("prefill", "decode"):
                site = (self._prefill_site if role == "prefill"
                        else self._decode_site)
                if site is not None and not ms.is_member(site):
                    self._serve_failover(role, step)
            if self._degraded:
                self._try_exit_degraded(step)

    # -- public API ---------------------------------------------------------
    def degrade(self, step: Optional[int] = None, reason: str = "") -> None:
        """Enter the collocated mono-site fallback (the hook for runtime
        engines whose *real* KV ship failed with no surviving route)."""
        with self._lock:
            at = self._step if step is None else int(step)
            self._enter_degraded(at, reason or "runtime ship failed")

    def note_ship(self, rid: int, *, reships: int = 0,
                  reroutes: int = 0) -> None:
        """Account a *real* KV ship's retries/replans against the request
        and the scheduler counters (the hook for runtime engines that ship
        through `kvship.ship_kv` instead of the modeled shipper — without
        it `stats()['reships']` stays 0 while the incident log fills up)."""
        with self._lock:
            tr = self._reqs.get(rid)
            if tr is not None:
                tr.reships += int(reships)
                tr.reroutes += int(reroutes)
            self._reships += int(reships)
            self._reroutes += int(reroutes)

    def submit(self, prompt_len: int, max_new: int,
               step: Optional[int] = None, *,
               deadline_steps: Optional[int] = None) -> Optional[int]:
        """Admission control: enqueue a request, or reject it when the
        queue is full, or *shed* it when its modeled completion under
        current link health already blows its deadline.  Returns the rid,
        or None when rejected/shed."""
        if prompt_len < 1 or max_new < 1:
            raise ValueError(f"prompt_len and max_new must be >= 1, got "
                             f"prompt_len={prompt_len} max_new={max_new}")
        if deadline_steps is not None and int(deadline_steps) < 1:
            raise ValueError(f"deadline_steps must be >= 1, "
                             f"got {deadline_steps}")
        with self._lock:
            at = self._step if step is None else int(step)
            rid = self._next_rid
            self._next_rid = rid + 1
            req = Request(rid, at, int(prompt_len), int(max_new),
                          None if deadline_steps is None
                          else int(deadline_steps))
            tr = _Track(req)
            self._reqs[rid] = tr
            if len(self._queue) >= self.queue_limit:
                tr.state = REJECTED
                tr.t_done = at
                self._emit("reject", rid, at)
                if self._log is not None:
                    self._log.add(at, "shed", f"req{rid}",
                                  {"reason": "queue-full",
                                   "queued": len(self._queue)})
                return None
            deadline = self._deadline_of(req)
            if self._shed and deadline is not None:
                modeled = self._modeled_completion_steps(req, at)
                if modeled >= deadline:
                    tr.state = SHED
                    tr.t_done = at
                    self._emit("shed", rid, at)
                    if self._log is not None:
                        self._log.add(at, "shed", f"req{rid}",
                                      {"reason": "slo",
                                       "modeled_steps": int(modeled),
                                       "deadline_steps": int(deadline)})
                    return None
            self._queue.append(rid)
            self._emit("admit", rid, at)
            return rid

    def step_once(self) -> int:
        """Advance the virtual clock one step.  Transition order within a
        step: membership/fault housekeeping -> deadline sweep -> prefill
        completions -> ship completions -> decode token tick (completions
        free slots) -> slot fill from the queue -> prefill start.  Returns
        the step just processed."""
        with self._lock:
            step = self._step
            # (0) housekeeping: fault injections/recovery on the shipper,
            # liveness clock + failover on the membership, then the
            # deadline sweep — anything past its deadline times out before
            # it can consume another prefill/ship/decode step
            if self._shipper is not None:
                self._shipper.on_step(step)
            if self._membership is not None:
                self._tick_membership(step)
            for rid in sorted(self._reqs):
                tr = self._reqs[rid]
                if tr.state in _TERMINAL:
                    continue
                d = self._deadline_of(tr.req)
                if d is not None and step - tr.req.arrival >= d:
                    self._timeout(tr, step)
            # (1) prefill completion -> ship starts (frees the prefill server)
            if self._prefill_rid is not None and self._prefill_end == step:
                tr = self._reqs[self._prefill_rid]
                self._prefill_rid = None
                self._start_ship(tr, step)
            # (2) ship completions -> decode starts (first token lands)
            for rid in sorted(self._reqs):
                tr = self._reqs[rid]
                if tr.state == SHIP and tr.t_ship_end == step:
                    self._start_decode(tr, step)
            # (3) decode tick: one token per occupied slot (not the slot
            # whose first token arrived this very step)
            for slot, rid in enumerate(self._slots):
                if rid is None:
                    continue
                tr = self._reqs[rid]
                if tr.state != DECODE or tr.t_decode == step:
                    continue
                tr.tokens += 1
                if tr.tokens >= tr.req.max_new:
                    self._finish(tr, step)
            # (4) fill free decode slots from the queue, FIFO
            for slot in range(self.max_slots):
                if self._slots[slot] is not None or not self._queue:
                    continue
                rid = self._queue.pop(0)
                tr = self._reqs[rid]
                tr.slot = slot
                tr.state = PREFILL
                self._slots[slot] = rid
                self._prefill_fifo.append(rid)
            # (5) single prefill server picks up the next slotted request
            if self._prefill_rid is None and self._prefill_fifo:
                rid = self._prefill_fifo.pop(0)
                tr = self._reqs[rid]
                self._prefill_rid = rid
                ps = max(1, self._n_steps(self._prefill_steps, tr.req, step))
                self._prefill_end = step + ps
                tr.t_prefill = step
                self._emit("prefill", rid, step)
            self._step = step + 1
            return step

    def slot_of(self, rid: int) -> Optional[int]:
        """Decode slot a request occupies (None while queued/terminal)."""
        with self._lock:
            return self._reqs[rid].slot

    def now(self) -> int:
        """Current virtual step."""
        with self._lock:
            return self._step

    def active(self) -> int:
        """Requests not yet terminal (queued or in the pipeline)."""
        with self._lock:
            return sum(1 for t in self._reqs.values()
                       if t.state not in _TERMINAL)

    def active_slots(self) -> list:
        """Snapshot of slot occupancy (rid or None per slot)."""
        with self._lock:
            return list(self._slots)

    def drain(self, max_steps: int = 100_000) -> int:
        """Step until every submitted request is terminal.  Raises on
        starvation (the no-starvation invariant the property suite checks)."""
        steps = 0
        while self.active() > 0:
            if steps >= max_steps:
                raise RuntimeError(
                    f"batcher did not drain within {max_steps} steps: "
                    f"{self.active()} request(s) still live")
            self.step_once()
            steps += 1
        return steps

    def run(self, arrivals: list) -> dict:
        """Drive a full trace: `arrivals` is a list of (step, prompt_len,
        max_new) or (step, prompt_len, max_new, deadline_steps) tuples
        (sorted by step).  Submits each at its step, then drains.  Returns
        :meth:`stats`."""
        pending = sorted(arrivals, key=lambda a: a[0])
        i = 0
        while i < len(pending) or self.active() > 0:
            now = self._step
            while i < len(pending) and pending[i][0] <= now:
                a = pending[i]
                self.submit(a[1], a[2], step=now,
                            deadline_steps=a[3] if len(a) > 3 else None)
                i += 1
            self.step_once()
        return self.stats()

    def timeline(self) -> list:
        """The event log: [kind, "req{rid}", step] rows, in order."""
        with self._lock:
            return [list(e) for e in self._events]

    def stats(self) -> dict:
        """Latency/TTFT percentiles, goodput, and counters — in modeled
        seconds (virtual steps x step_s).  ``slo_attainment`` is completed
        over every terminal request (shed and timed-out count against it);
        ``degraded`` flags the collocated mono-site fallback."""
        with self._lock:
            tracks = list(self._reqs.values())
            reships, reroutes = self._reships, self._reroutes
            failovers, degraded = self._failovers, self._degraded
        done = [t for t in tracks if t.state == DONE]
        rejected = sum(1 for t in tracks if t.state == REJECTED)
        timed_out = sum(1 for t in tracks if t.state == TIMEOUT)
        shed = sum(1 for t in tracks if t.state == SHED)
        lat = [(t.t_done - t.req.arrival) * self.step_s for t in done]
        ttft = [(t.t_decode - t.req.arrival) * self.step_s for t in done]
        tokens = sum(t.tokens for t in done)
        if done:
            span = (max(t.t_done for t in done)
                    - min(t.req.arrival for t in done) + 1)
        else:
            span = 0
        makespan_s = span * self.step_s
        denom = len(done) + rejected + timed_out + shed
        return {
            "completed": len(done),
            "rejected": rejected,
            "timed_out": timed_out,
            "shed": shed,
            "reships": reships,
            "reroutes": reroutes,
            "failovers": failovers,
            "degraded": degraded,
            "slo_attainment": len(done) / denom if denom else 1.0,
            "total_tokens": tokens,
            "makespan_s": makespan_s,
            "latency_p50_s": _percentile(lat, 50),
            "latency_p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "ttft_p99_s": _percentile(ttft, 99),
            "goodput_tok_s": tokens / makespan_s if makespan_s > 0 else 0.0,
        }


class FixedBatchScheduler:
    """Run-to-completion fixed batching — the baseline continuous batching
    beats.  Requests are grouped into consecutive batches of `max_slots` in
    arrival order; a batch prefills its members serially (monolithic: the
    same device prefills and decodes), then decodes until its *slowest*
    member finishes — freed rows idle, the queue waits."""

    def __init__(self, max_slots: int, *,
                 prefill_steps: Union[int, Callable[[Request], int]] = 1,
                 step_s: float = 1e-2):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self.step_s = float(step_s)
        self._prefill_steps = prefill_steps

    def run(self, arrivals: list) -> dict:
        """Same trace format as :meth:`ContinuousBatcher.run` (a trailing
        deadline entry is ignored — this baseline has no SLO handling)."""
        reqs = [Request(i, int(a[0]), int(a[1]), int(a[2]))
                for i, a in enumerate(sorted(arrivals, key=lambda a: a[0]))]
        lat: list[float] = []
        ttft: list[float] = []
        tokens = 0
        prev_end = 0
        last_done = 0
        for b0 in range(0, len(reqs), self.max_slots):
            batch = reqs[b0:b0 + self.max_slots]
            start = max(prev_end, max(r.arrival for r in batch))
            psteps = sum(
                max(1, (self._prefill_steps(r)
                        if callable(self._prefill_steps)
                        else int(self._prefill_steps)))
                for r in batch)
            decode_start = start + psteps     # first token for every member
            end = decode_start + max(r.max_new for r in batch) - 1
            for r in batch:
                lat.append((end - r.arrival) * self.step_s)
                ttft.append((decode_start - r.arrival) * self.step_s)
                tokens += r.max_new
            prev_end = end + 1
            last_done = end
        span = (last_done - min(r.arrival for r in reqs) + 1) if reqs else 0
        makespan_s = span * self.step_s
        return {
            "completed": len(reqs),
            "rejected": 0,
            "timed_out": 0,
            "shed": 0,
            "reships": 0,
            "reroutes": 0,
            "failovers": 0,
            "degraded": False,
            "slo_attainment": 1.0,
            "total_tokens": tokens,
            "makespan_s": makespan_s,
            "latency_p50_s": _percentile(lat, 50),
            "latency_p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "ttft_p99_s": _percentile(ttft, 99),
            "goodput_tok_s": tokens / makespan_s if makespan_s > 0 else 0.0,
        }
