"""Chaos layer of the port, as far as it has come: the incident timeline.

A copy of the timeline part of the JAX package's ``core/chaos.py``
(:class:`Incident`, :class:`IncidentLog`, :func:`get_incident_log`): a
process-global, step-ordered record of every fault event and every
automatic response, which ``MPW.Report`` appends and ``MPW.Incidents``
returns, and into which the serving scheduler's fault-aware shipper logs.
The detector, the trainer-side monitor and the healing file transfer wait
for ROADMAP.md queue A 'topology, chaos and elasticity'.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


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
