"""Per-path transfer telemetry (the `mpwtest` diagnostics, made persistent).

MPWide ships a runtime diagnostic (`mpwtest`) that measures what each path
actually achieves so operators can tune stream counts and chunk sizes.  This
module is that feedback channel for WideJAX: every :class:`WidePath` gets a
:class:`PathTelemetry` slot in a process-global registry keyed by
``path.key``, holding

  * the **static plan** of the traffic the path carries (payload bytes per
    transfer, chunk count, streams actually used vs. configured, pacing) —
    recorded at trace/build time by ``streamed_psum`` / ``pod_shift`` /
    ``build_train_step``, which is the honest place to capture it: inside a
    jitted step individual transfers cannot be timed from the host;
  * **measured samples** (wall seconds per executed step, bytes moved) —
    recorded by the host-side loops (`runtime/train_loop.py`,
    `runtime/serve_loop.py`, the benchmarks, or `MPW.Observe`), from which
    achieved GB/s and step-time statistics derive;
  * the **retune history** the online autotuner produced for the path.

The registry is what `MPW.PathStats` / `MPW.Report` read, and what the
:class:`~repro_torch.core.autotune.OnlineTuner` consumes as its cost signal.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class PlanInfo:
    """Static shape of one transfer over a path (trace-time knowledge)."""
    payload_bytes: int            # bytes the transfer delivers (logical)
    n_chunks: int                 # chunks the payload is cut into
    streams_used: int             # non-empty stream buckets
    streams_configured: int       # path.streams (the knob)
    chunk_bytes: int              # path.chunk_bytes (the knob)
    pacing: float                 # fraction of streams in flight per wave
    load_balance: float = 1.0     # max bucket load / mean bucket load
    algo: str = "psum"            # collective algorithm (psum|ring|ring2|shift)
    wire_bytes: int = 0           # modeled per-pod link bytes (0 = unknown)

    @property
    def stream_utilization(self) -> float:
        """Fraction of configured streams the plan can actually feed."""
        if self.streams_configured <= 0:
            return 1.0
        return min(1.0, self.streams_used / self.streams_configured)


@dataclass
class PathTelemetry:
    """Rolling stats for one path.  Mutators and readers synchronize on a
    per-path lock: the train loop records while other threads (async
    checkpoint writer, a monitoring thread calling MPW.Report) read."""
    key: str
    window: int = 256
    plan: Optional[PlanInfo] = None
    transfers: int = 0
    total_bytes: int = 0
    total_seconds: float = 0.0
    # modeled per-step exposure split (repro_torch.core.overlap.modeled_exposure):
    # exposed_s = cross-pod seconds left on the critical path, overlapped_s
    # = seconds hidden under compute.  Noted at build/retune time by the
    # step builder; None until a step with a compute window was built.
    exposed_s: Optional[float] = None
    overlapped_s: Optional[float] = None
    samples: deque = field(default_factory=deque)   # (step, seconds, bytes)
    retunes: list = field(default_factory=list)     # (step, {knob: value})
    checksum_errors: int = 0      # per-hop CRC failures (chaos signal)
    reships: int = 0              # KV ship retries on the same route
    reroutes: int = 0             # KV ships replanned over backup links
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def note_plan(self, **kw) -> None:
        with self._lock:
            self.plan = PlanInfo(**kw)

    def note_overlap(self, exposed_s: float, overlapped_s: float) -> None:
        with self._lock:
            self.exposed_s = float(exposed_s)
            self.overlapped_s = float(overlapped_s)

    def note_retune(self, step: Optional[int], config: dict) -> None:
        with self._lock:
            self.retunes.append((step, dict(config)))

    def note_checksum_error(self, n: int = 1) -> None:
        """Count a failed per-chunk CRC verification (file transfers check
        every chunk per hop; a corrupting link shows up here before it
        shows up as throughput collapse)."""
        with self._lock:
            self.checksum_errors += int(n)

    def note_ship_retry(self, reships: int = 0, reroutes: int = 0) -> None:
        """Count KV-ship fault responses (core/serving.py): retries of a
        failed hop on the same route and reroutes over backup links."""
        with self._lock:
            self.reships += int(reships)
            self.reroutes += int(reroutes)

    def record(self, seconds: float, nbytes: Optional[int] = None,
               step: Optional[int] = None) -> None:
        with self._lock:
            if nbytes is None:
                # prefer the modeled wire bytes when the plan knows them:
                # achieved GB/s then measures what the link carried, not the
                # logical payload (a site-hierarchical WAN stage carries far
                # fewer bytes than the payload it delivers)
                nbytes = ((self.plan.wire_bytes or self.plan.payload_bytes)
                          if self.plan else 0)
            self.transfers += 1
            self.total_bytes += int(nbytes)
            self.total_seconds += float(seconds)
            self.samples.append((step, float(seconds), int(nbytes)))
            while len(self.samples) > self.window:
                self.samples.popleft()

    # -- derived ------------------------------------------------------------
    def achieved_Bps(self) -> float:
        """Bytes/s over the rolling window (0 when nothing was timed)."""
        with self._lock:
            samples = list(self.samples)
        secs = sum(s for _, s, _ in samples)
        byts = sum(b for _, _, b in samples)
        return byts / secs if secs > 0 else 0.0

    def mean_seconds(self) -> float:
        with self._lock:
            samples = list(self.samples)
        if not samples:
            return 0.0
        return sum(s for _, s, _ in samples) / len(samples)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            samples = list(self.samples)
            out: dict[str, Any] = {
                "key": self.key,
                "transfers": self.transfers,
                "total_bytes": self.total_bytes,
                "total_seconds": self.total_seconds,
                "retunes": list(self.retunes),
                "checksum_errors": self.checksum_errors,
                "reships": self.reships,
                "reroutes": self.reroutes,
            }
            plan = self.plan
            exposed, overlapped = self.exposed_s, self.overlapped_s
        secs = sum(s for _, s, _ in samples)
        byts = sum(b for _, _, b in samples)
        out["window_mean_s"] = secs / len(samples) if samples else 0.0
        out["achieved_GBps"] = (byts / secs if secs > 0 else 0.0) / 1e9
        if plan is not None:
            out["plan"] = asdict(plan)
            out["stream_utilization"] = plan.stream_utilization
        if exposed is not None:
            out["exposed_s"] = exposed
            out["overlapped_s"] = overlapped
            total = exposed + (overlapped or 0.0)
            out["overlap_efficiency"] = ((overlapped or 0.0) / total
                                         if total > 0 else 0.0)
        return out


class Telemetry:
    """Process-global registry of :class:`PathTelemetry`, keyed by path key.

    Thread-safe: the async checkpoint writer and benchmark subprocesses may
    record concurrently with the train loop.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._paths: dict[str, PathTelemetry] = {}

    def path(self, key: str) -> PathTelemetry:
        with self._lock:
            if key not in self._paths:
                self._paths[key] = PathTelemetry(key=key)
            return self._paths[key]

    def note_plan(self, key: str, **kw) -> None:
        self.path(key).note_plan(**kw)

    def record(self, key: str, seconds: float, nbytes: Optional[int] = None,
               step: Optional[int] = None) -> None:
        self.path(key).record(seconds, nbytes=nbytes, step=step)

    @contextmanager
    def timed(self, key: str, nbytes: Optional[int] = None,
              step: Optional[int] = None):
        """Time a host-side block and record it against a path.

        The wall-clock read is the point of this helper — it measures host
        time by design, so it carries the one justified R5 waiver in core/
        (deterministic replays record modeled seconds, never `timed`).
        """
        t0 = time.perf_counter()    # mpwlint: disable=R5
        yield
        self.record(key, time.perf_counter() - t0,   # mpwlint: disable=R5
                    nbytes=nbytes, step=step)

    def report(self, prefix: Optional[str] = None) -> dict[str, dict]:
        """{path key: summary dict} for every path seen this process.

        `prefix` filters to one path and its hops: a multi-hop path records
        under its own key plus one slot per hop (``{key}/hop{i}:{link}``) or
        per hierarchical stage (``{key}/intra``, ``{key}/wan``), so
        ``report(prefix=path.key)`` returns the whole per-hop breakdown."""
        with self._lock:
            paths = list(self._paths.items())   # snapshot: reset() may race
        if prefix is not None:
            paths = [(k, p) for k, p in paths
                     if k == prefix or k.startswith(prefix + "/")]
        return {k: p.summary() for k, p in paths}

    def format_report(self) -> str:
        """Markdown table of the report (human-facing `MPW.Report`)."""
        rep = self.report()
        if not rep:
            return "(no paths recorded)"
        rows = ["| path | transfers | bytes/xfer | wire/pod (algo) | "
                "streams used/conf | chunk | window mean | achieved "
                "| exposed | overlap |",
                "|---|---|---|---|---|---|---|---|---|---|"]
        for key in sorted(rep):
            s = rep[key]
            plan = s.get("plan")
            if plan:
                per = plan["payload_bytes"]
                wire = (f"{_fmt_bytes(plan['wire_bytes'])} ({plan['algo']})"
                        if plan.get("wire_bytes") else "-")
                streams = f"{plan['streams_used']}/{plan['streams_configured']}"
                chunk = _fmt_bytes(plan["chunk_bytes"])
            else:
                per = s["total_bytes"] / max(s["transfers"], 1)
                wire, streams, chunk = "-", "-", "-"
            if "exposed_s" in s:
                exposed = f"{s['exposed_s']*1e3:.1f} ms"
                overlap = f"{s['overlap_efficiency']*100:.0f}%"
            else:
                exposed, overlap = "-", "-"
            rows.append(
                f"| {key} | {s['transfers']} | {_fmt_bytes(per)} | {wire} "
                f"| {streams} | {chunk} | {s['window_mean_s']*1e3:.1f} ms "
                f"| {s['achieved_GBps']:.3f} GB/s | {exposed} | {overlap} |")
        return "\n".join(rows)

    def reset(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._paths.clear()
            else:
                self._paths.pop(key, None)


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{int(n)} B"


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


# module-level conveniences (hot-path call sites stay one line)
def note_plan(key: str, **kw) -> None:
    _GLOBAL.note_plan(key, **kw)


def note_overlap(key: str, exposed_s: float, overlapped_s: float) -> None:
    _GLOBAL.path(key).note_overlap(exposed_s, overlapped_s)


def record(key: str, seconds: float, nbytes: Optional[int] = None,
           step: Optional[int] = None) -> None:
    _GLOBAL.record(key, seconds, nbytes=nbytes, step=step)


def note_checksum_error(key: str, n: int = 1) -> None:
    _GLOBAL.path(key).note_checksum_error(n)


def note_ship_retry(key: str, reships: int = 0, reroutes: int = 0) -> None:
    _GLOBAL.path(key).note_ship_retry(reships=reships, reroutes=reroutes)
