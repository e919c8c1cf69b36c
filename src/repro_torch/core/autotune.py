"""MPWide autotuner, alpha-beta edition.

The paper's autotuner (on by default) picks chunk size / window / pacing for
"fairly good performance with minimal effort".  Without TCP, the objective
becomes: minimize modeled *exposed* link time for a payload of `nbytes` over
a link, given a `compute_window` of overlappable work.

Model (per device, ring all-reduce factor folded into eff_bytes):
  per-chunk cost     t(c) = alpha + c / bw
  serial link time   T    = n_chunks * alpha + B / bw
  exposure           E    = max(0, T - W) + tail,  tail = c / bw
The optimum chunk count n* = sqrt(B / (alpha * bw)) balances launch overhead
against tail granularity — the WAN regime (large alpha*bw product) drives
n* up, reproducing the paper's ">=32 streams long-haul, 1 stream local"
guidance.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import median
from typing import Optional

from repro_torch.core.path import LinkSpec, WidePath


@dataclass(frozen=True)
class Tuning:
    streams: int
    chunk_bytes: int
    modeled_link_s: float
    modeled_exposed_s: float


def allreduce_bytes(nbytes: int, world: int, algo: str = "ring") -> float:
    """Per-device link bytes for an all-reduce of `nbytes`."""
    if world <= 1:
        return 0.0
    if algo == "ring":
        return 2.0 * (world - 1) / world * nbytes
    return float(nbytes)  # gather-based


def model_transfer(nbytes: float, link: LinkSpec, n_chunks: int,
                   compute_window: float = 0.0) -> tuple[float, float]:
    """(total link seconds, exposed seconds after overlapping with window)."""
    n_chunks = max(1, n_chunks)
    total = n_chunks * link.latency_s + nbytes / link.bandwidth_Bps
    tail = (nbytes / n_chunks) / link.bandwidth_Bps
    exposed = max(0.0, total - compute_window) + tail
    return total, exposed


def tune(nbytes: int, link: LinkSpec, *, world: int = 2,
         compute_window: float = 0.0, max_streams: int = 256) -> Tuning:
    """Pick (streams, chunk) minimizing modeled exposure.

    streams: on window-capped links (WANs), enough parallel windows to fill
    the bandwidth-delay product — the paper's ">=32 streams long-haul";
    window-free fabrics keep a small concurrency for latency hiding.
    chunk: alpha-beta optimum (scanned exactly; the closed form is
    sqrt(B/(alpha*bw)))."""
    eff = allreduce_bytes(nbytes, world)
    if eff == 0.0:
        return Tuning(1, max(nbytes, 1), 0.0, 0.0)
    best = None
    for n in _chunk_candidates(eff, link, max_streams):
        total, exposed = model_transfer(eff, link, n, compute_window)
        key = (exposed, total, n)
        if best is None or key < best[0]:
            best = (key, n, total, exposed)
    _, n, total, exposed = best
    if link.window:
        bdp = link.bandwidth_Bps * 2 * link.latency_s
        streams = int(min(max_streams, max(1, math.ceil(bdp / link.window))))
    else:
        streams = int(min(n, 32))
    return Tuning(streams=streams,
                  chunk_bytes=max(1 << 16, int(math.ceil(eff / n))),
                  modeled_link_s=total, modeled_exposed_s=exposed)


def _chunk_candidates(eff: float, link: LinkSpec, max_streams: int):
    n_star = math.sqrt(eff / (link.latency_s * link.bandwidth_Bps))
    cands = {1, 2, 4, 8, 16, 32, 64, 128, 256,
             max(1, int(n_star)), max(1, int(n_star * 2)),
             max(1, int(n_star / 2))}
    return sorted(c for c in cands if c <= max(max_streams, 1) * 64)


def autotune_path(path: WidePath, nbytes: int, *, world: int = 2,
                  compute_window: float = 0.0) -> WidePath:
    """Return a path re-tuned for a payload size (MPW_setAutoTuning)."""
    if not path.comm.autotune:
        return path
    t = tune(nbytes, path.link, world=world, compute_window=compute_window)
    return path.with_(streams=t.streams,
                      chunk_mb=max(t.chunk_bytes / (1 << 20), 0.0625))


# ---------------------------------------------------------------------------
# online autotuner: measurement-driven hill climb over the path knobs
# ---------------------------------------------------------------------------

STREAM_GRID: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)
CHUNK_GRID_MB: tuple[float, ...] = (0.0625, 0.25, 1.0, 2.0, 4.0, 8.0,
                                    16.0, 32.0, 64.0)
PACING_GRID: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
ALGO_GRID: tuple[str, ...] = ("psum", "ring", "ring2")
# gradient-sync bucket size (0 = bucketing off, one whole-tree sync); the
# grid spans "one bucket per layer block" up to "a handful of buckets for
# the largest trees" — see repro/core/buckets.py
BUCKET_GRID_MB: tuple[float, ...] = (0.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _seed(grid: list, value) -> int:
    """Index of `value` in `grid`, inserting it (sorted) when absent.

    The warm start may sit off-grid (e.g. 23 streams / 5.7 MiB chunks from
    the alpha-beta model); snapping it to a neighbour would make the tuner's
    incumbent a config that was never measured.  Keeping the exact value as
    a grid point means the first window's cost is booked against the config
    actually running."""
    if value not in grid:
        grid.append(value)
        grid.sort()
    return grid.index(value)


class OnlineTuner:
    """First-improvement hill climb over (streams, chunk_mb, pacing) driven
    by *measured* cost (wall seconds per step/transfer).

    The model-based :func:`tune` gives a warm start; this controller closes
    the loop the paper's autotuner closes over live TCP measurements.  The
    caller feeds one cost sample per executed step via :meth:`observe`; every
    `window` samples the tuner takes the median (robust to the recompile
    spike after a knob change and to stragglers), compares it to the best
    config seen, and either keeps climbing or reverts.

    Moves are +-1 grid step per knob, plus the two (streams, chunk) diagonals
    — streams and chunk size are coupled (a payload cut into fewer chunks
    than streams cannot feed them), and the diagonal is the only improving
    direction out of configs like (1 stream, one huge chunk).

    The collective *algorithm* (`psum | ring | ring2`, CommConfig.algo) is a
    fourth knob: which algorithm wins is payload-, pod-count- and
    compression-dependent (rings win on bandwidth; the monolithic psum can
    win tiny latency-bound payloads), so it is probed from measurements like
    any other knob.  `tune_algo=False` pins it (per-hop RouteTuner legs are
    ppermute shifts, where the all-reduce algorithm does not apply).

    The sync *bucket size* (`CommConfig.bucket_mb`, `repro_torch.core.buckets`) is
    a fifth knob: smaller buckets hide more of the transfer behind backprop
    and the optimizer but pay more per-transfer overhead, and the optimum
    depends on the measured compute/comm balance — exactly the trade the
    hill climb is built for.  Probing up from the 0.0 grid point is how a
    path *discovers* that bucketed overlap pays.  `tune_bucket=False` pins
    it (file transfers and per-hop shift legs carry no bucket signal).

    `observe` returns the new knob dict to apply when the tuner wants a
    config change, else None.  The tuner never raises mid-training: any cost
    signal is accepted, convergence just stops proposing moves.
    """

    KNOBS = ("streams", "chunk_mb", "pacing", "algo", "bucket_mb")

    def __init__(self, streams: int = 32, chunk_mb: float = 8.0,
                 pacing: float = 1.0, *, algo: str = "psum",
                 bucket_mb: float = 0.0,
                 window: int = 5, warmup: int = 1,
                 rel_improvement: float = 0.02,
                 tune_pacing: bool = True, tune_algo: bool = True,
                 tune_bucket: bool = True) -> None:
        self.grids = {"streams": list(STREAM_GRID),
                      "chunk_mb": list(CHUNK_GRID_MB),
                      "pacing": list(PACING_GRID),
                      "algo": list(ALGO_GRID),
                      "bucket_mb": list(BUCKET_GRID_MB)}
        # seeds stay exact for any value the transfer engine itself accepts
        # (streams floor at 1, chunks at the 64 KiB engine floor, pacing
        # clamps into [0,1], buckets floor at 0=off — all mirroring
        # WidePath/streamed_psum), so the incumbent is always the config
        # actually running
        self.idx = {"streams": _seed(self.grids["streams"], max(1, int(streams))),
                    "chunk_mb": _seed(self.grids["chunk_mb"],
                                      max(0.0625, float(chunk_mb))),
                    "pacing": _seed(self.grids["pacing"],
                                    max(0.0, min(1.0, float(pacing)))),
                    "algo": _seed(self.grids["algo"], str(algo)),
                    "bucket_mb": _seed(self.grids["bucket_mb"],
                                       max(0.0, float(bucket_mb)))}
        self.window = max(1, int(window))
        self.warmup = max(0, int(warmup))
        self.rel = float(rel_improvement)
        self.tune_pacing = tune_pacing
        self.tune_algo = tune_algo
        self.tune_bucket = tune_bucket
        self.best_idx = dict(self.idx)
        self.best_cost: Optional[float] = None
        self.converged = False
        self.history: list[tuple[dict, float]] = []   # (config, window cost)
        self._samples: list[float] = []
        self._skip = self.warmup      # drop compile/post-change cost spikes
        self._moves: list[dict] = []
        self._probe: Optional[dict] = None   # move applied but not yet judged

    # -- public -------------------------------------------------------------
    def _active(self) -> tuple:
        # pinned knobs (tune_algo=False: ppermute-shift hops; tune_bucket=
        # False: file paths) are not reported — returned configs stay knobs
        # the caller's cost signal can actually move
        out = []
        for k in self.KNOBS:
            if k == "algo" and not self.tune_algo:
                continue
            if k == "bucket_mb" and not self.tune_bucket:
                continue
            out.append(k)
        return tuple(out)

    def config(self) -> dict:
        return {k: self.grids[k][self.idx[k]] for k in self._active()}

    def best_config(self) -> dict:
        return {k: self.grids[k][self.best_idx[k]] for k in self._active()}

    def pin_algo(self) -> None:
        """Stop probing the `algo` knob, keeping streams/chunk/pacing live.

        Callers whose cost samples carry no information about the
        collective algorithm (file transfers: algo is a no-op for file
        bytes) must pin it — otherwise a cost-neutral algo move can look
        like a noise-driven "improvement" and silently switch the path's
        collective.  Any in-flight algo probe reverts to the incumbent.
        """
        self._pin("algo", "tune_algo")

    def pin_bucket(self) -> None:
        """Stop probing the `bucket_mb` knob (same rationale as
        :meth:`pin_algo`: file transfers ignore the sync bucket size, so
        bucket probes on a file path are noise-driven)."""
        self._pin("bucket_mb", "tune_bucket")

    def _pin(self, knob: str, flag: str) -> None:
        if not getattr(self, flag):
            return
        setattr(self, flag, False)
        self.idx[knob] = self.best_idx[knob]
        self._moves = [m for m in self._moves if knob not in m]

    def observe(self, seconds: float) -> Optional[dict]:
        """Feed one measured cost sample; returns knobs to apply or None."""
        if self.converged:
            return None
        if self._skip > 0:
            self._skip -= 1
            return None
        self._samples.append(float(seconds))
        if len(self._samples) < self.window:
            return None
        cost = median(self._samples)
        self._samples.clear()
        return self._decide(cost)

    def abort_probe(self) -> Optional[dict]:
        """Revert an in-flight probe after a path fault.

        A probe's cost window measured on a dying path says nothing about
        the probed config: without this revert, a fault mid-probe leaves
        the (possibly losing) probed knobs pinned on the path while the
        tuner's incumbent still points at the old config.  Clears the
        corrupted samples, re-queues the aborted move for a clean re-probe
        after recovery, and returns the incumbent knobs to re-apply — or
        None when the path is already running the incumbent."""
        self._samples.clear()
        self._skip = self.warmup
        if self._probe is not None:
            self._moves.insert(0, self._probe)
            self._probe = None
        if self.idx == self.best_idx:
            return None
        self.idx = dict(self.best_idx)
        return self.config()

    # -- climb mechanics ----------------------------------------------------
    def _decide(self, cost: float) -> Optional[dict]:
        self._probe = None            # the probe's window completed cleanly
        self.history.append((self.config(), cost))
        improved = (self.best_cost is None
                    or cost < self.best_cost * (1.0 - self.rel))
        if improved:
            self.best_cost = cost
            self.best_idx = dict(self.idx)
            self._moves = self._gen_moves()
        return self._try_next()

    def _gen_moves(self) -> list[dict]:
        g = self.grids
        moves = [{"streams": +1, "chunk_mb": -1},   # coupled diagonals first
                 {"streams": +1}, {"chunk_mb": -1}, {"chunk_mb": +1},
                 {"streams": -1}, {"streams": -1, "chunk_mb": +1}]
        if self.tune_pacing:
            moves += [{"pacing": -1}, {"pacing": +1}]
        if self.tune_algo:
            moves += [{"algo": +1}, {"algo": -1}]
        if self.tune_bucket:
            moves += [{"bucket_mb": -1}, {"bucket_mb": +1}]
        ok = []
        for mv in moves:
            if all(0 <= self.best_idx[k] + d < len(g[k]) for k, d in mv.items()):
                ok.append(mv)
        return ok

    def _try_next(self) -> Optional[dict]:
        if self._moves:
            mv = self._moves.pop(0)
            self.idx = dict(self.best_idx)
            for k, d in mv.items():
                self.idx[k] += d
            self._skip = self.warmup
            self._probe = mv
            return self.config()
        # no untried neighbour beats the incumbent: settle on it
        self.converged = True
        if self.idx != self.best_idx:
            self.idx = dict(self.best_idx)
            return self.config()
        return None


# ---------------------------------------------------------------------------
# per-hop tuning: one controller per leg of a multi-hop route
# ---------------------------------------------------------------------------

def hop_shares(route, nbytes: float = 0.0) -> list:
    """Each hop's fraction of a store-and-forward relay's wall time, from
    the alpha-beta model (hop times add, so shares are alpha + bytes/bw,
    normalized).  The one split used both to attribute end-to-end
    measurements to hops (telemetry) and to feed per-hop controllers."""
    shares = [h.link.transfer_s(max(0.0, float(nbytes))) for h in route]
    total = sum(shares) or 1.0
    return [s / total for s in shares]

class RouteTuner:
    """One :class:`OnlineTuner` per hop of a multi-hop path.

    The paper tunes every path leg separately (>=32 streams on the WAN leg,
    1 on the LAN leg of the same Forwarder route); a single controller over
    the whole route would conflate the legs' very different optima.  Feed
    per-hop wall seconds via :meth:`observe`; when only an end-to-end relay
    time is measurable, :meth:`observe_total` splits it across hops by each
    hop's modeled share (store-and-forward: hop times add, so the split is
    proportional to alpha + bytes/bw per hop).
    """

    def __init__(self, path, *, window: int = 5, warmup: int = 1) -> None:
        self.route = path.route
        # tune_algo/tune_bucket=False: hop legs are ppermute shifts, where
        # neither the all-reduce algorithm nor the gradient-sync bucket
        # size applies
        self.tuners = [OnlineTuner(streams=h.streams,
                                   chunk_mb=h.comm.chunk_mb,
                                   pacing=h.comm.pacing, algo=h.comm.algo,
                                   window=window, warmup=warmup,
                                   tune_algo=False, tune_bucket=False)
                       for h in self.route]

    @property
    def converged(self) -> bool:
        return all(t.converged for t in self.tuners)

    def observe(self, hop: int, seconds: float) -> Optional[dict]:
        """One measured sample for hop `hop`; returns knobs for that hop or
        None (exactly :meth:`OnlineTuner.observe` semantics)."""
        return self.tuners[hop].observe(seconds)

    def observe_total(self, seconds: float, nbytes: float = 0.0) -> dict:
        """Split an end-to-end relay time across hops by modeled share and
        feed every hop's controller.  Returns {hop index: new knobs} for the
        hops that want a config change (empty dict: keep going)."""
        shares = hop_shares(self.route, nbytes)
        out: dict[int, dict] = {}
        for i, t in enumerate(self.tuners):
            cfg = t.observe(seconds * shares[i])
            if cfg is not None:
                out[i] = cfg
        return out

    def abort_probe(self) -> dict:
        """Revert any in-flight probe on every hop (a route fault corrupts
        every hop's attributed cost window, not just the dead hop's).
        Returns {hop index: incumbent knobs} for hops that were probing."""
        out: dict[int, dict] = {}
        for i, t in enumerate(self.tuners):
            cfg = t.abort_probe()
            if cfg is not None:
                out[i] = cfg
        return out


# ---------------------------------------------------------------------------
# synthetic link: a measurement generator for convergence tests/benchmarks
# ---------------------------------------------------------------------------

def simulate_transfer_s(nbytes: float, link: LinkSpec, *, streams: int,
                        chunk_bytes: float, pacing: float = 1.0,
                        algo: str = "psum", world: int = 1,
                        compress: str = "none",
                        stream_setup_s: float = 1.5e-4,
                        compute_s: float = 0.0,
                        jitter: float = 0.0, seed: int = 0) -> float:
    """Wall seconds to ship `nbytes` over `link` with the given knobs.

    The landscape has the couplings real paths have: per-stream window caps
    (too few streams starve a WAN), per-stream setup cost (too many streams
    pay host overhead), per-chunk launch latency serialized within a stream
    (too-small chunks), and streams starved when the payload yields fewer
    chunks than streams (too-large chunks).  `jitter` adds deterministic
    pseudo-noise (LCG on `seed`) so tuner tests exercise the median filter.

    With `world > 1` the payload is an all-reduce over `world` pods and
    `nbytes` is replaced by the modeled per-pod wire bytes of
    (`algo`, `compress`) — the landscape the algo knob climbs; `world=1`
    (default) keeps the plain point-to-point transfer landscape.
    """
    if world > 1:
        from repro_torch.core.ring import wire_bytes_per_pod
        nbytes = wire_bytes_per_pod(nbytes, world, algo=algo,
                                    compress=compress)
    chunk_bytes = max(1.0, float(chunk_bytes))
    n_chunks = max(1, math.ceil(nbytes / chunk_bytes))
    streams_used = max(1, min(int(streams), n_chunks))
    in_flight = max(1, int(round(streams_used * min(1.0, max(0.0, pacing)))))
    waves = math.ceil(streams_used / in_flight)
    per_stream = (link.window / (2 * link.latency_s) if link.window
                  else link.bandwidth_Bps)
    agg = min(link.bandwidth_Bps, in_flight * per_stream)
    wire = nbytes / agg + (waves - 1) * 2 * link.latency_s
    chunks_per_stream = math.ceil(n_chunks / streams_used)
    overhead = chunks_per_stream * link.latency_s + streams_used * stream_setup_s
    t = wire + overhead + compute_s
    if jitter:
        t *= 1.0 + jitter * (_lcg01(seed) - 0.5)
    return t


def _lcg01(seed: int) -> float:
    """Deterministic uniform [0,1) from an integer seed."""
    return ((1103515245 * (seed + 12345) + 12345) % (1 << 31)) / float(1 << 31)


def simulate_hop_s(nbytes: float, profile, step: int, *,
                   streams: Optional[int] = None,
                   chunk_bytes: Optional[float] = None,
                   pacing: Optional[float] = None,
                   timeout_s: float = 30.0,
                   jitter: float = 0.0, seed: int = 0) -> float:
    """Fault-aware wall seconds for one hop of a route at training `step`.

    Applies the :class:`~repro_torch.core.topology.LinkProfile` fault schedule to
    the synthetic landscape: a dead link models as a transfer that hangs
    until `timeout_s` (what the watchdog on a real socket would report); a
    degraded link as proportionally less capacity.  This is how scheduled
    faults surface as *telemetry* — achieved-GB/s collapse the chaos
    detector can see — rather than as out-of-band flags."""
    health = profile.health(step)
    if not health.alive:
        return float(timeout_s)
    link = profile.spec
    if health.bandwidth_factor < 1.0:
        link = LinkSpec(link.name, link.latency_s,
                        max(1.0, link.bandwidth_Bps * health.bandwidth_factor),
                        link.window)
    return simulate_transfer_s(
        float(nbytes), link,
        streams=profile.streams if streams is None else streams,
        chunk_bytes=(profile.chunk_mb * (1 << 20) if chunk_bytes is None
                     else chunk_bytes),
        pacing=profile.pacing if pacing is None else pacing,
        jitter=jitter, seed=seed + step)
