"""mpw-cp / DataGather transport: WAN file transfer over a :class:`WidePath`.

MPWide advertises three capabilities: message passing, fast client-server
connections, and *moving files* (the ``mpw-cp`` tool and the DataGather
service, arXiv:1312.0910).  The paper treats file movement as the same
problem as message passing — split the byte stream into chunks, ship the
chunks over S parallel streams, tune streams/chunk/pacing per link — so this
module routes file bytes through the existing path machinery instead of
around it:

  * a :class:`FileJob` maps one file onto the *chunk planner*
    (:func:`plan_file_chunks` emits ``streams.Chunk`` byte ranges) and onto
    the path's parallel streams (``streams.assign_streams``, greedy LPT —
    identical plumbing to a gradient all-reduce payload);
  * chunks are optionally **compressed per chunk** on the wire (lossless
    ``zlib`` whenever ``CommConfig.compress != "none"`` — files must
    round-trip bit-exact, so the lossy int8/bf16 array codecs do not apply);
  * every chunk carries a CRC32 **checksum**, verified after every hop; a
    mismatch re-queues the chunk from the source (bounded retries);
  * transfers are **resumable**: a JSON *sidecar manifest*
    (``<dst>.mpwcp.json``) records completed chunks as they land in the
    partial file (``<dst>.part``), so an interrupted transfer restarts
    without re-sending finished chunks;
  * a multi-hop path (a Forwarder route from :class:`~repro_torch.core.topology.
    Topology`) relays **store-and-forward**: each chunk crosses the hops in
    order, held in the relay's buffer between legs, with per-hop wire bytes
    and modeled seconds recorded under the path's per-hop telemetry keys
    (``{key}/hop{i}:{leg}``) — `MPW.Report()` shows each leg of a file
    transfer just like each leg of a relay;
  * an attached :class:`~repro_torch.core.autotune.OnlineTuner` tunes file
    transfers with the same knobs as collectives (streams, chunk_mb,
    pacing), fed by the modeled end-to-end seconds of each job.

Timing model: the container has no real WAN, so recorded *seconds* are
modeled (``autotune.simulate_transfer_s`` per hop — streams-, window- and
pacing-aware — summed store-and-forward), while *bytes* are the real
post-compression wire bytes.  On a deployment with a real network, feed the
measured wall time to ``MPW.Observe`` instead; the engine's data plane
(chunking, checksums, resume) is identical either way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from hashlib import sha256
from typing import Callable, Optional

from repro_torch.core import streams as st
from repro_torch.core import telemetry as tel
from repro_torch.core.autotune import OnlineTuner, simulate_transfer_s
from repro_torch.core.path import WidePath
from repro_torch.core.retry import RetryPolicy
from repro_torch.core.streams import Chunk

PART_SUFFIX = ".part"
SIDECAR_SUFFIX = ".mpwcp.json"
#: file names the mirror prune and directory walks must treat as transient
TRANSIENT_SUFFIXES = (PART_SUFFIX, SIDECAR_SUFFIX, ".tmp")


class ChecksumError(RuntimeError):
    """A chunk failed its CRC after exhausting retries."""


def plan_file_chunks(nbytes: int, chunk_bytes: int) -> list[Chunk]:
    """Cut a file of `nbytes` into byte-range chunks of <= chunk_bytes.

    Reuses the collective chunk descriptor (:class:`streams.Chunk`): `leaf`
    is the chunk index, `start` the byte offset, `size`/`nbytes` the byte
    count — so stream assignment and plan summaries are the same code path
    a gradient payload takes.
    """
    chunk_bytes = max(1 << 16, int(chunk_bytes))
    if nbytes <= 0:
        return [Chunk(0, 0, 0, 0, 0)]
    out: list[Chunk] = []
    off = 0
    while off < nbytes:
        sz = min(chunk_bytes, nbytes - off)
        out.append(Chunk(len(out), 0, off, sz, sz))
        off += sz
    return out


def file_sha256(path: str, bufsize: int = 1 << 20) -> str:
    h = sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(bufsize)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


@dataclass(frozen=True)
class FileJob:
    """One file mapped onto a path's chunk plan (the unit mpw-cp ships)."""
    src: str
    dst: str
    nbytes: int
    mtime: float
    chunks: tuple                 # tuple[Chunk, ...] byte ranges
    buckets: tuple                # tuple[tuple[Chunk, ...], ...] per stream

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)


@dataclass
class FileResult:
    """What one executed :class:`FileJob` did."""
    src: str
    dst: str
    nbytes: int                   # logical file bytes
    n_chunks: int
    sent: int = 0                 # chunks shipped this run
    skipped: int = 0              # chunks already complete (resume)
    retries: int = 0              # checksum-mismatch re-queues
    backoff_s: float = 0.0        # modeled RetryPolicy delay before re-sends
    wire_bytes: int = 0           # post-compression bytes, summed over hops
    hop_wire_bytes: list = field(default_factory=list)
    modeled_s: float = 0.0        # store-and-forward sum of hop times
    hop_modeled_s: list = field(default_factory=list)
    sha256: str = ""              # destination digest ("" when digest=False)
    reroutes: int = 0             # mid-job route replans (chaos healing)
    # one entry per abandoned route: {"route", "hop_wire_bytes",
    # "failed_hop"} — wire bytes spent on a route that died mid-job still
    # count toward wire_bytes (the link carried them)
    reroute_history: list = field(default_factory=list)

    @property
    def resumed(self) -> bool:
        return self.skipped > 0


class FileTransfer:
    """The mpw-cp engine: executes :class:`FileJob`s over one WidePath.

    `fault_hook(chunk, hop_index, payload) -> payload` intercepts every
    chunk on arrival at each hop (tests inject corruption or raise to
    simulate an interrupt); `tuner` attaches an online controller that
    re-tunes ``self.path`` from modeled job times; `record=False` silences
    telemetry (the local mirror fallback).

    `reroute(engine, failed_hop) -> bool` is the self-healing hook: when a
    chunk exhausts its CRC retries (a hop is corrupting or dead), the
    engine calls it once per failure epoch.  The callback may replan the
    route — mutate ``engine.path`` (and ``engine.fault_hook``) to the new
    route — and return True; the failing chunk and every not-yet-shipped
    chunk then requeue onto the replanned route (in-flight chunks finish
    their current attempt and requeue on their next failure).  Returning
    False, or `reroute=None`, propagates :class:`ChecksumError` as before.
    At most `max_reroutes` replans per job.  Reroute is not supported for
    ``reverse`` transfers.

    `retry` is the chunk re-queue schedule (a :class:`~repro_torch.core.retry.
    RetryPolicy`): a chunk that fails its CRC backs off per the policy's
    modeled delays (accounted in ``FileResult.backoff_s``) instead of
    hammering the degraded link with an immediate re-send.  When omitted,
    one is derived from `max_retries` (``max_attempts = max_retries + 1``);
    when given, it wins and `max_retries` is ignored.
    """

    def __init__(self, path: WidePath, *, tuner: Optional[OnlineTuner] = None,
                 compress: Optional[str] = None, max_retries: int = 3,
                 record: bool = True, digest: bool = True,
                 fault_hook: Optional[Callable] = None,
                 reroute: Optional[Callable] = None,
                 max_reroutes: int = 2,
                 retry: Optional[RetryPolicy] = None) -> None:
        self.path = path
        self.tuner = tuner
        self.reroute = reroute
        self.max_reroutes = max(0, int(max_reroutes))
        self.retry = retry or RetryPolicy(
            max_attempts=max(0, int(max_retries)) + 1)
        # kept consistent with the policy for callers that read it
        self.max_retries = self.retry.max_attempts - 1
        self.record = record
        # guards post-job path retunes: the DataGather mirror thread and a
        # caller-driven replicate_now() can drive the same engine
        self._path_lock = threading.Lock()
        # digest=False skips the whole-file sha256 re-read at finalize
        # (FileResult.sha256 stays ""): per-chunk CRCs already verify
        # integrity, so callers that discard the result — the DataGather
        # mirror loop — should not pay a second full read per file
        self.digest = digest
        self.fault_hook = fault_hook
        # "zlib" | "none"; default derives from the path's compress knob
        # (any lossy array codec selects the lossless byte codec here)
        self._compress = (compress if compress is not None
                          else ("zlib" if path.comm.compress != "none"
                                else "none"))
        if self._compress not in ("zlib", "none"):
            raise ValueError(f"unknown file codec {self._compress!r}")

    # -- planning -----------------------------------------------------------
    def plan(self, src: str, dst: str) -> FileJob:
        s = os.stat(src)
        chunks = plan_file_chunks(s.st_size, self.path.chunk_bytes)
        buckets = st.assign_streams(chunks, self.path.streams)
        return FileJob(src=src, dst=dst, nbytes=s.st_size, mtime=s.st_mtime,
                       chunks=tuple(chunks),
                       buckets=tuple(tuple(b) for b in buckets))

    # -- execution ----------------------------------------------------------
    def copy(self, src: str, dst: str, *, resume: bool = True,
             reverse: bool = False, record_total: bool = True) -> FileResult:
        """Ship one file src -> dst through the path's route.

        `resume=True` keeps a sidecar manifest next to the partial file and
        skips chunks it records as done (validated against source size and
        mtime — a changed source restarts from scratch).  `reverse` runs the
        route back to front (``FileRecv``: pulling along the return
        direction).  `record_total=False` leaves the end-to-end telemetry
        sample to the caller (the MPW facade records it via ``Observe`` so
        the session's tuner sees it too).
        """
        job = self.plan(src, dst)
        return self.run(job, resume=resume, reverse=reverse,
                        record_total=record_total)

    def run(self, job: FileJob, *, resume: bool = True, reverse: bool = False,
            record_total: bool = True) -> FileResult:
        route = self.path.route
        hop_order = (list(range(len(route) - 1, -1, -1)) if reverse
                     else list(range(len(route))))
        res = FileResult(src=job.src, dst=job.dst, nbytes=job.nbytes,
                         n_chunks=job.n_chunks,
                         hop_wire_bytes=[0] * len(route),
                         hop_modeled_s=[0.0] * len(route))
        done = self._load_sidecar(job) if resume else {}
        part = job.dst + PART_SUFFIX
        os.makedirs(os.path.dirname(os.path.abspath(job.dst)), exist_ok=True)
        self._ensure_part(part, job.nbytes)
        lock = threading.Lock()
        # mutable route state shared by the streams: a reroute bumps `epoch`
        # and swaps route/hop_order; chunks that fail re-read it and requeue
        ctx = {"epoch": 0, "reroutes": 0, "route": route,
               "hop_order": hop_order, "reverse": reverse}

        def ship(c: Chunk) -> None:
            while True:
                with lock:
                    my_epoch = ctx["epoch"]
                    order_now = list(ctx["hop_order"])
                    # hold the *list object*: after a reroute archives it,
                    # stragglers still account their bytes against the
                    # abandoned route rather than the fresh arrays
                    hw = res.hop_wire_bytes
                path_now = self.path
                failed_hop = order_now[0] if order_now else 0
                for _delay in self.retry.schedule(key=c.leaf):
                    if _delay:
                        with lock:      # modeled backoff before the re-send
                            res.backoff_s += _delay
                    try:
                        with open(job.src, "rb") as f:
                            f.seek(c.start)
                            payload = f.read(c.size)
                    except FileNotFoundError:
                        self._abort(job.dst)  # source vanished: no resume
                        raise
                    crc = zlib.crc32(payload)
                    ok = True
                    for i in order_now:   # store-and-forward across route
                        wire = (zlib.compress(payload, 1)
                                if self._compress == "zlib" else payload)
                        with lock:
                            hw[i] += len(wire)
                        recv = (zlib.decompress(wire)
                                if self._compress == "zlib" else wire)
                        if self.fault_hook is not None:
                            recv = self.fault_hook(c, i, recv)
                        if zlib.crc32(recv) != crc:  # relay verifies per hop
                            ok = False
                            failed_hop = i
                            with lock:
                                res.retries += 1
                            if self.record:
                                tel.note_checksum_error(path_now.hop_key(i))
                            break
                        payload = recv
                    if ok:
                        break
                else:
                    # CRC retries exhausted on this route: heal or give up
                    if self._advance_route(ctx, res, my_epoch, failed_hop,
                                           lock):
                        continue      # requeue onto the replanned route
                    raise ChecksumError(
                        f"chunk {c.leaf} of {job.src} failed CRC "
                        f"{self.max_retries + 1} times")
                break
            with open(part, "r+b") as f:
                f.seek(c.start)
                f.write(payload)
            with lock:
                res.sent += 1
                done[c.leaf] = crc
                # amortized journaling: rewriting the whole sidecar per
                # chunk is O(n_chunks^2) and serializes the streams on the
                # shared lock — flush at most ~64 times per job (small jobs
                # still flush per chunk); the except path below flushes the
                # final state, so an *interrupt* loses nothing and a hard
                # kill re-sends at most flush_every chunks on resume
                if resume and len(done) % flush_every == 0:
                    self._flush_sidecar(job, done)

        def run_bucket(bucket) -> None:
            for c in bucket:              # ordered within a stream
                if c.leaf in done:
                    with lock:
                        res.skipped += 1
                    continue
                ship(c)

        buckets = list(job.buckets)
        pace = max(0.0, min(1.0, float(self.path.comm.pacing)))
        per_wave = max(1, int(round(len(buckets) * pace))) if buckets else 1
        flush_every = max(1, job.n_chunks // 64)
        # an exception out of any bucket (interrupt, vanished source,
        # ChecksumError) propagates after the journal is flushed, so the
        # next copy() resumes from exactly the chunks that completed
        try:
            with ThreadPoolExecutor(max_workers=per_wave) as pool:
                for w0 in range(0, len(buckets), per_wave):
                    futs = [pool.submit(run_bucket, b)
                            for b in buckets[w0:w0 + per_wave]]
                    for f in futs:
                        f.result()
        except BaseException:
            if resume and os.path.exists(part):   # vanished src: no state
                with lock:
                    self._flush_sidecar(job, done)
            raise

        if self.digest:
            res.sha256 = file_sha256(part)
        os.replace(part, job.dst)         # atomic publish
        try:
            shutil.copystat(job.src, job.dst)   # mirror diffs compare mtime
        except OSError:
            pass
        self._remove_sidecar(job.dst)
        self._account(job, res, ctx["route"], ctx["hop_order"], record_total)
        return res

    def _advance_route(self, ctx: dict, res: FileResult, my_epoch: int,
                       failed_hop: int, lock) -> bool:
        """A chunk exhausted its CRC retries: requeue it onto a healed route.

        Returns True when a newer route is in place — either this call's
        `reroute` callback replanned one, or a concurrent stream already
        did (their chunk hit the same dead hop first).  False means no
        heal is possible and the ChecksumError should propagate."""
        with lock:
            if ctx["epoch"] != my_epoch:
                return True           # another stream already healed
            if (self.reroute is None or ctx["reverse"]
                    or ctx["reroutes"] >= self.max_reroutes):
                return False
            if not self.reroute(self, failed_hop):
                return False
            new_route = self.path.route
            res.reroutes += 1
            res.reroute_history.append(
                {"route": [h.name for h in ctx["route"]],
                 "failed_hop": failed_hop,
                 "hop_wire_bytes": res.hop_wire_bytes})
            res.hop_wire_bytes = [0] * len(new_route)
            res.hop_modeled_s = [0.0] * len(new_route)
            ctx["reroutes"] += 1
            ctx["epoch"] += 1
            ctx["route"] = new_route
            ctx["hop_order"] = list(range(len(new_route)))
            return True

    def copy_tree(self, src_dir: str, dst_dir: str, *, resume: bool = True,
                  record_total: bool = True) -> list[FileResult]:
        """Directory manifest walk -> one FileJob per file (mpw-cp -r)."""
        out: list[FileResult] = []
        for root, _, files in os.walk(src_dir):
            rel = os.path.relpath(root, src_dir)
            troot = os.path.join(dst_dir, rel) if rel != "." else dst_dir
            os.makedirs(troot, exist_ok=True)
            for fn in sorted(files):
                if fn.endswith(TRANSIENT_SUFFIXES):
                    continue
                out.append(self.copy(os.path.join(root, fn),
                                     os.path.join(troot, fn), resume=resume,
                                     record_total=record_total))
        return out

    # -- accounting ---------------------------------------------------------
    def _account(self, job: FileJob, res: FileResult, route, hop_order,
                 record_total: bool) -> None:
        # the job is chunked ONCE (path/bottleneck chunk size) and every hop
        # relays those same chunks — so per-hop models and plans use the
        # hop's own stream count (per-leg tuning) with the job's chunking
        for i in hop_order:
            hop = route[i]
            res.hop_modeled_s[i] = simulate_transfer_s(
                res.hop_wire_bytes[i], hop.link, streams=hop.streams,
                chunk_bytes=self.path.chunk_bytes, pacing=hop.comm.pacing)
        res.wire_bytes = sum(res.hop_wire_bytes) + sum(
            sum(h["hop_wire_bytes"]) for h in res.reroute_history)
        res.modeled_s = sum(res.hop_modeled_s)   # store-and-forward: hops add
        if self.record:
            chunks, buckets = list(job.chunks), [list(b) for b in job.buckets]
            tel.note_plan(self.path.key, **st.plan_summary(
                chunks, buckets, self.path.streams, self.path.chunk_bytes,
                self.path.comm.pacing, algo="file",
                wire_bytes=res.wire_bytes))
            for i in hop_order:
                hop = route[i]
                tel.note_plan(self.path.hop_key(i), **st.plan_summary(
                    chunks, st.assign_streams(chunks, hop.streams),
                    hop.streams, self.path.chunk_bytes, hop.comm.pacing,
                    algo="file", wire_bytes=res.hop_wire_bytes[i]))
                tel.record(self.path.hop_key(i), res.hop_modeled_s[i],
                           nbytes=res.hop_wire_bytes[i])
            if record_total:
                tel.record(self.path.key, res.modeled_s,
                           nbytes=res.wire_bytes)
        if self.tuner is not None:
            cfg = self.tuner.observe(res.modeled_s)
            if cfg is not None:
                with self._path_lock:
                    self.path = self.path.with_(**cfg)
                if self.record:
                    tel.get_telemetry().path(self.path.key).note_retune(
                        None, cfg)

    # -- sidecar manifest ---------------------------------------------------
    @staticmethod
    def _sidecar_path(dst: str) -> str:
        return dst + SIDECAR_SUFFIX

    def _load_sidecar(self, job: FileJob) -> dict:
        """{chunk index: crc} of completed chunks, if the sidecar matches the
        current source (size + mtime) and chunking; else a fresh transfer."""
        try:
            with open(self._sidecar_path(job.dst)) as f:
                side = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}
        if (side.get("size") != job.nbytes
                or side.get("mtime") != job.mtime
                or side.get("chunk_bytes") != self.path.chunk_bytes
                or not os.path.exists(job.dst + PART_SUFFIX)):
            self._remove_sidecar(job.dst)
            return {}
        return {int(k): v for k, v in side.get("done", {}).items()}

    def _flush_sidecar(self, job: FileJob, done: dict) -> None:
        side = {"src": job.src, "size": job.nbytes, "mtime": job.mtime,
                "chunk_bytes": self.path.chunk_bytes,
                "done": {str(k): v for k, v in done.items()}}
        path = self._sidecar_path(job.dst)
        with open(path + ".tmp", "w") as f:
            json.dump(side, f)
        os.replace(path + ".tmp", path)

    def _remove_sidecar(self, dst: str) -> None:
        try:
            os.remove(self._sidecar_path(dst))
        except FileNotFoundError:
            pass

    def _abort(self, dst: str) -> None:
        """Drop partial state (vanished source: nothing to resume toward)."""
        self._remove_sidecar(dst)
        try:
            os.remove(dst + PART_SUFFIX)
        except FileNotFoundError:
            pass

    @staticmethod
    def _ensure_part(part: str, nbytes: int) -> None:
        """Pre-size the partial file so chunk writes land at their offsets."""
        if not os.path.exists(part) or os.path.getsize(part) != nbytes:
            with open(part, "wb") as f:
                if nbytes:
                    f.seek(nbytes - 1)
                    f.write(b"\0")


def local_transfer() -> FileTransfer:
    """Single-host fallback engine (the mirror default): local-fabric path,
    no compression, telemetry off, no finalize digest (the mirror discards
    the result; per-chunk CRCs still verify every byte)."""
    from repro_torch.core.path import local_path
    return FileTransfer(local_path(), record=False, digest=False)
