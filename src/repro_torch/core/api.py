"""Paper-faithful MPW_* API facade (Table 2 of the paper): the port of the
JAX package's ``core/api.py``.

MPWide exposes a tiny C-style API; higher-level services are asked to
integrate it as a module.  This facade offers the same verbs over the pod
ring of a :class:`repro_torch.launch.mesh.PodMesh` (given to
:meth:`MPW.Init`), so coupled-application code reads like an MPWide
program: every rank of the mesh runs the same calls, as every device of the
reference's shard_map does.  Without a mesh (or with one pod) the message
verbs return their payload, as the reference's do where the pod axis is
absent.  The file verbs (FileSend/FileRecv/FileCopy/DataGather: the paper's
mpw-cp tool and DataGather service) are host-side and run anywhere.

Differences from the C++ API:
  * buffers are trees of tensors, not char*.  MPW_DSendRecv ("unknown size
    using caching") keeps the paper's interface by carrying (max-size
    buffer, length) pairs.
  * MPW_ISendRecv posts the gloo sends and receives and returns a token
    around their works: ``Has_NBE_Finished`` polls them, ``Wait`` waits and
    returns the received tree.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field, replace
from typing import Optional

import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core import cycle as cy
from repro_torch.core.autotune import OnlineTuner, RouteTuner, autotune_path
from repro_torch.core.collectives import streamed_psum
from repro_torch.core.path import INTERPOD, Hop, WidePath
from repro_torch.core.telemetry import get_telemetry
from repro_torch.core.tree import flatten


@dataclass
class _PathState:
    path: WidePath
    tuner: Optional[OnlineTuner] = None        # single-link paths
    route_tuner: Optional[RouteTuner] = None   # multi-hop paths (per hop)
    batcher: Optional[object] = None           # ContinuousBatcher, via Serve()


# process-wide path ids: telemetry keys ("mpw{pid}:{link}") must stay unique
# across MPW sessions, or a new session's stats would merge into an old
# session's registry slot
_PATH_IDS = itertools.count()


@dataclass
class MPW:
    """One MPWide session (MPW_Init .. MPW_Finalize) on this rank of
    `mesh`."""
    paths: dict[int, _PathState] = field(default_factory=dict)
    membership: Optional[object] = None   # SiteMembership, via Membership()
    mesh: Optional[object] = None         # the PodMesh the messages cross

    # -- lifecycle ---------------------------------------------------------
    @staticmethod
    def Init(mesh=None) -> "MPW":
        return MPW(mesh=mesh)

    def Finalize(self) -> None:
        self.paths.clear()

    # -- path management ----------------------------------------------------
    def CreatePath(self, axis: str = "pod", nstreams: int = 32,
                   link=INTERPOD, comm: Optional[CommConfig] = None) -> int:
        comm = comm or CommConfig(streams=nstreams)
        pid = next(_PATH_IDS)
        self.paths[pid] = _PathState(
            WidePath(axis=axis, comm=comm, link=link, name=f"mpw{pid}"))
        return pid

    def CreatePathVariadic(self, axis: str = "pod",
                           streams_per_hop=(32,), links=None,
                           comm: Optional[CommConfig] = None) -> int:
        """MPW_CreatePathVariadicStreams: a path whose legs each get their
        own stream count (paper: per-leg tuning of a Forwarder route).

        `links` is an optional per-hop sequence of LinkSpecs (or topology
        LinkProfiles via `.spec`); hops default to consecutive +1 ring
        shifts.  A single-entry `streams_per_hop` degrades to CreatePath.
        """
        comm = comm or CommConfig()
        links = list(links) if links is not None else [INTERPOD] * len(streams_per_hop)
        if len(links) != len(streams_per_hop):
            raise ValueError(
                f"CreatePathVariadic: streams_per_hop has "
                f"{len(streams_per_hop)} entr{'y' if len(streams_per_hop) == 1 else 'ies'} "
                f"but links has {len(links)} — they must align per hop")
        pid = next(_PATH_IDS)
        hops = tuple(
            Hop(name=f"hop{i}-{lk.name}", link=lk,
                comm=replace(comm, streams=int(s)), shift=1)
            for i, (s, lk) in enumerate(zip(streams_per_hop, links)))
        base = WidePath(axis=axis, comm=comm, name=f"mpw{pid}")
        self.paths[pid] = _PathState(base.with_hops(hops))
        return pid

    def CreateForwarder(self, topo, src: str, dst: str, *,
                        metric: str = "latency",
                        comm: Optional[CommConfig] = None) -> int:
        """Set up the paper's Forwarder: plan a route src -> dst through the
        topology (relaying across intermediate sites when there is no direct
        link) and register it as a multi-hop path.  `Relay`/`Forward` then
        store-and-forward along it; `PathStats` reports every hop."""
        from repro_torch.core.topology import Forwarder
        pid = next(_PATH_IDS)
        fwd = Forwarder(topo, src, dst, metric=metric, comm=comm,
                        name=f"mpw{pid}-{src}-{dst}")
        self.paths[pid] = _PathState(fwd.path)
        return pid

    def Forward(self, pid: int, tree, dims=None, reverse: bool = False):
        """Relay a payload along the path's route, store-and-forward (the
        Forwarder data plane; single-link paths degrade to one shift)."""
        return cy.forward(tree, self.path(pid), self.mesh, dims=dims,
                          reverse=reverse)

    def Route(self, pid: int) -> list:
        """Hop descriptions of a path's route (name, link, shift, knobs)."""
        return [{"hop": i, "name": h.name, "link": h.link.name,
                 "shift": h.shift, "streams": h.streams,
                 "chunk_mb": h.comm.chunk_mb, "pacing": h.comm.pacing}
                for i, h in enumerate(self.path(pid).route)]

    def DestroyPath(self, pid: int) -> None:
        del self.paths[pid]

    def path(self, pid: int) -> WidePath:
        return self.paths[pid].path

    # -- tuning knobs (paper names) ------------------------------------------
    def setChunkSize(self, pid: int, nbytes: int) -> None:
        self.paths[pid].path = self.paths[pid].path.with_(chunk_mb=nbytes / (1 << 20))

    def setPacingRate(self, pid: int, rate: float) -> None:
        self.paths[pid].path = self.paths[pid].path.with_(pacing=rate)

    def setAlgorithm(self, pid: int, algo: str) -> None:
        """Select the cross-pod all-reduce algorithm (beyond the C API):
        "psum" (one collective per chunk; gather-based when compressed),
        "ring" / "ring2" (bandwidth-optimal ppermute rings — see
        repro/core/ring.py)."""
        from repro_torch.core.ring import ALGOS
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r}; have {ALGOS}")
        self.paths[pid].path = self.paths[pid].path.with_(algo=algo)

    def setBucketSize(self, pid: int, nbytes: int) -> None:
        """Select the gradient-sync bucket size (beyond the C API): > 0
        splits all-reduce payloads into ~nbytes buckets along the stacked
        `layers` dim so transfers flush during backprop and the exposed
        tail is consumed bucket-by-bucket (repro/core/buckets.py); 0
        restores one whole-tree sync."""
        if nbytes < 0:
            raise ValueError(f"bucket size must be >= 0, got {nbytes}")
        self.paths[pid].path = self.paths[pid].path.with_(
            bucket_mb=nbytes / (1 << 20))

    def setWin(self, pid: int, nbytes: int) -> None:
        # TCP window -> chunk payload sizing against the link BDP
        self.setChunkSize(pid, nbytes)

    def setLocalSteps(self, pid: int, k: int) -> None:
        """Select the local-SGD cadence (beyond the C API): K > 1 keeps
        each step's gradient sync inside the site and ships a model delta
        across the WAN only every K-th step (repro_torch/core/localsgd.py); 1
        restores the fully synchronous sync.  A Trainer built from this
        path's CommConfig picks the cadence up at build time."""
        if k < 1:
            raise ValueError(f"local steps must be >= 1, got {k}")
        self.paths[pid].path = self.paths[pid].path.with_(local_steps=int(k))

    def Membership(self, topo, coordinator: str, **kw):
        """Attach elastic site membership (beyond the C API): lease-based
        liveness probed over `topo`'s links from the `coordinator` site,
        monotonic epochs, quorum, evict/rejoin — see
        repro_torch/core/membership.py.  Keyword args pass through to
        :class:`~repro_torch.core.membership.SiteMembership` (lease_steps,
        rejoin_after, quorum, retry, seed, ...).  The session keeps the
        instance (``self.membership``) so a Trainer and a ChaosMonitor can
        share it; calling again replaces it."""
        from repro_torch.core.membership import SiteMembership
        self.membership = SiteMembership(topo, coordinator, **kw)
        return self.membership

    # -- serving (beyond the C API; the paper's client-server claim) ---------
    def Serve(self, pid: int, *, max_slots: int, queue_limit: int = 64,
              prefill_steps=1, step_s: float = 1e-2, kv_bytes=0,
              ship_steps=None, deadline_steps=None, shed: bool = True,
              topo=None, prefill_site: Optional[str] = None,
              decode_site: Optional[str] = None, membership=None,
              retry=None, max_reships: int = 2,
              ship_timeout_s: float = 0.5, log=None):
        """Attach a continuous-batching serving scheduler to a path.

        The path is the WAN leg prefilled KV caches cross in a
        disaggregated deployment: `kv_bytes` (an int, or a callable of the
        :class:`~repro_torch.core.serving.Request` — e.g. proportional to
        prompt_len via :func:`~repro_torch.core.kvship.kv_cache_bytes`) converts
        into per-request ship steps through the path's deterministic link
        model; `ship_steps` (int or callable) overrides the model outright.
        Returns the :class:`~repro_torch.core.serving.ContinuousBatcher`;
        calling again replaces it.  The runtime engine
        (`repro_torch.runtime.serving.ServingEngine`) drives the same scheduler
        with real prefill/ship/decode work.

        Fault tolerance: `deadline_steps` (+ `shed`) turns on per-request
        SLOs with load shedding.  With `topo` + `prefill_site` +
        `decode_site`, KV ships run through a
        :class:`~repro_torch.core.serving.FaultAwareShipper` — the topology's
        `LinkProfile` fault schedules apply, failed ships retry through
        `retry` (:data:`~repro_torch.core.retry.KVSHIP_RETRY` by default) and
        reroute after `max_reships` — and a `membership` (defaults to the
        session's, from :meth:`Membership`) fails the serving roles over
        off evicted sites.  Incidents land in `log` (defaults to the
        session incident log, so they show in :meth:`Report`)."""
        from repro_torch.core.chaos import get_incident_log
        from repro_torch.core.serving import (ContinuousBatcher, FaultAwareShipper,
                                        modeled_ship_steps)
        st = self.paths[pid]
        path = st.path
        if log is None:
            log = get_incident_log()
        if membership is None and topo is not None:
            membership = self.membership
        shipper = None
        if topo is not None:
            if not (prefill_site and decode_site):
                raise ValueError(
                    f"Serve with topo needs prefill_site and decode_site, "
                    f"got prefill_site={prefill_site!r} "
                    f"decode_site={decode_site!r}")
            shipper = FaultAwareShipper(
                topo, prefill_site, decode_site, kv_bytes=kv_bytes,
                step_s=step_s, retry=retry, max_reships=max_reships,
                timeout_s=ship_timeout_s, log=log, name=path.key)
        if ship_steps is not None:
            ship = ship_steps
        elif callable(kv_bytes):
            ship = lambda r: modeled_ship_steps(int(kv_bytes(r)), path, step_s)
        elif kv_bytes:
            ship = modeled_ship_steps(int(kv_bytes), path, step_s)
        else:
            ship = 0
        st.batcher = ContinuousBatcher(
            max_slots, queue_limit, prefill_steps=prefill_steps,
            ship_steps=ship, step_s=step_s, name=path.key,
            deadline_steps=deadline_steps, shed=shed, shipper=shipper,
            log=log, membership=membership, prefill_site=prefill_site,
            decode_site=decode_site)
        return st.batcher

    def Admit(self, pid: int, prompt_len: int, max_new: int,
              deadline_steps: Optional[int] = None) -> Optional[int]:
        """Admission control: submit one request to the path's serving
        scheduler.  Returns the request id, or None when the request is
        rejected (queue full) or shed (its modeled completion under
        current link health already blows `deadline_steps`)."""
        st = self.paths[pid]
        if st.batcher is None:
            raise ValueError(f"path {pid} has no serving scheduler — call "
                             f"Serve(pid={pid}, ...) first")
        return st.batcher.submit(prompt_len, max_new,
                                 deadline_steps=deadline_steps)

    def ServeStats(self, pid: int, drain: bool = True) -> dict:
        """Serving stats for a path's scheduler: completion/rejection/
        timeout/shed counts, reship/reroute/failover counters and the
        `degraded` flag, SLO attainment, latency and TTFT percentiles,
        goodput (modeled seconds), plus the deterministic event
        `timeline`.  `drain=True` first steps the virtual clock until
        every admitted request is terminal."""
        st = self.paths[pid]
        if st.batcher is None:
            raise ValueError(f"path {pid} has no serving scheduler — call "
                             f"Serve(pid={pid}, ...) first")
        if drain:
            st.batcher.drain()
        out = st.batcher.stats()
        out["timeline"] = st.batcher.timeline()
        return out

    def setAutoTuning(self, pid: int, enabled: bool,
                      payload_bytes: Optional[int] = None, *,
                      online: bool = True, window: int = 5) -> None:
        """MPW_setAutoTuning (paper: on by default).

        With `payload_bytes` the path gets the model-based warm start
        (alpha-beta optimum for that payload).  With `online` (beyond the C
        API) an :class:`OnlineTuner` is attached: feed measured seconds via
        :meth:`Observe` and the path re-tunes itself every `window` samples.
        Multi-hop paths get a :class:`RouteTuner` — one controller per hop,
        because the legs of a Forwarder route have different optima (the
        paper: >=32 streams WAN, 1 LAN on the same route).
        """
        st = self.paths[pid]
        p = st.path.with_(autotune=enabled)
        if enabled and payload_bytes:
            p = autotune_path(p, payload_bytes)
        st.path = p
        st.tuner = st.route_tuner = None
        if enabled and online:
            if p.hops:
                st.route_tuner = RouteTuner(p, window=window)
            else:
                st.tuner = OnlineTuner(streams=p.streams,
                                       chunk_mb=p.comm.chunk_mb,
                                       pacing=p.comm.pacing,
                                       algo=p.comm.algo,
                                       bucket_mb=p.comm.bucket_mb,
                                       window=window)

    def Observe(self, pid: int, seconds: float,
                nbytes: Optional[int] = None,
                hop: Optional[int] = None) -> bool:
        """Feed one measured transfer/step time for a path (beyond the C
        API; the paper's library measures inside its own send loop — here
        the caller times its transfers and steps and reports them).

        Records the sample in telemetry and, when autotuning is on, advances
        the online controller.  On a multi-hop path, `hop` attributes the
        sample to one leg; without it the end-to-end time is split across
        hops by modeled share and every hop's controller advances.  Returns
        True when any hop was re-tuned — callers holding compiled
        executables should rebuild on True.
        """
        st = self.paths[pid]
        tel = get_telemetry()
        if hop is not None:
            if not 0 <= hop < st.path.n_hops:
                raise ValueError(f"hop {hop} out of range for a "
                                 f"{st.path.n_hops}-hop path")
            if not st.path.hops:
                hop = None   # single-link: the path IS the hop
        if hop is not None:
            tel.record(st.path.hop_key(hop), seconds, nbytes=nbytes)
            if st.route_tuner is None:
                return False
            cfg = st.route_tuner.observe(hop, seconds)
            if cfg is None:
                return False
            st.path = st.path.with_hop(hop, **cfg)
            tel.path(st.path.hop_key(hop)).note_retune(None, cfg)
            return True
        tel.record(st.path.key, seconds, nbytes=nbytes)
        if st.route_tuner is not None:
            plan = tel.path(st.path.key).plan
            payload = nbytes if nbytes is not None else (
                plan.payload_bytes if plan else 0)
            retunes = st.route_tuner.observe_total(seconds, payload)
            for i, cfg in retunes.items():
                st.path = st.path.with_hop(i, **cfg)
                tel.path(st.path.hop_key(i)).note_retune(None, cfg)
            return bool(retunes)
        if st.tuner is None:
            return False
        cfg = st.tuner.observe(seconds)
        if cfg is None:
            return False
        st.path = st.path.with_(**cfg)
        get_telemetry().path(st.path.key).note_retune(None, cfg)
        return True

    # -- telemetry (beyond the C API; the paper's mpwtest diagnostics) -------
    def PathStats(self, pid: int) -> dict:
        """Per-path stats: plan shape, transfer counts, achieved GB/s.
        Multi-hop paths add a `hops` list with one summary per leg."""
        p = self.paths[pid].path
        out = get_telemetry().path(p.key).summary()
        if p.hops:
            out["hops"] = [get_telemetry().path(k).summary()
                           for k in p.hop_keys()]
        return out

    def Report(self, formatted: bool = False):
        """All per-path stats recorded in this process (facade paths and the
        runtime loops' train/serve paths alike).  The formatted report
        appends the incident timeline whenever the chaos layer recorded one
        (fault injected -> detected -> action -> recovery latency), so one
        artifact carries both the throughput story and the root cause."""
        t = get_telemetry()
        if not formatted:
            return t.report()
        out = t.format_report()
        from repro_torch.core.chaos import get_incident_log
        log = get_incident_log()
        if log.events():
            out += "\n\n**Incidents**\n\n" + log.format_timeline()
        return out

    def Incidents(self, clear: bool = False):
        """The chaos incident timeline as JSON-friendly rows ({step, event,
        subject, detail}): every injected fault and every automatic
        response — detect, replan, retune, requeue, failover, recover (with
        `latency_steps`).  `clear=True` drains the log after reading."""
        from repro_torch.core.chaos import get_incident_log
        log = get_incident_log()
        rows = log.timeline()
        if clear:
            log.clear()
        return rows

    # -- data movement ------------------------------------------------------
    def Send(self, pid: int, tree, shift: int = 1, dims=None):
        """Send to the ring neighbour; returns what the neighbour sent us
        (the sends are symmetric: this is MPW_SendRecv's send half)."""
        return cy.pod_shift(tree, self.path(pid), self.mesh, shift, dims=dims)

    def Recv(self, pid: int, tree, shift: int = 1, dims=None):
        return cy.pod_shift(tree, self.path(pid), self.mesh, -shift, dims=dims)

    def SendRecv(self, pid: int, tree, shift: int = 1, dims=None):
        return cy.sendrecv(tree, self.path(pid), self.mesh, shift, dims=dims)

    def DSendRecv(self, pid: int, tree, length, max_len: int,
                  shift: int = 1):
        """Unknown-size exchange: ships (buffer, length); receiver masks."""
        leaves = flatten(tree)[0]
        dev = leaves[0].device if leaves else torch.device("cpu")
        payload = {"buf": tree,
                   "len": torch.as_tensor(length, dtype=torch.int32, device=dev)}
        out = cy.sendrecv(payload, self.path(pid), self.mesh, shift)
        return out["buf"], out["len"]

    def ISendRecv(self, pid: int, tree, shift: int = 1):
        """Non-blocking exchange: posts the sends and receives and returns
        (pending, token), both the posted exchange; ``Wait(pending, token)``
        returns the received tree.  A multi-hop path relays hop by hop, each
        hop waiting for the one before, so it completes here."""
        path = self.path(pid)
        if path.hops:
            out = cy.sendrecv(tree, path, self.mesh, shift)
            token = cy.ShiftPending([], [], lambda _: out)
        else:
            token = cy.pod_shift_start(tree, path, self.mesh, shift)
        return token, token

    def Has_NBE_Finished(self, token) -> bool:
        """Whether every send and receive of the exchange has completed."""
        return token.is_completed()

    def Wait(self, value, token):
        """Wait for the exchange and return the tree it received."""
        return token.finish()

    def AllReduce(self, pid: int, tree, dims=None, site_groups=None):
        """Not in the C API (MPWide users hand-roll it); provided because
        gradient sync is the dominant use in this framework.  `site_groups`
        (Topology.pod_groups) reduces intra-site before the slow hop."""
        return streamed_psum(tree, self.path(pid), self.mesh, dims=dims,
                             site_groups=site_groups)

    def Cycle(self, recv_pid: int, send_pid: int, tree, dims=None):
        return cy.cycle(self.path(recv_pid), self.path(send_pid), tree,
                        self.mesh, dims=dims)

    def Relay(self, pid: int, tree, hops: int = 1, dims=None):
        return cy.relay(tree, self.path(pid), self.mesh, hops, dims=dims)

    def Barrier(self):
        return cy.barrier(self.mesh)

    @staticmethod
    def DNSResolve(host: str) -> str:
        """Mesh 'addressing': pods are ranks, not hostnames."""
        return host

    # -- file transfer (mpw-cp / DataGather; paper §"moving files") ----------
    def _file_engine(self, pid: int):
        # a fresh engine per call reads the path's *current* knobs, so
        # setChunkSize / Observe-driven retunes apply to the next transfer.
        # File timings carry no signal about the collective algorithm or
        # the gradient-sync bucket size, so a path that ships files stops
        # probing those knobs (its other knobs — streams/chunk/pacing —
        # stay shared with collectives).
        from repro_torch.core.filetransfer import FileTransfer
        st = self.paths[pid]
        if st.tuner is not None:
            st.tuner.pin_algo()
            st.tuner.pin_bucket()
            # pinning reverts the *tuner's* state; if a probe was already
            # applied to the path it must be reverted there too — future
            # configs exclude the pinned knob, so nothing else would undo it
            incumbent = st.tuner.grids["algo"][st.tuner.best_idx["algo"]]
            if st.path.comm.algo != incumbent:
                st.path = st.path.with_(algo=incumbent)
            bucket = st.tuner.grids["bucket_mb"][st.tuner.best_idx["bucket_mb"]]
            if st.path.comm.bucket_mb != bucket:
                st.path = st.path.with_(bucket_mb=bucket)
        return FileTransfer(self.path(pid))

    def FileSend(self, pid: int, src: str, dst: str, *, resume: bool = True):
        """mpw-cp's send half: ship one local file along the path's route
        (multi-hop routes store-and-forward with per-hop telemetry).
        Chunked over the path's streams, per-chunk checksums, lossless
        per-chunk compression when the path's `compress` knob is on, and
        resumable via the `<dst>.mpwcp.json` sidecar.  Returns the
        :class:`~repro_torch.core.filetransfer.FileResult`."""
        res = self._file_engine(pid).copy(src, dst, resume=resume,
                                          record_total=False)
        self.Observe(pid, res.modeled_s, nbytes=res.wire_bytes)
        return res

    def FileRecv(self, pid: int, src: str, dst: str, *, resume: bool = True):
        """mpw-cp's receive half: pull a file along the *reverse* route
        (the return direction of a bidirectional Forwarder path)."""
        res = self._file_engine(pid).copy(src, dst, resume=resume,
                                          reverse=True, record_total=False)
        self.Observe(pid, res.modeled_s, nbytes=res.wire_bytes)
        return res

    def FileCopy(self, pid: int, src: str, dst: str, *, resume: bool = True):
        """mpw-cp: copy a file *or a directory tree* over the path.  A
        directory becomes a manifest walk — one FileJob per file.  Returns
        one FileResult, or the list of per-file results for a tree."""
        eng = self._file_engine(pid)
        if os.path.isdir(src):
            results = eng.copy_tree(src, dst, resume=resume,
                                    record_total=False)
            self.Observe(pid, sum(r.modeled_s for r in results),
                         nbytes=sum(r.wire_bytes for r in results))
            return results
        res = eng.copy(src, dst, resume=resume, record_total=False)
        self.Observe(pid, res.modeled_s, nbytes=res.wire_bytes)
        return res

    def DataGather(self, pid: int, src_dir: str, dst_dir: str, *,
                   interval_s: float = 2.0, start: bool = True):
        """The paper's DataGather service: continuously mirror `src_dir` to
        `dst_dir`, shipping stale files over this path (manifest diff ->
        FileJobs).  Returns the :class:`~repro_torch.checkpoint.replicate.
        DataGather` thread handle (running when `start`; call ``.stop()``
        to drain and join)."""
        from repro_torch.checkpoint.replicate import DataGather as _DG
        eng = self._file_engine(pid)
        # the mirror discards FileResults: skip the finalize sha256 re-read
        # (per-chunk CRCs already verify every byte)
        eng.digest = False
        g = _DG(src_dir, dst_dir, interval_s=interval_s, transfer=eng)
        return g.start() if start else g
