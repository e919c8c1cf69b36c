"""Trainer: the training loop of the port.

The port of the loop of the JAX package's ``runtime/train_loop.py``: fresh
initialization or a restore, the step loop with its history (loss, lr,
grad_norm, step seconds, the gradient sync's seconds, chunks and bytes, and
with a bucketed sync its mode and each bucket's), the straggler detector,
the path telemetry, site groups (the site-hierarchical gradient sync),
multi-hop routes with their per-hop samples, online autotuning, and
checkpoints with fault recovery and replicas, the chaos monitor's reroute
and replica failover, elastic site membership and local SGD.

Online autotuning (``autotune_every=N``) is the reference's: an
``OnlineTuner`` over the path's knobs, a step bundle built per config and
cached, a swap between steps that leaves the live state as it is.  The
reference is one process and feeds its tuner one step time, the slowest
device's; here every rank has a tuner, and ranks whose tuners saw other
times would build other bundles and post their collectives in other orders.
So every tuner is fed the same number, the largest of the ranks' step
times (one f32 all-reduce over the world after each step), and every rank
swaps at the same step to the same config.

Checkpoints (``ckpt_dir``) are the reference's ``CheckpointManager``: an
async save every `ckpt_every` steps and a blocking one at the end, `keep`
kept, mirrored to `replica_dir` by a DataGather (over the `route` with
mpw-cp when one is given, as the reference ships them).  One process of the
reference is several ranks here, so one rank writes: rank 0 (pod 0, data
rank 0), which under ZeRO first gathers its pod's shards over the data
group; the other ranks wait at a barrier.  A restore reads the step rank 0
chose and hands each leaf to every rank, its shard under ZeRO, on its
device.  A ``fault_hook`` that raises ``InjectedFault`` on any rank makes
every rank recover at the same step: after the hook the ranks all-reduce a
fault flag, so no rank is left inside a collective; as in the reference the
failed step's batch is consumed, not replayed, and the recoveries of one
streak are bounded by the ``retry`` policy.

Chaos and elasticity (``chaos=``, a ``core/chaos.py`` ``ChaosMonitor``;
``membership=``, a ``core/membership.py`` ``SiteMembership``; and
``CommConfig.local_steps > 1``) are the reference's: between steps the
monitor simulates the route's hops under their fault schedules and reroutes
(``apply_route``) or fails over to the replica (``failover_to_replica``);
an epoch change re-forms the delta sync's subgroup, catches rejoined sites
up from a survivor and resyncs the members (``_reconcile_membership``);
every K-th step ships the model delta across the sites (``_delta_sync``).
Every rank has its own monitor, membership and incident log.  Their
decisions come from step-stamped fault schedules and seeded simulations, so
every rank reaches the same one at the same step; after the hooks the ranks
compare their route, membership epoch, members and step (one object
all-gather) and raise :class:`MembershipDivergence` on a mismatch instead of
posting different collectives.  An evicted site's ranks stay live and post
every collective of the delta sync and the catch-up, zeros where the
reference masks them out.

With ``check_replicas`` the loop holds the data-parallel invariant after
every step, compared by a checksum of the parameters' bits: without ZeRO
every rank's parameters must be bit-identical; under ZeRO the ranks of each
pod group (one data index, one rank per pod) must hold bit-identical shards.
Under local SGD the sites differ between delta syncs by design: each step's
checksum is recorded and not compared.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import leaf_paths
from repro_torch.configs.base import RunConfig
from repro_torch.core.autotune import OnlineTuner, hop_shares
from repro_torch.core.collectives import TP_ITEM, all_gather_dim, queued
from repro_torch.core.localsgd import LocalSGDController
from repro_torch.core.retry import RetryPolicy, RetryState
from repro_torch.core.telemetry import get_telemetry
from repro_torch.core.tree import flatten, tree_map
from repro_torch.models.param import shard_leaf, tensor_from_numpy
from repro_torch.runtime.step import (StepBundle, build_catchup,
                                      build_delta_sync, build_train_step)


@dataclass
class StragglerDetector:
    """EWMA + z-score step-time anomaly detector."""
    alpha: float = 0.1
    z_thresh: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= 5:
            sd = max(self.var ** 0.5, 1e-9)
            z = (dt - self.mean) / sd
            is_straggler = z > self.z_thresh
        else:
            is_straggler = False
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


class ReplicaDivergence(RuntimeError):
    """Pod ranks hold different parameters after a step."""


class MembershipDivergence(RuntimeError):
    """Ranks disagree on the route, the membership or the step after the
    chaos and membership hooks."""


# odd multiplier of the element weights; products wrap mod 2^64
_MIX = 0x5851F42D4C957F2D
_SLICE = 1 << 24


def replica_checksum(params) -> int:
    """A checksum of the parameters' bits: each leaf's elements read as
    integers of their width and summed in int64, element i weighted by
    ``i * _MIX + 1`` (wrapping mod 2^64), then mixed with the leaf's index.
    The odd weights make the sum depend on where each value sits: two
    elements swapped, or +k and -k in two elements, change it.  Equal
    parameters give equal checksums on every rank; the sum runs on the
    leaf's device, a slice of elements at a time."""
    total = 0
    for i, p in enumerate(flatten(params)[0]):
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[p.element_size()]
        flat = p.detach().contiguous().view(bits).reshape(-1)
        s = torch.zeros((), dtype=torch.int64, device=flat.device)
        for a in range(0, flat.numel(), _SLICE):
            x = flat[a:a + _SLICE].to(torch.int64)
            w = torch.arange(a, a + x.numel(), dtype=torch.int64,
                             device=flat.device).mul_(_MIX).add_(1)
            s += (x * w).sum()
        total = (total * 1_000_003 + int(s) + i) % (1 << 61)
    return total


class Trainer:
    """The reference's keywords, in its order; `check_replicas` is the
    port's own."""

    def __init__(self, rc: RunConfig, mesh, *, ckpt_dir: Optional[str] = None,
                 replica_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, fault_hook: Optional[Callable[[int], None]] = None,
                 autotune_every: int = 0, route=None, site_groups=None,
                 chaos=None, membership=None,
                 retry: Optional[RetryPolicy] = None,
                 check_replicas: bool = False):
        self.rc = rc
        self.mesh = mesh
        if mesh.model > 1:
            _refuse_on_model_axis(checkpoints=ckpt_dir or replica_dir,
                                  chaos_monitor=chaos, membership=membership,
                                  online_autotuning=autotune_every)
        # `route` makes the cross-pod path a multi-hop Forwarder chain
        # (per-hop knobs and telemetry); `site_groups` makes the cross-pod
        # psum reduce intra-site before the slow hop
        self.route = route
        self.site_groups = site_groups
        # self-healing: a ChaosMonitor gets one hook per executed step
        # (between steps), from which it watches the route's links and
        # drives the reroute or the failover
        self.chaos = chaos
        # elastic membership: a SiteMembership whose epoch this loop
        # watches; a bump re-forms the local-SGD subgroup, re-tunes and
        # resyncs the surviving world (_reconcile_membership).  An attached
        # monitor drives its probes; without one the loop ticks them
        self.membership = membership
        if (chaos is not None and membership is not None
                and getattr(chaos, "membership", None) is None):
            chaos.membership = membership
        # fault-recovery budget: bounded checkpoint-restore attempts per
        # incident streak (a successful step resets the schedule)
        self.retry = retry or RetryPolicy(max_attempts=8)
        # local-SGD cadence (CommConfig.local_steps): K > 1 builds the
        # site-local step and ships a model delta every K-th step
        self.localsgd = LocalSGDController(rc.comm.local_steps)
        self.bundle: StepBundle = build_train_step(
            rc, mesh, route=route, site_groups=site_groups,
            local_only=self.localsgd.enabled)
        self._dsync = None           # the delta sync of this epoch
        self._dsync_built = False
        self._anchor = None          # the parameters at the last delta sync
        self._epoch_seen = membership.epoch if membership is not None else 0
        self._members_seen = (set(membership.members())
                              if membership is not None else set())
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.fault_hook = fault_hook
        self.detector = StragglerDetector()
        self.check_replicas = check_replicas
        # rank 0 (pod 0, data rank 0) writes the checkpoints
        self.writer = mesh.pod_index == 0 and mesh.data_index == 0
        self.manager = (CheckpointManager(
            ckpt_dir, keep=keep, replica_dir=replica_dir,
            transfer=self._ckpt_transfer(replica_dir))
            if ckpt_dir else None)
        self.state = None
        self.step = 0
        self.history: list[dict] = []
        # True whenever the next step is the first of a newly built bundle
        # (the initial one included): it pays the kernels' loading, new
        # stream groups and the allocator's and cuBLAS's warm-up, and stays
        # out of the straggler EWMA and telemetry
        self._fresh = True
        # online autotuning: one bundle per knob setting, built once and
        # cached, so a swap back to a config costs nothing
        self.tuner: Optional[OnlineTuner] = None
        self._bundles: dict[tuple, StepBundle] = {}
        if autotune_every and rc.comm.autotune and rc.comm.mode != "flat":
            p = self.bundle.path
            # probe bucket_mb only where this config can bucket
            # (hierarchical + ZeRO): elsewhere every probe would build a
            # bundle identical to the running one
            can_bucket = (self.bundle.bucket_plan is not None
                          or (p.comm.bucket_mb == 0.0 and self.bundle.zero
                              and p.comm.mode == "hierarchical"))
            self.tuner = OnlineTuner(streams=p.streams,
                                     chunk_mb=p.comm.chunk_mb,
                                     pacing=p.comm.pacing,
                                     algo=p.comm.algo,
                                     bucket_mb=p.comm.bucket_mb,
                                     tune_bucket=can_bucket,
                                     window=autotune_every)
            cfg0 = self.tuner.config()
            if (cfg0["streams"] == p.streams
                    and cfg0["chunk_mb"] == p.comm.chunk_mb
                    and cfg0["pacing"] == p.comm.pacing
                    and cfg0["algo"] == p.comm.algo
                    and cfg0.get("bucket_mb", p.comm.bucket_mb) == p.comm.bucket_mb):
                self._bundles[self._cfg_key(cfg0)] = self.bundle

    def _ckpt_transfer(self, replica_dir):
        """Checkpoint shipping engine: when this trainer spans sites (a
        topology `route` was given), replicas travel the same multi-hop
        route the gradients do (mpw-cp chunked, compressed transfers with
        per-hop telemetry under the ``ckpt:*`` keys) instead of a local
        copy.  Single-site trainers keep the local mirror (None)."""
        if not replica_dir or self.route is None:
            return None
        from repro_torch.core.filetransfer import FileTransfer
        from repro_torch.core.path import WidePath
        path = WidePath(axis="pod", comm=self.rc.comm, name="ckpt")
        # digest=False: the mirror loop discards FileResults, so the
        # finalize sha256 would be a second full read of every shard for
        # nothing (per-chunk CRCs already verify the bytes end to end)
        return FileTransfer(path.with_hops(
            self.route.as_hops(base_comm=self.rc.comm)), digest=False)

    # -- state management ----------------------------------------------------
    def _like(self) -> dict:
        """The state's structure (its leaves' names), as the checkpoint
        store numbers and names them."""
        defs = self.bundle.param_defs
        return {"params": defs, "opt": {"m": defs, "v": defs, "step": None}}

    def _scatter_dims(self) -> dict:
        """{leaf name: scatter dim} of the state's ZeRO-scattered leaves."""
        if not self.bundle.zero:
            return {}
        return {f"{pfx}/{name}": d
                for pfx in ("params", "opt/m", "opt/v")
                for name, d in leaf_paths(self.bundle.dims) if d is not None}

    def _place(self, name: str, t: torch.Tensor, dims: dict) -> torch.Tensor:
        """A restored full leaf as this rank holds it: its shard along its
        dim of `dims` (ZeRO: the reference reshards on restore), on the
        bundle's device."""
        d = dims.get(name)
        if d is not None:
            t = shard_leaf(t, d, self.mesh.data_index, self.mesh.data)
        return t.to(self.bundle.device)

    def _barrier(self) -> None:
        if self.mesh.world_group is not None:
            dist.barrier(group=self.mesh.world_group)

    def _from_rank0(self, value):
        """Rank 0's `value` on every rank."""
        if self.mesh.world_group is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.mesh.world_group)
        return box[0]

    def _restore(self) -> bool:
        """Restore every rank from the newest checkpoint rank 0 sees (the
        replica mirror when the primary directory has none); False when
        there is none.  Rank 0's pending save lands first."""
        if self.writer:
            self.manager.wait()
        self._barrier()
        want = None
        if self.writer and self.manager.has_checkpoint():
            steps = self.manager.steps() or self.manager._steps_in(
                self.manager.replica_dir)
            want = steps[-1]
        want = self._from_rank0(want)
        if want is None:
            return False
        dims = self._scatter_dims()
        self.state, manifest = self.manager.restore(
            self._like(), step=want, place=lambda n, t: self._place(n, t, dims))
        self.step = manifest["step"]
        return True

    def _save(self, block: bool) -> None:
        """Rank 0 saves the state (under ZeRO, pod 0's data ranks first
        gather their shards to it); the other ranks wait at a barrier."""
        state = self.state
        if self.bundle.zero and self.mesh.pod_index == 0:
            dims = {"params": self.bundle.dims, "opt": {
                "m": self.bundle.dims, "v": self.bundle.dims, "step": None}}
            group = self.mesh.data_group
            state = tree_map(lambda x, d: x if d is None else
                             all_gather_dim(x, d, group), state, dims)
        if self.writer:
            self.manager.save(self.step, state, block=block)
        self._barrier()

    def init_or_restore(self, seed: int = 0) -> str:
        """The newest checkpoint when there is one ("restored"), else fresh
        state from `seed` (under ZeRO, this rank's shards of it)."""
        if self.manager is not None and self._restore():
            return "restored"
        self.state = self.bundle.init_state(seed)
        return "initialized"

    def _place_batch(self, batch_np) -> dict:
        """This rank's rows of the global batch, every key of a dict batch
        alike (the tokens and the family's stub inputs), as the reference
        places the whole dict under its batch specs: with D data ranks, rank
        (p, d) takes rows [(p*D + d)*lb, (p*D + d + 1)*lb), lb = gb/(P*D),
        as ``P(("pod", "data"))`` gives them.  The token ids become int64;
        the other leaves keep their dtype (numpy's, ml_dtypes' bfloat16, or a
        tensor's)."""
        if not isinstance(batch_np, dict):
            batch_np = {"tokens": batch_np}
        m = self.mesh
        n = m.pod * m.data
        rows = batch_np["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"global batch {rows} does not split over "
                             f"{m.pod} pods x {m.data} data ranks")
        lb = rows // n
        r = m.pod_index * m.data + m.data_index
        out = {}
        for k, a in batch_np.items():
            if a.shape[0] != rows:
                raise ValueError(f"batch leaf {k!r} has {a.shape[0]} rows, "
                                 f"the tokens {rows}")
            part = a[r * lb:(r + 1) * lb]
            dtype = torch.int64 if k == "tokens" else None
            out[k] = (part.to(self.bundle.device, dtype) if isinstance(part, torch.Tensor)
                      else tensor_from_numpy(part, self.bundle.device, dtype))
        return out

    def _replicas_agree(self) -> int:
        """This rank's checksum, after checking it against those of the ranks
        that must hold the same bits: the pod group under ZeRO (the same
        shard), the world otherwise."""
        c = replica_checksum(self.state["params"])
        group = self.mesh.pod_group if self.bundle.zero else self.mesh.world_group
        if group is not None:
            mine = torch.tensor([c], dtype=torch.int64)
            every = [torch.zeros(1, dtype=torch.int64)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(every, mine, group=group)
            seen = [int(t) for t in every]
            if len(set(seen)) != 1:
                raise ReplicaDivergence(f"step {self.step}: replicas' parameter "
                                        f"checksums differ: {seen}")
        return c

    def run(self, data_iter, num_steps: int, *, log_every: int = 10,
            log: Callable[[str], None] = print) -> list[dict]:
        if self.state is None:
            raise RuntimeError("Trainer.state is unset; call init_or_restore() "
                               "before run()")
        target = self.step + num_steps
        dev = self.bundle.device
        # bounded recovery: restores are paced by the RetryPolicy schedule
        # (modeled backoff; a successful step resets the incident streak)
        retry = RetryState(self.retry)
        if self.localsgd.enabled and self._anchor is None:
            # the first K local steps diverge from this snapshot
            self._anchor = tree_map(lambda x: x.clone(), self.state["params"])
        while self.step < target:
            batch = self._place_batch(next(data_iter))
            ran = self.bundle
            t0 = time.perf_counter()
            fault = self._fault(self.step)
            if fault is not None:
                delay = retry.next_delay_s()
                if delay is None:
                    log(f"[fault] step {self.step}: {type(fault).__name__}: "
                        f"{fault}; recovery budget exhausted "
                        f"({self.retry.max_attempts} attempts)")
                    raise fault
                log(f"[fault] step {self.step}: {type(fault).__name__}: "
                    f"{fault}; restoring latest checkpoint "
                    f"(backoff {delay*1e3:.0f}ms modeled)")
                self._recover()
                continue
            self.state, metrics = ran.fn(self.state, batch)
            loss = float(metrics["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            retry.reset()
            dt = time.perf_counter() - t0
            fresh, self._fresh = self._fresh, False
            if fresh:
                straggler = False
            else:
                straggler = self.detector.observe(self.step, dt)
                if self.rc.comm.mode != "flat":   # flat: path carries nothing
                    get_telemetry().record(ran.path.key, dt, step=self.step)
                    self._record_hop_samples(dt)
            tuner_s = None
            if self.tuner is not None:
                tuner_s = self._slowest(dt)
                new_cfg = self.tuner.observe(tuner_s)
                if new_cfg is not None:
                    self._retune(new_cfg, log)
            if self.chaos is not None:
                # between steps (the step above has finished), so a route
                # swap or a failover here leaves no collective half posted
                self.chaos.on_step(self, log=log)
            elif self.membership is not None:
                # no monitor attached: the loop ticks the liveness probes
                self.membership.on_step(self.step)
            if self.chaos is not None or self.membership is not None:
                self._agree()
            if self.membership is not None:
                self._reconcile_membership(log)
            if self.localsgd.enabled and self.localsgd.is_sync_step(self.step):
                self._delta_sync(log)
            rec = {"step": self.step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "time_s": dt,
                   "straggler": straggler, "sync_s": metrics["sync_s"],
                   "gather_s": metrics["gather_s"],
                   "reduce_scatter_s": metrics["reduce_scatter_s"],
                   "wire_bytes": metrics["wire_bytes"],
                   "sent_bytes": metrics["sent_bytes"],
                   "payload_bytes": sum(c["payload_bytes"] for c in metrics["chunks"]),
                   "n_chunks": len(metrics["chunks"]),
                   # each chunk's extent along its dim and its f32 bytes
                   "chunk_sizes": [[c["size"], c["payload_bytes"]]
                                   for c in metrics["chunks"]],
                   "bucket_mode": metrics["bucket_mode"],
                   "n_buckets": len(metrics["buckets"]),
                   "buckets": metrics["buckets"],
                   # the knobs this step ran with; whether it was the first
                   # step of a newly built bundle; the time its tuner saw
                   "config": _knobs(ran.path), "fresh": fresh,
                   "tuner_s": tuner_s,
                   # the route and the membership after this step's hooks
                   **self._world_view()}
            if self.check_replicas:
                rec["checksum"] = (replica_checksum(self.state["params"])
                                   if self.localsgd.enabled
                                   else self._replicas_agree())
            self.history.append(rec)
            if log_every and self.step % log_every == 0:
                log(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
                    f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms"
                    + (" [straggler]" if straggler else ""))
            self.step += 1
            if self.manager and self.step % self.ckpt_every == 0:
                self._save(block=False)
        if self.manager:
            self._save(block=True)
            # ship the final checkpoint to the replica site now, not at the
            # background gatherer's next tick (the run may be over by then)
            if self.writer:
                self.manager.replicate_now()
            self._barrier()
        return self.history

    def _fault(self, step: int) -> Optional[Exception]:
        """Run the fault hook; the fault any rank's hook raised (an
        ``InjectedFault`` standing for one raised elsewhere), or None.  The
        ranks agree by an all-reduce of a fault flag, so all recover or
        none does."""
        if self.fault_hook is None:
            return None
        fault = None
        try:
            self.fault_hook(step)
        except _RECOVERABLE as e:
            fault = e
        if self.mesh.world_group is not None:
            flag = torch.tensor([0 if fault is None else 1], dtype=torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                            group=self.mesh.world_group)
            if int(flag) and fault is None:
                fault = InjectedFault(f"a fault on another rank at step {step}")
        return fault

    def _record_hop_samples(self, dt: float) -> None:
        """Per-hop telemetry for a multi-hop train path: split the step's
        wall time across hops by `autotune.hop_shares` (the same modeled
        split RouteTuner feeds its controllers with)."""
        path = self.bundle.path
        if not path.hops:
            return
        tel = get_telemetry()
        plan = tel.path(path.key).plan
        shares = hop_shares(path.route, plan.payload_bytes if plan else 0)
        for i in range(path.n_hops):
            tel.record(path.hop_key(i), dt * shares[i], step=self.step)

    def _slowest(self, dt: float) -> float:
        """The largest step time over every rank (`dt` with one rank): what
        the reference's one process measures, and the same on every rank."""
        group = self.mesh.world_group
        if group is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t)

    # -- local SGD and elastic membership -----------------------------------
    def _world_view(self) -> dict:
        """The route's sites, the membership's epoch and members (None
        where there is none)."""
        mem = self.membership
        return {"route": None if self.route is None else list(self.route.sites),
                "epoch": None if mem is None else mem.epoch,
                "members": None if mem is None else mem.members()}

    def _agree(self) -> None:
        """Every rank's step and :meth:`_world_view` after this step's chaos
        and membership hooks, compared over the world: ranks that decided
        otherwise would post other collectives from here on."""
        group = self.mesh.world_group
        if group is None:
            return
        mine = {"step": self.step, **self._world_view()}
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, mine, group=group)
        other = next((e for e in every if e != mine), None)
        if other is not None:
            raise MembershipDivergence(
                f"step {self.step}: rank {dist.get_rank()} holds {mine}, "
                f"another rank {other}")

    def _member_groups(self) -> Optional[list]:
        """Pod groups of the current epoch's live sites (all sites when no
        membership is attached)."""
        if self.site_groups is None:
            return None
        if self.membership is not None:
            return [list(g) for g in self.membership.member_pod_groups()]
        return [list(g) for g in self.site_groups]

    def _delta_sync(self, log: Callable[[str], None] = print,
                    full: bool = False) -> None:
        """Run one cross-site reconciliation (every K-th step).

        `full=True` averages the raw parameters (the delta against a zero
        anchor, ``x * 0`` as the reference makes it): the world-resize
        resync, which also gives every member pod the same anchor again."""
        if not self._dsync_built:
            self._dsync_built = True
            groups = self._member_groups()
            if groups is not None and len(groups) >= 2:
                self._dsync = build_delta_sync(
                    self.rc, self.mesh, self.bundle,
                    site_groups=self.site_groups,
                    member_pods=[p for g in groups for p in g],
                    member_gateways=[g[0] for g in groups])
        if self._dsync is None:
            return
        params = self.state["params"]
        if full:
            self._anchor = None      # replaced below: no second copy alive
        anchor = (tree_map(lambda x: x * 0, params) if full else self._anchor)
        if anchor is None:
            return
        new_p = self._dsync(params, anchor)
        self.state["params"] = new_p
        self._anchor = tree_map(lambda x: x.clone(), new_p)

    def _reconcile_membership(self, log: Callable[[str], None] = print) -> None:
        """React to a membership epoch bump: catch rejoined sites up from a
        survivor, re-form the delta sync's subgroup, re-tune for the
        resized world and resync the members (resize, catchup, retune,
        recover in the incident timeline).  Every rank runs it at the same
        step, members or not."""
        mem = self.membership
        if mem is None or mem.epoch == self._epoch_seen:
            return
        prev, self._epoch_seen = self._epoch_seen, mem.epoch
        members = mem.members()
        log(f"[elastic] step {self.step}: membership epoch {prev} -> "
            f"{mem.epoch}; members {members}")
        mem.log.add(self.step, "resize", ",".join(members),
                    {"epoch": mem.epoch, "from_epoch": prev,
                     "members": members})
        # rejoined sites first: clone a surviving gateway's parameters onto
        # their pods (the replica catch-up)
        joined = [s for s in members if s not in self._members_seen]
        survivors = [s for s in members if s in self._members_seen]
        if joined and survivors and self.site_groups is not None and self.mesh.pod > 1:
            topo = mem.topo
            names = [s.name for s in topo.sites]
            pg = [list(g) for g in topo.pod_groups()]
            targets = [p for n, g in zip(names, pg) if n in joined for p in g]
            cu = build_catchup(self.mesh, self.bundle,
                               source_pod=topo.site(survivors[0]).gateway,
                               target_pods=targets)
            if cu is not None:
                self.state["params"] = cu(self.state["params"])
                mem.log.add(self.step, "catchup", ",".join(joined),
                            {"source": survivors[0], "pods": targets})
        self._members_seen = set(members)
        # the old subgroup's sync and cost landscape are gone
        self._dsync = None
        self._dsync_built = False
        if self.tuner is not None:
            self.tuner.abort_probe()
            self.tuner.converged = False
            self.tuner.best_cost = None
        mem.log.add(self.step, "retune", self.bundle.path.key,
                    {"epoch": mem.epoch})
        if self.localsgd.enabled:
            # full resync: every member pod leaves with the same parameters
            # and the same anchor, which the incremental merge needs
            self._delta_sync(log, full=True)
        mem.log.add(self.step, "recover", ",".join(members),
                    {"epoch": mem.epoch})

    # -- online autotuning ----------------------------------------------------
    @staticmethod
    def _cfg_key(cfg: dict) -> tuple:
        return (cfg["streams"], cfg["chunk_mb"], cfg["pacing"],
                cfg.get("algo", "psum"), cfg.get("bucket_mb", 0.0))

    def _retune(self, cfg: dict, log: Callable[[str], None] = print) -> None:
        """Apply a tuner-proposed config between steps: swap to the cached
        or newly built bundle for those knobs.  Building one allocates no
        state: the live parameters and moments (under ZeRO this rank's
        shards) carry over as they are, their layout being the same for
        every knob setting, and a flush-mode bundle's hooks act only inside
        its own step."""
        comm = dataclasses.replace(self.rc.comm, autotune=False, **cfg)
        self.rc = dataclasses.replace(self.rc, comm=comm)
        key = self._cfg_key(cfg)
        if key not in self._bundles:
            self._bundles[key] = build_train_step(
                self.rc, self.mesh, route=self.route,
                site_groups=self.site_groups, local_only=self.localsgd.enabled)
            self._fresh = True
        self.bundle = self._bundles[key]
        # the delta sync inherits the path's knobs: rebuilt at the next sync
        self._dsync = None
        self._dsync_built = False
        if self.bundle.replan is not None:
            # a cached bundle noted its plan when it was built: re-note it,
            # or the telemetry would describe the last-built config
            self.bundle.replan()
        get_telemetry().path(self.bundle.path.key).note_retune(self.step, cfg)
        log(f"[autotune] step {self.step}: trying streams={cfg['streams']} "
            f"chunk={cfg['chunk_mb']}MiB pacing={cfg['pacing']}"
            + (f" algo={cfg['algo']}" if "algo" in cfg else "")
            + (f" bucket={cfg['bucket_mb']}MiB" if "bucket_mb" in cfg else ""))

    # -- routes and recovery --------------------------------------------------
    def apply_route(self, new_route, log: Callable[[str], None] = print) -> None:
        """Swap the training path onto a replanned route, between steps: the
        live state carries over untouched (its layout is the same on every
        route), the bundles built for the old route are dropped, and the
        tuner restarts its climb from the incumbent."""
        self.route = new_route
        self._bundles.clear()        # keyed by knobs, not route: invalidate
        self.bundle = build_train_step(self.rc, self.mesh, route=new_route,
                                       site_groups=self.site_groups,
                                       local_only=self.localsgd.enabled)
        self._fresh = True
        self._dsync = None
        self._dsync_built = False
        if self.tuner is not None:
            self.tuner.abort_probe()
            self.tuner.converged = False
            self.tuner.best_cost = None
        log(f"[chaos] step {self.step}: route replanned -> "
            + " -> ".join(str(s) for s in getattr(new_route, 'sites', ())))

    def failover_to_replica(self, log: Callable[[str], None] = print) -> str:
        """Whole-site loss: the remote site is unreachable on any route.
        Drop the cross-site route (train on without it) and restore from
        the newest restorable checkpoint: the replica mirror when the
        primary directory died with the site.  Rank 0 decides whether there
        is one and which step (its manager wrote them), every rank restores
        that step (:meth:`_restore`); "degraded" when there is none.  Runs
        between steps on every rank at once, as the monitor decides it."""
        self.route = None
        self._bundles.clear()
        self.bundle = build_train_step(self.rc, self.mesh, route=None,
                                       site_groups=self.site_groups,
                                       local_only=self.localsgd.enabled)
        self._fresh = True
        self._dsync = None
        self._dsync_built = False
        outcome = "degraded"
        if self.manager is not None and self._restore():
            outcome = "restored"
        log(f"[chaos] step {self.step}: site lost; failover ({outcome})")
        return outcome

    def _recover(self) -> None:
        if not self.manager or not self._restore():
            raise RuntimeError("fault with no checkpoint to restore from")

    def close(self) -> None:
        if self.manager:
            self.manager.close()


class InjectedFault(RuntimeError):
    """Raised by test fault hooks to simulate node failure."""


_RECOVERABLE = (InjectedFault,)


def _refuse_on_model_axis(**features) -> None:
    """Raise, naming ROADMAP.md's item, for the Trainer's features that a
    model axis does not run yet (checkpoints, chaos, membership, online
    autotuning)."""
    for what, on in features.items():
        if on:
            raise queued(f"the Trainer's {what.replace('_', ' ')} over model ranks",
                         TP_ITEM)


def elastic_restart(rc: RunConfig, old_trainer: Trainer, new_mesh, **kw) -> Trainer:
    """Restart training on another mesh (node loss, scale-down): a new
    Trainer restores the old trainer's checkpoints in the new layout (the
    store reshards: each rank takes its shard of every leaf).  `new_mesh`
    spans the same processes as the old one (say 2 pods x 2 data ranks
    re-formed as 1 pod x 4), its groups created on every rank in one fixed
    order (``launch/mesh.py``); a shrink to fewer processes would start the
    process group again, which this port does not do."""
    old_trainer.close()
    t = Trainer(rc, new_mesh,
                ckpt_dir=old_trainer.manager.dir if old_trainer.manager else None,
                **kw)
    t.init_or_restore()
    return t


def _knobs(path) -> dict:
    """The tuner's knobs of a path."""
    return {"streams": path.streams, "chunk_mb": path.comm.chunk_mb,
            "pacing": path.comm.pacing, "algo": path.comm.algo,
            "bucket_mb": path.comm.bucket_mb}
