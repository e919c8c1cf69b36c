"""Trainer: the training loop of the port.

The port of the loop of the JAX package's ``runtime/train_loop.py``: fresh
initialization, the step loop with its history (loss, lr, grad_norm, step
seconds, the gradient sync's seconds, chunks and bytes, and with a bucketed
sync its mode and each bucket's), the straggler detector, the path
telemetry, site groups (the site-hierarchical gradient sync) and online
autotuning.  Checkpointing and fault recovery, routes, chaos, elastic
membership and local SGD are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.

Online autotuning (``autotune_every=N``) is the reference's: an
``OnlineTuner`` over the path's knobs, a step bundle built per config and
cached, a swap between steps that leaves the live state as it is.  The
reference is one process and feeds its tuner one step time, the slowest
device's; here every rank has a tuner, and ranks whose tuners saw other
times would build other bundles and post their collectives in other orders.
So every tuner is fed the same number, the largest of the ranks' step
times (one f32 all-reduce over the world after each step), and every rank
swaps at the same step to the same config.

With ``check_replicas`` the loop holds the data-parallel invariant after
every step, compared by a checksum of the parameters' bits: without ZeRO
every rank's parameters must be bit-identical; under ZeRO the ranks of each
pod group (one data index, one rank per pod) must hold bit-identical shards.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig
from repro_torch.core.autotune import OnlineTuner
from repro_torch.core.collectives import queued
from repro_torch.core.telemetry import get_telemetry
from repro_torch.core.tree import flatten
from repro_torch.runtime.step import StepBundle, build_train_step


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
    port's own.  `ckpt_every` and `keep` are kept for the checkpoints,
    which are queued with `ckpt_dir`."""

    def __init__(self, rc: RunConfig, mesh, *, ckpt_dir: Optional[str] = None,
                 replica_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, fault_hook: Optional[Callable[[int], None]] = None,
                 autotune_every: int = 0, route=None, site_groups=None,
                 chaos=None, membership=None, retry=None,
                 check_replicas: bool = False):
        if ckpt_dir is not None:
            raise queued("checkpoints (ckpt_dir)", "facade, relays, files, checkpoints")
        if replica_dir is not None:
            raise queued("checkpoint replicas (replica_dir)",
                         "facade, relays, files, checkpoints")
        if fault_hook is not None:
            raise queued("fault_hook recovery (restore from a checkpoint)",
                         "facade, relays, files, checkpoints")
        if retry is not None:
            raise queued("the fault-recovery budget (retry)",
                         "facade, relays, files, checkpoints")
        if route is not None:
            raise queued("a multi-hop route", "facade, relays, files, checkpoints")
        if chaos is not None or membership is not None:
            raise queued("chaos and elastic membership",
                         "topology, chaos and elasticity")
        if rc.comm.local_steps > 1:
            raise queued(f"local SGD (local_steps = {rc.comm.local_steps})",
                         "topology, chaos and elasticity")
        self.rc = rc
        self.mesh = mesh
        self.site_groups = site_groups
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.bundle: StepBundle = build_train_step(rc, mesh,
                                                   site_groups=site_groups)
        self.detector = StragglerDetector()
        self.check_replicas = check_replicas
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

    def init_or_restore(self, seed: int = 0) -> str:
        """Fresh state from `seed` (under ZeRO, this rank's shards of it)."""
        self.state = self.bundle.init_state(seed)
        return "initialized"

    def _place_batch(self, batch_np) -> dict:
        """This rank's rows of the global batch: with D data ranks, rank
        (p, d) takes rows [(p*D + d)*lb, (p*D + d + 1)*lb), lb = gb/(P*D),
        as the reference's ``P(("pod", "data"))`` sharding gives them."""
        toks = batch_np["tokens"] if isinstance(batch_np, dict) else batch_np
        m = self.mesh
        n = m.pod * m.data
        if toks.shape[0] % n:
            raise ValueError(f"global batch {toks.shape[0]} does not split over "
                             f"{m.pod} pods x {m.data} data ranks")
        lb = toks.shape[0] // n
        r = m.pod_index * m.data + m.data_index
        rows = np.ascontiguousarray(toks[r * lb:(r + 1) * lb])
        return {"tokens": torch.as_tensor(rows, dtype=torch.int64,
                                          device=self.bundle.device)}

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
        while self.step < target:
            batch = self._place_batch(next(data_iter))
            ran = self.bundle
            t0 = time.perf_counter()
            self.state, metrics = ran.fn(self.state, batch)
            loss = float(metrics["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            fresh, self._fresh = self._fresh, False
            if fresh:
                straggler = False
            else:
                straggler = self.detector.observe(self.step, dt)
                if self.rc.comm.mode != "flat":   # flat: path carries nothing
                    get_telemetry().record(ran.path.key, dt, step=self.step)
            tuner_s = None
            if self.tuner is not None:
                tuner_s = self._slowest(dt)
                new_cfg = self.tuner.observe(tuner_s)
                if new_cfg is not None:
                    self._retune(new_cfg, log)
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
                   "tuner_s": tuner_s}
            if self.check_replicas:
                rec["checksum"] = self._replicas_agree()
            self.history.append(rec)
            if log_every and self.step % log_every == 0:
                log(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
                    f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms"
                    + (" [straggler]" if straggler else ""))
            self.step += 1
        return self.history

    def _slowest(self, dt: float) -> float:
        """The largest step time over every rank (`dt` with one rank): what
        the reference's one process measures, and the same on every rank."""
        group = self.mesh.world_group
        if group is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t)

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
            self._bundles[key] = build_train_step(self.rc, self.mesh,
                                                  site_groups=self.site_groups)
            self._fresh = True
        self.bundle = self._bundles[key]
        if self.bundle.replan is not None:
            # a cached bundle noted its plan when it was built: re-note it,
            # or the telemetry would describe the last-built config
            self.bundle.replan()
        get_telemetry().path(self.bundle.path.key).note_retune(self.step, cfg)
        log(f"[autotune] step {self.step}: trying streams={cfg['streams']} "
            f"chunk={cfg['chunk_mb']}MiB pacing={cfg['pacing']}"
            + (f" algo={cfg['algo']}" if "algo" in cfg else "")
            + (f" bucket={cfg['bucket_mb']}MiB" if "bucket_mb" in cfg else ""))

    def close(self) -> None:
        """Nothing to flush: no checkpoint manager is ported yet."""


def _knobs(path) -> dict:
    """The tuner's knobs of a path."""
    return {"streams": path.streams, "chunk_mb": path.comm.chunk_mb,
            "pacing": path.comm.pacing, "algo": path.comm.algo,
            "bucket_mb": path.comm.bucket_mb}
