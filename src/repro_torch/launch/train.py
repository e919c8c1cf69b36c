"""Training launcher: data-parallel training across pods over the WidePath.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --pods 2 \
      --shape train_4k --global-batch 2 --steps 3 --compress int8
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 2 \
      --device cpu --steps 2
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 2 \
      --ranks 4 --device cpu --steps 2
  python -m repro_torch.launch.train --arch mamba2-780m --smoke --pods 2 \
      --device cpu --steps 2
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 3 \
      --global-batch 6 --device cpu --steps 2
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 4 \
      --device cpu --steps 4 --route tokyo:espoo --compress int8 \
      --ckpt-dir /tmp/ckpt --replica-dir /tmp/replica --ckpt-every 2
  # WAN-routed with chaos: drop the direct link at step 4, self-heal
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 4 \
      --device cpu --steps 8 --route amsterdam:tokyo --backup-links --chaos-drop 4
  # local SGD every 4 steps with elastic membership coordinated by amsterdam
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 4 \
      --device cpu --steps 8 --route amsterdam:espoo --local-steps 4 \
      --coordinator amsterdam --lease-steps 2

Runs on the CUDA card unless ``--device cpu``.  ``--ranks N`` (default
``--pods``) stands for the JAX launcher's device count: the mesh is ``pods``
x ``N // pods`` data ranks, each rank one process of a ``torch.distributed``
gloo group (see ``launch/mesh.py``).  With data > 1 and the hierarchical mode
the step is ZeRO-3 (``TrainConfig.zero1``, on by default).  With ``RANK`` and
``WORLD_SIZE`` in the environment (a launcher such as torchrun) this process
is one rank; without them the launcher spawns N ranks, rank r on
``cuda:{r % device_count}``, so several ranks may share one card.  The
trainer reads the global batch and gives each rank its rows.

As the JAX launcher, the CLI has no flag for ``CommConfig.algo`` or
``bucket_mb``: :func:`main` and :func:`train` take a ``comm`` keyword, a
:class:`CommConfig` that every rank runs with in place of the one the
``--mode``/``--streams``/``--chunk-mb``/``--compress`` flags build.
:func:`main_runs` runs several such launches, one after the other, in one
spawn of the ranks (a new mesh and Trainer each), which saves starting the
ranks again for each.

``--layers N`` keeps the model's first N layers at its published widths
(the port's own flag: a run cut to fit a card's memory or a time budget).
``--model M`` (the port's own flag too) gives the mesh a model axis of M
ranks, ``pods`` x ``ranks // (pods * M)`` x M: tensor and expert
parallelism for the dense and moe families, every model rank of a (pod,
data) coordinate on the same rows; ``--route``, ``--ckpt-dir`` and the
other features that ROADMAP.md keeps queued on a model axis stop the run
naming their item.

``--ckpt-dir`` (with ``--ckpt-every``) checkpoints the run, rank 0 writing,
and a restart with the same directory restores the newest checkpoint;
``--replica-dir`` mirrors the checkpoints there.  ``--route SRC:DST`` plans
a route on the 4-site CosmoGrid topology (``core/topology.py``
``cosmogrid_topology``, one pod a site, so ``--pods 4``): the gradient sync
runs over it as a multi-hop path with the topology's site groups, and the
replicas travel it with mpw-cp, as the JAX launcher does.  With a route,
``--backup-links`` adds the tokyo-edinburgh backup link, ``--chaos-drop
STEP`` drops the route's direct link at STEP and attaches the self-healing
``ChaosMonitor`` (reroute, or failover to the replica), ``--coordinator
SITE`` attaches elastic membership (``SiteMembership`` with
``--lease-steps``) coordinated from SITE; ``--local-steps K`` is local SGD,
K site-local steps between cross-site delta syncs.  Every rank builds its
own topology, monitor and membership from the same flags.  ``--arch``
takes the dense, moe, ssm and hybrid families; it refuses the audio and vlm
families, whose batches need stub inputs that the token pipeline does not
make (the JAX launcher fails on them when it places the batch): train those
with :class:`repro_torch.runtime.Trainer` on dict batches.  The JAX
launcher's ``--production-mesh`` and ``--multi-pod`` are not ported yet and
stop the launcher naming their ROADMAP item.  ``--check-replicas`` compares
every pod's parameters after every step, ``--report`` writes each rank's
run as JSON (history, kernel launches, the sync plan, peak device memory,
the incident timeline), ``--profile-step`` runs one step of rank 0 under
``torch.profiler``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.core.chaos import ChaosMonitor, get_incident_log
from repro_torch.core.collectives import TP_ITEM
from repro_torch.core.membership import SiteMembership
from repro_torch.core.telemetry import get_telemetry
from repro_torch.core.topology import cosmogrid_topology
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BACKEND, make_local_mesh
from repro_torch.runtime import Trainer

# JAX launcher flags that this slice does not run, with their ROADMAP item
QUEUED_FLAGS = {
    "production_mesh": TP_ITEM,
    "multi_pod": TP_ITEM,
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", default="hierarchical",
                    choices=["flat", "hierarchical", "gateway"])
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--chunk-mb", type=float, default=8.0)
    ap.add_argument("--compress", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model + small shapes")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the model's first N layers, its widths as they "
                         "are (not a flag of the JAX launcher)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (the WAN axis of the mesh)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks in all, one process each (default --pods "
                         "x --model); data ranks per pod = ranks // (pods x model)")
    ap.add_argument("--model", type=int, default=1,
                    help="model ranks (tensor parallelism) per (pod, data) "
                         "coordinate (not a flag of the JAX launcher)")
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "binary"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device type; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--check-replicas", action="store_true",
                    help="after every step, fail unless the replicas' parameters "
                         "(under ZeRO: each data index's shards) are bit-identical")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write rank r's run as JSON to PATH.rank{r}.json")
    ap.add_argument("--profile-step", type=int, default=None, metavar="K",
                    help="run step K of rank 0 under torch.profiler (in the report)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--replica-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--route", default=None, metavar="SRC:DST",
                    help="route the sync (and the replicas) over the CosmoGrid "
                         "topology from SRC to DST; needs --pods 4")
    ap.add_argument("--backup-links", action="store_true",
                    help="add the tokyo-edinburgh backup to the topology")
    ap.add_argument("--chaos-drop", type=int, default=None, metavar="STEP",
                    help="drop the route's direct link at STEP and attach "
                         "the self-healing ChaosMonitor (reroute/failover)")
    ap.add_argument("--local-steps", type=int, default=1, metavar="K",
                    help="local-SGD cadence: K local steps per site between "
                         "cross-site delta syncs (1 = fully synchronous)")
    ap.add_argument("--coordinator", default=None, metavar="SITE",
                    help="attach elastic membership (lease-based liveness, "
                         "evict/rejoin world resize) coordinated from SITE; "
                         "needs --route")
    ap.add_argument("--lease-steps", type=int, default=4,
                    help="probe failures a suspect site survives before "
                         "eviction (with --coordinator)")
    # the JAX launcher's flags that wait for a later slice
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    return ap


# families whose batches carry stub inputs beside the tokens: the token
# pipeline has none, and the JAX launcher cannot place them (ROADMAP.md
# section C 19); the Trainer trains them from dict batches
STUB_INPUT_FAMILIES = ("audio", "vlm")


def _check_flags(args) -> None:
    cfg = get_config(args.arch)
    family = cfg.family
    if family in STUB_INPUT_FAMILIES:
        raise SystemExit(f"--arch {args.arch}: the {family} family's batches "
                         f"need stub inputs beside the tokens, which the token "
                         f"pipeline does not make (ROADMAP.md section C 19); "
                         f"train it with runtime.Trainer on dict batches")
    if args.layers is not None and not 1 <= args.layers <= cfg.num_layers:
        raise SystemExit(f"--layers {args.layers}: {args.arch} has "
                         f"{cfg.num_layers} layers")
    if args.ranks is None:
        args.ranks = args.pods * args.model
    if (args.pods < 1 or args.model < 1 or args.ranks < 1
            or args.ranks % (args.pods * args.model)):
        raise SystemExit(f"--ranks {args.ranks} does not split into "
                         f"--pods {args.pods} equal pods of --model "
                         f"{args.model} ranks")
    for flag, item in QUEUED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to PyTorch "
                             f"yet (ROADMAP.md queue A, {item!r})")
    if args.route is not None:
        ends = args.route.split(":")
        if len(ends) != 2 or not all(ends):
            raise SystemExit(f"--route {args.route!r} is not SRC:DST")
        if args.pods != 4:
            raise SystemExit(f"--route runs on the 4-site CosmoGrid topology, "
                             f"one pod a site: it needs --pods 4, got "
                             f"--pods {args.pods}")
        topo = cosmogrid_topology(backup_links=args.backup_links)
        if args.chaos_drop is not None and topo.link(*ends) is None:
            raise SystemExit(f"--chaos-drop needs a direct {ends[0]}-{ends[1]} link")
        if args.coordinator is not None and args.coordinator not in [
                s.name for s in topo.sites]:
            raise SystemExit(f"--coordinator {args.coordinator!r} is not a site "
                             f"of the topology")
    elif args.coordinator is not None:
        raise SystemExit("--coordinator needs --route (a multi-site topology)")
    if args.local_steps < 1:
        raise SystemExit(f"--local-steps must be >= 1, got {args.local_steps}")
    if args.profile_step is not None and not 0 <= args.profile_step < args.steps:
        raise SystemExit(f"--profile-step {args.profile_step} is not a step of "
                         f"0 .. {args.steps - 1}")


def profile_summary(prof, wall_s: float) -> dict:
    """Device busy seconds (kernels and copies), the device's idle share of
    `wall_s`, and every device op with its seconds and count, the most time
    first, from a ``torch.profiler`` run.  Only this process's work is
    traced: ranks that share the card add device time the trace does not
    see."""
    dev_ops = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):   # host ops: not device time
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        if us and us > 0:
            dev_ops[e.key] = (us / 1e6, e.count)
    busy = sum(s for s, _ in dev_ops.values())
    return {"wall_s": wall_s, "device_busy_s": busy,
            "device_idle_share": (1 - busy / wall_s) if dev_ops and wall_s > 0 else None,
            "device_launches": sum(c for _, c in dev_ops.values()),
            "device_ops": [[k[:100], s, c] for k, (s, c) in sorted(
                dev_ops.items(), key=lambda kv: -kv[1][0])]}


def train(args, rank: int = 0, comm: Optional[CommConfig] = None) -> dict:
    """One rank's run; returns its report.  `comm`, when given, is the run's
    CommConfig in place of the flags'."""
    t_start = time.perf_counter()
    dev = torch.device("cpu")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: PyTorch sees no CUDA "
                             f"device; pass --device cpu for the plain versions")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    base = SHAPES[args.shape]
    seq = args.seq_len or (64 if args.smoke else base.seq_len)
    gb = args.global_batch or (8 if args.smoke else base.global_batch)
    shape = ShapeConfig(base.name, seq, gb, "train")
    mesh = make_local_mesh(pod=args.pods, data=args.ranks // (args.pods * args.model),
                           model=args.model, device=dev)
    if comm is None:
        comm = CommConfig(mode=args.mode, streams=args.streams,
                          chunk_mb=args.chunk_mb, compress=args.compress,
                          local_steps=args.local_steps)
    rc = RunConfig(
        model=cfg, shape=shape, comm=comm,
        train=TrainConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1),
                          microbatches=args.microbatches))
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=gb, kind=args.data,
                                    path=args.data_path))
    say = print if rank == 0 else (lambda *_: None)
    route = site_groups = chaos = membership = None
    if args.route:
        src, dst = args.route.split(":")
        topo = cosmogrid_topology(backup_links=args.backup_links)
        if args.chaos_drop is not None:
            topo.connect(src, dst, topo.link(src, dst).drop(args.chaos_drop))
            chaos = ChaosMonitor(topo, src, dst)
        if args.coordinator:
            membership = SiteMembership(topo, args.coordinator,
                                        lease_steps=args.lease_steps)
        route = topo.route(src, dst)
        site_groups = topo.pod_groups()
        say(f"[train] WAN route: {route.describe()}"
            + (f"; chaos drop at step {args.chaos_drop}"
               if args.chaos_drop is not None else "")
            + (f"; membership coordinated by {args.coordinator}"
               if args.coordinator else ""))
    trainer = Trainer(rc, mesh, ckpt_dir=args.ckpt_dir,
                      replica_dir=args.replica_dir, ckpt_every=args.ckpt_every,
                      route=route, site_groups=site_groups, chaos=chaos,
                      membership=membership, check_replicas=args.check_replicas)
    path = trainer.bundle.path
    plan_b = trainer.bundle.bucket_plan
    say(f"[train] {args.arch} params={cfg.param_count():,} mesh={mesh.shape} "
        f"mode={comm.mode} zero={trainer.bundle.zero} compress={comm.compress} "
        f"algo={comm.algo} streams={path.streams} "
        f"chunk={path.comm.chunk_mb}MiB "
        f"buckets={0 if plan_b is None else len(plan_b.buckets)} device={dev}"
        + (f" local_steps={comm.local_steps}" if comm.local_steps > 1 else ""))
    say(f"[train] {trainer.init_or_restore()} at step {trainer.step}")
    ops.reset_launch_counts()
    prof_out = None
    k = args.profile_step if rank == 0 else None
    if k is None:
        trainer.run(data, args.steps, log=say)
    else:
        from torch.profiler import ProfilerActivity, profile
        trainer.run(data, k, log=say)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            trainer.run(data, 1, log=say)
            wall = time.perf_counter() - t0
        prof_out = {"step": k, **profile_summary(prof, wall)}
        trainer.run(data, args.steps - k - 1, log=say)
    launches = ops.launch_counts()
    hist = trainer.history
    say(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
        f"stragglers flagged: {len(trainer.detector.flagged)}")
    tel = get_telemetry()
    plan = tel.path(path.key).plan
    bucket_plans = [] if plan_b is None else [
        tel.path(f"{path.key}/bkt{b.index}").plan.__dict__ for b in plan_b.buckets]
    report = {"rank": rank, "pods": args.pods, "ranks": args.ranks,
              "data": mesh.data, "pod_index": mesh.pod_index,
              "data_index": mesh.data_index, "model": mesh.model,
              "model_index": mesh.model_index, "zero": trainer.bundle.zero,
              "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "arch": cfg.name, "params": cfg.param_count(), "layers": cfg.num_layers,
              "seq_len": seq, "global_batch": gb, "mode": comm.mode,
              "compress": comm.compress, "algo": comm.algo,
              "bucket_mb": comm.bucket_mb, "streams": path.streams,
              "chunk_mb": path.comm.chunk_mb,
              "plan": None if plan is None else plan.__dict__,
              "route": None if route is None else route.describe(),
              "final_route": (None if trainer.route is None
                              else list(trainer.route.sites)),
              "incidents": get_incident_log().timeline(),
              "hop_plans": {k: tel.path(k).plan.__dict__ for k in path.hop_keys()
                            if path.hops and tel.path(k).plan is not None},
              "bucket_plans": bucket_plans,
              "history": hist, "launches": launches, "profile": prof_out,
              "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)}
    if hasattr(data, "close"):
        data.close()
    trainer.close()
    report["run_s"] = time.perf_counter() - t_start
    if args.report:
        with open(f"{args.report}.rank{rank}.json", "w") as f:
            json.dump(report, f)
    return report


def parse_runs(runs: list) -> list:
    """(args, comm) of each ``(argv, comm)`` of `runs`, as :func:`main` takes
    them, the flags checked; the runs must name the same ``--ranks`` and
    ``--device``."""
    parsed = []
    for argv, comm in runs:
        args = parser().parse_args(argv)
        _check_flags(args)
        parsed.append((args, comm))
    first = parsed[0][0]
    for args, _ in parsed[1:]:
        if (args.ranks, args.device) != (first.ranks, first.device):
            raise SystemExit(f"main_runs: every run needs --ranks {first.ranks} "
                             f"and --device {first.device}, got --ranks "
                             f"{args.ranks} --device {args.device}")
    return parsed


def train_runs(parsed: list, rank: int) -> None:
    """Rank `rank`'s part of `parsed` (:func:`parse_runs`) in a process that
    has joined the world's process group: each run in turn, the last run's
    memory given back before the next one starts."""
    for i, (args, comm) in enumerate(parsed):
        if i:
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        train(args, rank, comm)


def _worker(rank: int, runs: list, init_method: str) -> None:
    """Rank `rank` of a spawn: :func:`train_runs` of `runs`."""
    dist.init_process_group(BACKEND, init_method=init_method, rank=rank,
                            world_size=runs[0][0].ranks)
    try:
        train_runs(runs, rank)
    finally:
        dist.destroy_process_group()


def main_runs(runs: list) -> None:
    """Launches `runs`, each ``(argv, comm)`` as :func:`main` takes them, one
    after the other in one spawn of ranks: every rank runs each in turn
    (:func:`train_runs`).  The runs must name the same ``--ranks`` and
    ``--device``; each writes its own ``--report``."""
    parsed = parse_runs(runs)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        raise SystemExit("main_runs spawns its ranks: run it without RANK "
                         "and WORLD_SIZE")
    if parsed[0][0].ranks == 1:
        train_runs(parsed, 0)
        return
    rdv = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(parsed, f"file://{os.path.join(rdv, 'rendezvous')}"),
            nprocs=parsed[0][0].ranks, join=True, start_method="spawn")
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


def main(argv=None, *, comm: Optional[CommConfig] = None) -> None:
    """The launcher; `comm` (see the module docstring) goes to every rank."""
    args = parser().parse_args(argv)
    _check_flags(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKEND, init_method="env://")
        if dist.get_world_size() != args.ranks:
            raise SystemExit(f"WORLD_SIZE={dist.get_world_size()} but "
                             f"--ranks {args.ranks}")
        try:
            train(args, dist.get_rank(), comm)
        finally:
            dist.destroy_process_group()
        return
    main_runs([(argv, comm)])


if __name__ == "__main__":
    main()
