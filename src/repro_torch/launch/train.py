"""Training launcher: data-parallel training across pods over the WidePath.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --pods 2 \
      --shape train_4k --global-batch 2 --steps 3 --compress int8
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --pods 2 \
      --device cpu --steps 2

Runs on the CUDA card unless ``--device cpu``.  Each pod is one rank of a
``torch.distributed`` gloo group (see ``launch/mesh.py``).  With ``RANK`` and
``WORLD_SIZE`` in the environment (a launcher such as torchrun) this process
is one rank; without them ``--pods N`` spawns N ranks, rank r on
``cuda:{r % device_count}``, so several pods may share one card.  The
trainer reads the global batch and gives pod r its rows.

The JAX launcher's checkpoint, production-mesh, route, chaos, local-SGD and
membership flags are not ported yet and stop the launcher naming their
ROADMAP item.  ``--check-replicas`` compares every pod's parameters after
every step, ``--report`` writes each rank's run as JSON (history, kernel
launches, the sync plan, peak device memory), ``--profile-step`` runs one
step of rank 0 under ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.core.telemetry import get_telemetry
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BACKEND, make_local_mesh
from repro_torch.runtime import Trainer

# JAX launcher flags that this slice does not run, with their ROADMAP item
QUEUED_FLAGS = {
    "ckpt_dir": "facade, relays, files, checkpoints",
    "replica_dir": "facade, relays, files, checkpoints",
    "production_mesh": "data > 1 with ZeRO and reduce-scatter",
    "multi_pod": "data > 1 with ZeRO and reduce-scatter",
    "route": "facade, relays, files, checkpoints",
    "backup_links": "topology, chaos and elasticity",
    "chaos_drop": "topology, chaos and elasticity",
    "coordinator": "topology, chaos and elasticity",
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
    ap.add_argument("--pods", type=int, default=1,
                    help="pod ranks (one gloo rank each)")
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "binary"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device type; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--check-replicas", action="store_true",
                    help="after every step, fail unless every pod's parameters "
                         "are bit-identical")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write rank r's run as JSON to PATH.rank{r}.json")
    ap.add_argument("--profile-step", type=int, default=None, metavar="K",
                    help="run step K of rank 0 under torch.profiler (in the report)")
    # the JAX launcher's flags that wait for later slices
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--replica-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--route", default=None)
    ap.add_argument("--backup-links", action="store_true")
    ap.add_argument("--chaos-drop", type=int, default=None)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--coordinator", default=None)
    return ap


def _check_flags(args) -> None:
    for flag, item in QUEUED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to PyTorch "
                             f"yet (ROADMAP.md queue A, {item!r})")
    if args.local_steps != 1:
        raise SystemExit("--local-steps > 1 (local SGD) is not ported to PyTorch "
                         "yet (ROADMAP.md queue A, 'topology, chaos and elasticity')")
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


def train(args, rank: int = 0) -> dict:
    """One rank's run; returns its report."""
    dev = torch.device("cpu")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: PyTorch sees no CUDA "
                             f"device; pass --device cpu for the plain versions")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    base = SHAPES[args.shape]
    seq = args.seq_len or (64 if args.smoke else base.seq_len)
    gb = args.global_batch or (8 if args.smoke else base.global_batch)
    shape = ShapeConfig(base.name, seq, gb, "train")
    mesh = make_local_mesh(pod=args.pods, device=dev)
    rc = RunConfig(
        model=cfg, shape=shape,
        comm=CommConfig(mode=args.mode, streams=args.streams,
                        chunk_mb=args.chunk_mb, compress=args.compress),
        train=TrainConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1),
                          microbatches=args.microbatches))
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=gb, kind=args.data,
                                    path=args.data_path))
    say = print if rank == 0 else (lambda *_: None)
    trainer = Trainer(rc, mesh, check_replicas=args.check_replicas)
    path = trainer.bundle.path
    say(f"[train] {args.arch} params={cfg.param_count():,} mesh={mesh.shape} "
        f"mode={args.mode} compress={args.compress} streams={path.streams} "
        f"chunk={path.comm.chunk_mb}MiB device={dev}")
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
    plan = get_telemetry().path(path.key).plan
    report = {"rank": rank, "pods": args.pods, "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "arch": cfg.name, "params": cfg.param_count(),
              "seq_len": seq, "global_batch": gb, "mode": args.mode,
              "compress": args.compress, "streams": path.streams,
              "chunk_mb": path.comm.chunk_mb,
              "plan": None if plan is None else plan.__dict__,
              "history": hist, "launches": launches, "profile": prof_out,
              "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)}
    if hasattr(data, "close"):
        data.close()
    trainer.close()
    if args.report:
        with open(f"{args.report}.rank{rank}.json", "w") as f:
            json.dump(report, f)
    return report


def _worker(rank: int, args, init_method: str) -> None:
    dist.init_process_group(BACKEND, init_method=init_method, rank=rank,
                            world_size=args.pods)
    try:
        train(args, rank)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    _check_flags(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKEND, init_method="env://")
        if dist.get_world_size() != args.pods:
            raise SystemExit(f"WORLD_SIZE={dist.get_world_size()} but "
                             f"--pods {args.pods}")
        try:
            train(args, dist.get_rank())
        finally:
            dist.destroy_process_group()
        return
    if args.pods == 1:
        train(args, 0)
        return
    rdv = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(args, f"file://{os.path.join(rdv, 'rendezvous')}"),
            nprocs=args.pods, join=True, start_method="spawn")
    finally:
        shutil.rmtree(rdv, ignore_errors=True)


if __name__ == "__main__":
    main()
