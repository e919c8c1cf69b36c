#!/usr/bin/env python3
"""Peak device memory a rank of the families' 2-pod training step takes, at
two depths a family, and the deepest depth whose two ranks stay within a
budget of the card.

    python3 tools/train_family_memory.py [--archs a,b]
    python3 tools/train_family_memory.py --stages --archs phi3.5-moe-42b-a6.6b
    python3 tools/train_family_memory.py --model 2 --archs phi3.5-moe-42b-a6.6b

Card only.  For each arch of ``chip_smoke.FAMILY_TRAIN_RUNS`` (its first
run: no codec, the run's tokens a pod), one spawn of 2 ranks sharing the
card runs ``chip_smoke._family_train_rank`` at the two depths of
PROBE_DEPTHS (one step each from seed-0 weights, published widths), the
first depth's memory given back before the second.  A depth that runs out of
device memory ends the family's spawn and is reported as such.  For the
audio family a depth is encoder and decoder layers alike.  From the two
peaks, peak(L) = a + b * L; the line of a family gives the peaks per rank,
a, b, and the deepest L up to the published depth with 2 * peak(L) within
the budgets of 72 and 76 GB.  Prints one JSON line a family; what
``chip_smoke.py``'s families_train phase runs at is set from these lines
(PERF.md section 4).  ``--stages`` runs each family at its first probe
depth only and records, on every rank, the peak and the live device memory
before and after the step's gradient sync and its AdamW update (the first
peak is the forward's and backward's).  ``--model 2`` probes the tp
phase's training step instead (``chip_smoke._tp_train``: 1 pod x 1 data
rank x 2 model ranks, one 4096-token sequence, tensor and expert
parallelism) at the same two depths, one step each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# two depths a family, small enough that the first fits two ranks
PROBE_DEPTHS = {"mamba2-780m": (12, 24), "zamba2-1.2b": (12, 24),
                "phi3.5-moe-42b-a6.6b": (1, 2), "whisper-medium": (6, 12),
                "pixtral-12b": (1, 2)}


def _stage_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """chip_smoke's family rank with the step's sync and AdamW wrapped to
    record the device memory around them; writes them beside its report."""
    import torch
    import chip_smoke as cs
    from repro_torch.runtime import step as step_mod
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    seen = []

    def wrap(name):
        fn = getattr(step_mod, name)

        def wrapped(*a, **k):
            seen.append([f"{name}:before", torch.cuda.max_memory_allocated(dev) / 1e9,
                         torch.cuda.memory_allocated(dev) / 1e9])
            res = fn(*a, **k)
            seen.append([f"{name}:after", torch.cuda.max_memory_allocated(dev) / 1e9,
                         torch.cuda.memory_allocated(dev) / 1e9])
            return res
        setattr(step_mod, name, wrapped)
    for name in ("wide_allreduce", "streamed_psum", "adamw_update"):
        wrap(name)
    cs._family_train_rank(rank, init, out, spec)
    with open(os.path.join(out, f"{spec['label']}.stages.rank{rank}.json"), "w") as f:
        json.dump(seen, f)


def stages(torch, cs, arch: str, out_dir: str) -> dict:
    """The memory around the sync and AdamW of one step at the first probe
    depth, both ranks (GB: peak so far, live)."""
    from repro_torch.configs import get_config
    row = next(r for r in cs.FAMILY_TRAIN_RUNS if r[1] == arch)
    depth = PROBE_DEPTHS[arch][0]
    enc = depth if get_config(arch).encoder_layers else None
    run = dict(cs._family_run(row), name=f"{arch}@{depth}", steps=1, layers=depth,
               encoder_layers=enc)
    label = "stages_" + arch.replace(".", "_")
    with cs.expandable_segments():
        cs._spawn(torch, _stage_rank, 2, out_dir,
                  dict(cs.FAMILY_TRAIN_SPEC, data=1, runs=[run], label=label,
                       launcher=[]), label)
    return {"arch": arch, "layers": depth, "stages_gb_by_rank": [
        json.load(open(os.path.join(out_dir, f"{label}.stages.rank{r}.json")))
        for r in range(2)]}


def probe(torch, cs, arch: str, out_dir: str) -> dict:
    from repro_torch.configs import get_config
    row = next(r for r in cs.FAMILY_TRAIN_RUNS if r[1] == arch)
    cfg = get_config(arch)
    runs = []
    for depth in PROBE_DEPTHS[arch]:
        run = dict(cs._family_run(row), name=f"{arch}@{depth}", steps=1,
                   layers=depth, encoder_layers=depth if cfg.encoder_layers else None)
        runs.append(run)
    label = "probe_" + arch.replace(".", "_")
    t0 = time.perf_counter()
    failed = None
    try:
        cs._spawn_family_train(torch, out_dir, runs, 1, label, [])
    except Exception as e:          # a depth out of device memory ends the spawn
        failed = f"{type(e).__name__}: {str(e)[-400:]}"
    reps = []
    for r in range(2):
        path = os.path.join(out_dir, f"{label}.rank{r}.json")
        reps.append(json.load(open(path)) if os.path.exists(path) else {"runs": {}})
    peaks = {}
    for run in runs:
        got = [rep["runs"].get(run["name"]) for rep in reps]
        if all(got):
            peaks[run["layers"]] = [g["peak_mem_bytes"] / 1e9 for g in got]
    line = {"arch": arch, "published_layers": cfg.num_layers,
            "published_encoder_layers": cfg.encoder_layers,
            "seq_len": row[4], "global_batch": row[5],
            "peak_gb_by_depth": {str(k): v for k, v in peaks.items()},
            "failed": failed, "seconds": time.perf_counter() - t0}
    if len(peaks) == 2:
        (l1, p1), (l2, p2) = sorted((k, max(v)) for k, v in peaks.items())
        b = (p2 - p1) / (l2 - l1)
        a = p1 - b * l1
        line.update(a_gb=a, b_gb_per_layer=b)
        line["deepest_within_budget"] = {
            str(budget): min(cfg.num_layers, int((budget / 2 - a) // b)) if b > 0 else None
            for budget in (72.0, 76.0)}
    return line


def _tp_probe_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One rank of 1 x 1 x 2: ``chip_smoke._tp_train`` of one step at each
    depth of ``spec["depths"]``, the first depth's memory given back before
    the next; writes {depth: peak GB}."""
    import datetime
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_local_mesh
    timeout = datetime.timedelta(seconds=spec["gloo_timeout_s"])
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=timeout)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        mesh = make_local_mesh(model=2, device=dev, timeout=timeout)
        cs.TP_TRAIN_STEPS = 1
        peaks = {}
        for depth in spec["depths"]:
            cs.TP_TRAIN = (spec["arch"], depth, cs.TP_TRAIN[2])
            peaks[str(depth)] = cs._tp_train(torch, dist, dev, mesh)["peak_gb"]
        with open(os.path.join(out, f"{spec['label']}.rank{rank}.json"), "w") as f:
            json.dump(peaks, f)
    finally:
        dist.destroy_process_group()


def probe_tp(torch, cs, arch: str, out_dir: str) -> dict:
    """Peak GB a rank of the tp phase's training step at the two depths of
    PROBE_DEPTHS, and the deepest depth two ranks fit the budgets."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    depths = PROBE_DEPTHS[arch]
    label = "tp_probe_" + arch.replace(".", "_")
    t0 = time.perf_counter()
    with cs.expandable_segments():
        reps = cs._spawn(torch, _tp_probe_rank, 2, out_dir,
                         dict(cs.TP_SPEC, arch=arch, depths=list(depths), label=label),
                         label)
    peaks = {d: max(r[str(d)] for r in reps) for d in depths}
    (l1, p1), (l2, p2) = sorted(peaks.items())
    b = (p2 - p1) / (l2 - l1)
    a = p1 - b * l1
    return {"arch": arch, "mesh": "1x1x2", "seq_len": cs.TP_TRAIN[2],
            "peak_gb_by_depth": {str(d): [r[str(d)] for r in reps] for d in depths},
            "a_gb": a, "b_gb_per_layer": b,
            "deepest_within_budget": {
                str(budget): min(cfg.num_layers, int((budget / 2 - a) // b))
                if b > 0 else None for budget in (72.0, 76.0)},
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(PROBE_DEPTHS))
    ap.add_argument("--stages", action="store_true",
                    help="memory around the sync and AdamW at the first depth")
    ap.add_argument("--model", type=int, default=1, choices=(1, 2),
                    help="2: the tp phase's step on 1 x 1 x 2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_family_memory: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(cs.nvidia_smi(), flush=True)
    with tempfile.TemporaryDirectory(prefix="train_family_memory_") as d:
        for arch in args.archs.split(","):
            fn = stages if args.stages else probe_tp if args.model == 2 else probe
            print(json.dumps(fn(torch, cs, arch, d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
