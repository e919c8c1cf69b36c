#!/usr/bin/env python3
"""Where a served model's first prefill spends its time in a fresh process
on the card, against its second.

    python3 tools/first_prefill_profile.py                    # whisper-medium
    python3 tools/first_prefill_profile.py --profile
    python3 tools/first_prefill_profile.py --arch pixtral-12b --prompt 1024

Builds the kernels, draws the model's seed-0 weights and one seeded batch
(``models.batch_concrete``: 8 requests, the family's stub inputs), then runs
the prefill bundle twice; with ``--profile`` each run under
``torch.profiler`` (host and device activity, the profiler started before
the timed window).  Prints one JSON line per run: its wall ms (host clock
to a device sync) and, profiled, the ops with the most host and device
time of their own; last the card's nvidia-smi name and power limit.  Card
only: exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _top(events, key: str, top: int) -> list:
    ops = sorted(events, key=lambda e: getattr(e, key), reverse=True)
    return [{"op": e.key, "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "self_device_ms": e.self_device_time_total / 1e3} for e in ops[:top]]


def _run(torch, fn, profile: bool, top: int) -> dict:
    """One prefill's wall ms, host clock to a device sync.  With `profile`
    the profiler starts first (its own start-up and a trivial device op
    outside the timed window), and the ops with the most host time and the
    most device time of their own are listed."""
    from torch.profiler import ProfilerActivity, profile as prof
    if not profile:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return {"profiled": False, "wall_ms": 1e3 * (time.perf_counter() - t0)}
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = p.key_averages()
    return {"profiled": True, "wall_ms": wall,
            "top_self_cpu": _top(ev, "self_cpu_time_total", top),
            "top_self_device": _top(ev, "self_device_time_total", top)}


def _pieces(torch, model, params, batch) -> list:
    """The first call of each kind of op of the audio family's prefill, in
    the order the prefill reaches it, each timed alone (host clock to a
    device sync), and of ``torch.utils.checkpoint``: where a one-time cost
    lands."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    enc = layer_params(params["encoder"]["attn"], 0)
    src = batch["source_frames"]
    B, S, d = src.shape
    Dh = cfg.resolved_head_dim
    steps = [
        ("arange", lambda: torch.arange(S, device=src.device)),
        ("sinusoidal_positions", lambda: L.sinusoidal_positions(
            torch.arange(S, device=src.device), d)),
        ("rmsnorm", lambda: ops.rmsnorm(src, params["encoder"]["ln1"][0])),
        ("matmul", lambda: src @ enc["wq"]),
        ("flash_non_causal", lambda: ops.flash_attention(
            *[(src @ enc[w]).reshape(B, S, -1, Dh) for w in ("wq", "wk", "wv")],
            causal=False)),
        ("silu", lambda: torch.nn.functional.silu(src)),
        ("embed_gather", lambda: params["embed"][batch["tokens"]]),
        ("tied_head", lambda: src[:, -1:] @ params["embed"].T),
        ("checkpoint", lambda: torch.utils.checkpoint.checkpoint(
            torch.nn.functional.silu, src, use_reentrant=False)),
    ]
    out = []
    for name, f in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f()
        torch.cuda.synchronize()
        out.append({"piece": name, "first_call_ms": 1e3 * (time.perf_counter() - t0)})
    return out


def _stages(torch, model, fn) -> list:
    """One prefill with the model's stages wrapped in host-clock timers that
    end in a device sync (the layers' functions, the transformer's prefill
    helpers, ``torch.stack``): calls, summed ms and the slowest call of
    each, nested stages counted inside their callers."""
    from repro_torch.models import layers as L
    rows: dict = {}

    def timed(name, f):
        def g(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            r = rows.setdefault(name, {"stage": name, "calls": 0, "ms": 0.0, "max_ms": 0.0})
            r["calls"] += 1
            r["ms"] += ms
            r["max_ms"] = max(r["max_ms"], ms)
            return out
        return g
    saved = []
    for mod, names in ((L, ("rms_norm", "attention", "swiglu", "sinusoidal_positions",
                            "_project_qkv")),
                       (torch, ("stack",))):
        for n in names:
            saved.append((mod, n, getattr(mod, n)))
            setattr(mod, n, timed(n, getattr(mod, n)))
    for n in ("_encode", "_embed_inputs", "_cross_prefill", "_prefill_attn", "_ffn"):
        saved.append((model, n, None))
        setattr(model, n, timed(n, getattr(model, n)))
    try:
        timed("prefill", fn)()
    finally:
        for obj, n, real in saved:
            if real is None:
                delattr(obj, n)
            else:
                setattr(obj, n, real)
    return sorted(rows.values(), key=lambda r: -r["ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="whisper-medium")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--profile", action="store_true",
                    help="profile both prefills (else neither is profiled)")
    ap.add_argument("--pieces", action="store_true",
                    help="first time each kind of op of the audio family's "
                         "prefill alone, before the prefills")
    ap.add_argument("--stages", action="store_true",
                    help="time the model's stages in the first prefill")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("first_prefill_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config)
    from repro_torch.kernels import build
    from repro_torch.models import batch_concrete
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import build_serve_step
    dev = torch.device("cuda", 0)
    build.build_all()
    cfg = get_config(args.arch)
    rc = RunConfig(model=cfg, shape=ShapeConfig("serve", args.prompt, args.batch, "decode"),
                   comm=CommConfig(), train=TrainConfig())
    pre = build_serve_step(rc, "prefill", device=dev)
    params = tree_init(pre.param_defs, 0, device=dev)
    batch = batch_concrete(cfg, "prefill", args.batch, args.prompt, seed=0, device=dev)
    fn = lambda: pre.fn(params, batch)
    if args.pieces:
        with torch.inference_mode():
            for row in _pieces(torch, pre.model, params, batch):
                print(json.dumps({"arch": args.arch, **row}), flush=True)
    if args.stages:
        for row in _stages(torch, pre.model, fn):
            print(json.dumps({"arch": args.arch, **row}), flush=True)
    for i in range(2):
        print(json.dumps({"arch": args.arch, "run": i,
                          **_run(torch, fn, args.profile, args.top)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
