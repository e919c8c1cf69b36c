"""Serving launcher: fixed-batch greedy decode, or the continuous-batching
serving tier (monolithic or disaggregated prefill/decode over a WAN path).

  python -m repro_torch.launch.serve --arch llama3.2-3b --engine disagg \
      --compress int8 --requests 16 --batch 8 --cache-len 2048
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
      --device cpu --engine mono --requests 4

Runs on the CUDA card unless ``--device cpu``.  The JAX launcher's
``--production-mesh`` and ``--multi-pod`` have no counterpart (the port runs
on one device); ``--chaos-drop`` waits for the topology and chaos port
(ROADMAP.md queue A).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import (SHAPES, CommConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_config, smoke_config)
from repro_torch.core.path import WAN_LONDON_POZNAN, WidePath
from repro_torch.runtime import Server, ServingEngine


def _run_engine(rc, args) -> None:
    path = None
    if args.engine == "disagg":
        path = WidePath(axis="pod",
                        comm=CommConfig(streams=args.streams,
                                        compress=args.compress),
                        link=WAN_LONDON_POZNAN, name="kvship")
    eng = ServingEngine(rc, mode=args.engine, path=path, seed=args.seed,
                        deadline_steps=args.deadline_steps, device=args.device)
    rng = np.random.default_rng(args.seed)
    S = rc.shape.seq_len
    for _ in range(args.requests):
        plen = int(rng.integers(4, max(5, S // 4)))
        mnew = int(rng.integers(1, max(2, min(args.tokens, S - plen))))
        prompt = rng.integers(1, rc.model.vocab_size, size=plen)
        eng.submit(prompt, mnew)
    t0 = time.perf_counter()
    stats = eng.run_to_completion()
    dt = time.perf_counter() - t0
    print(f"[serve] engine={args.engine} device={eng.device} "
          f"slots={rc.shape.global_batch} completed={stats['completed']} "
          f"tokens={stats['total_tokens']} in {dt:.2f}s wall")
    print(f"[serve] modeled: p50={stats['latency_p50_s']*1e3:.1f}ms "
          f"p99={stats['latency_p99_s']*1e3:.1f}ms "
          f"ttft_p50={stats['ttft_p50_s']*1e3:.1f}ms "
          f"goodput={stats['goodput_tok_s']:.1f} tok/s")
    if args.deadline_steps:
        print(f"[serve] slo: attainment={stats['slo_attainment']:.3f} "
              f"timed_out={stats['timed_out']} shed={stats['shed']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k", choices=list(SHAPES))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--engine", choices=["fixed", "mono", "disagg"],
                    default="fixed",
                    help="fixed: one-batch decode; mono/disagg: the "
                         "continuous-batching serving tier")
    ap.add_argument("--requests", type=int, default=8,
                    help="seeded request count for --engine mono/disagg")
    ap.add_argument("--streams", type=int, default=16,
                    help="WAN streams for the disaggregated KV ship")
    ap.add_argument("--compress", choices=["none", "bf16", "int8"],
                    default="none", help="wire codec of the KV ship")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request SLO in virtual steps (requests past "
                         "it TIMEOUT; admission sheds hopeless ones)")
    ap.add_argument("--chaos-drop", type=int, nargs=2, default=None,
                    metavar=("START", "STOP"),
                    help="not ported yet: needs the topology and chaos port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args()
    if args.chaos_drop is not None:
        raise SystemExit("--chaos-drop needs the topology and chaos port, "
                         "queued in ROADMAP.md queue A")

    cfg = get_config(args.arch)
    if cfg.num_heads == 0 and cfg.family == "audio":
        raise SystemExit("decode not defined for this arch")
    if args.smoke:
        cfg = smoke_config(cfg)
    base = SHAPES[args.shape]
    B = args.batch or (4 if args.smoke else base.global_batch)
    S = args.cache_len or (128 if args.smoke else base.seq_len)
    shape = ShapeConfig(base.name, S, B, "decode")
    rc = RunConfig(model=cfg, shape=shape, comm=CommConfig(), train=TrainConfig())
    if args.engine != "fixed":
        _run_engine(rc, args)
        return
    server = Server(rc, seed=args.seed, device=args.device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, 1)).astype(np.int64)
    t0 = time.perf_counter()
    res = server.generate(prompts, max_new=args.tokens)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch} B={B} cache={S} generated {res.steps} tokens "
          f"in {dt:.2f}s ({B*res.steps/dt:.1f} tok/s)")
    print("[serve] sample:", res.tokens[0][:8].tolist())


if __name__ == "__main__":
    main()
