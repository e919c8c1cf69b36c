"""Serving launcher: fixed-batch greedy decode, or the continuous-batching
serving tier (monolithic or disaggregated prefill/decode over a WAN path).

  python -m repro_torch.launch.serve --arch llama3.2-3b --engine disagg \
      --compress int8 --requests 16 --batch 8 --cache-len 2048
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
      --device cpu --engine mono --requests 4
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
      --device cpu --engine disagg --requests 8 --chaos-drop 2 40
  python -m repro_torch.launch.serve --arch mamba2-780m --batch 8 \
      --cache-len 4096 --tokens 64
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --smoke \
      --device cpu --engine disagg --compress int8 --requests 4
  python -m repro_torch.launch.serve --arch whisper-medium --smoke \
      --device cpu --tokens 8

Runs on the CUDA card unless ``--device cpu``.  The ``ssm`` and ``hybrid``
families (mamba2-780m, zamba2-1.2b) serve on ``--engine fixed`` only: the
serving tier ships and lands KV caches, and their decode state is not one
(ROADMAP.md §C 16).  So do whisper-medium (``audio``: the engine is
decoder-only, as the JAX package's) and pixtral-12b (``vlm``: its prefill
takes patch embeddings, ROADMAP.md §C 18); ``--engine fixed`` decodes them
against a zero cache, as the JAX launcher does.  ``--chaos-drop START STOP``
(disagg only) serves on the CosmoGrid topology with its backup link and
drops the amsterdam -> tokyo light path for engine steps [START, STOP): the
KV ships reship and reroute, and the incident timeline prints at the end.
The JAX launcher's ``--production-mesh`` and ``--multi-pod`` have no
counterpart (the port runs on one device).
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
    route = topo = log = None
    if args.engine == "disagg":
        comm = CommConfig(streams=args.streams, compress=args.compress)
        if args.chaos_drop is not None:
            # CosmoGrid testbed with the backup detour; the primary
            # amsterdam->tokyo light path drops for the scheduled window
            from repro_torch.core.chaos import IncidentLog
            from repro_torch.core.topology import Fault, cosmogrid_topology
            topo = cosmogrid_topology(backup_links=True)
            start, stop = args.chaos_drop
            prof = topo.link("amsterdam", "tokyo").with_fault(
                Fault("drop", start=start, stop=stop))
            topo.connect("amsterdam", "tokyo", prof)
            route = topo.route("amsterdam", "tokyo")
            log = IncidentLog()
            path = WidePath(axis="pod", comm=comm, hops=route.as_hops(),
                            name="kvship")
        else:
            path = WidePath(axis="pod", comm=comm, link=WAN_LONDON_POZNAN,
                            name="kvship")
    eng = ServingEngine(rc, mode=args.engine, path=path, seed=args.seed,
                        route=route, topo=topo, log=log, ship_timeout_s=0.5,
                        deadline_steps=args.deadline_steps,
                        prefill_site="amsterdam" if topo else None,
                        decode_site="tokyo" if topo else None,
                        device=args.device)
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
    if args.deadline_steps or args.chaos_drop is not None:
        print(f"[serve] slo: attainment={stats['slo_attainment']:.3f} "
              f"timed_out={stats['timed_out']} shed={stats['shed']} "
              f"reships={stats['reships']} reroutes={stats['reroutes']} "
              f"degraded={stats['degraded']}")
    if log is not None:
        for row in log.timeline():
            print(f"[serve] incident: step={row['step']} "
                  f"{row['event']} {row['subject']} {row['detail']}")


def main(argv=None):
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
                    help="disagg only: run on the CosmoGrid testbed and "
                         "drop the amsterdam->tokyo light path for steps "
                         "[START, STOP) — ships reship/reroute and the "
                         "incident timeline prints at the end")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

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
        if cfg.family in ("ssm", "hybrid", "audio", "vlm"):
            raise SystemExit(f"--engine {args.engine} serves decoder-only "
                             f"KV-cache models on token prompts; {cfg.name} "
                             f"is of the {cfg.family!r} family: use --engine "
                             f"fixed")
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
