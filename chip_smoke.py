#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, one JSON line each; any failure raises and exits nonzero:

1. env      torch/CUDA versions and the card (nvidia-smi name, power limit);
2. build    nvcc builds the four kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  each kernel against its plain PyTorch version on the card, at the
            serving path's shapes, with times (CUDA events), the bound and a
            PyTorch library call as a yardstick where one exists;
4. small    the port on the card against the port on the CPU (plain
            versions) at smoke size: prefill and decode logits;
5. engine   full-width llama3.2-3b (random weights from seed 0) serving 16
            seeded requests with continuous batching, three ways: mono,
            disagg over the London-Poznan WAN path, and disagg with the int8
            wire codec; mono and disagg tokens must be bit-identical, every
            ship's telemetry wire bytes must equal the plan, and each kernel
            must have launched during the run (counts reset just before it);
6. profile  torch.profiler over a full-width prefill and decode step:
            device time by kernel and the device's idle share.

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12            # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_BF16 = 989e12           # dense bf16 tensor-core rate
PEAK_F32 = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 << 20
PHASES = ("env", "build", "kernels", "small", "engine", "profile")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n_sets: int, iters: int) -> float:
    """Mean device ms per call of fn(i) over `iters` calls, cycling through
    `n_sets` input sets so that repeated calls do not find them in L2.

    The device first spins for a while (`torch.cuda._sleep`), so the host
    has queued every launch before the first one starts: the events then
    time the device's work back to back, not the host's launch rate."""
    for i in range(min(n_sets, 3)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 2e5))          # ~100 us of spin per call
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sets_for(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp_err(torch, got, want) -> float:
    """Largest |got - want| in units of one bf16 ulp of `want`."""
    w = want.float()
    mag = w.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - w).abs() / ulp).max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant, ref, rmsnorm
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}

    # rmsnorm: every block's two norms and the final one; rows = prompt tokens
    # in prefill, slots in decode.  Tolerance: one bf16 ulp.
    for R in (1024, 8):
        nbytes = 2 * R * 3072 * 2 + 3072 * 2
        k = sets_for(nbytes)
        xs = [rnd(R, 3072) for _ in range(k)]
        w = rnd(3072)
        got = rmsnorm.rmsnorm_rows(xs[0], w)
        want = ref.rmsnorm_ref(xs[0], w)
        ulps = bf16_ulp_err(torch, got, want)
        check(ulps <= 1.0, f"rmsnorm ({R},3072) within one bf16 ulp, got {ulps}")
        entry = {"shape": [R, 3072], "dtype": "bfloat16",
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "max_err_bf16_ulps": ulps,
                 "ms": cuda_ms(torch, lambda i: rmsnorm.rmsnorm_rows(xs[i], w), k, 200),
                 "plain_ms": cuda_ms(torch, lambda i: ref.rmsnorm_ref(xs[i], w), k, 20),
                 "library_ms": cuda_ms(torch, lambda i: torch.nn.functional.rms_norm(
                     xs[i], (3072,), w, 1e-5), k, 50)}
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, 4 * R * 3072, PEAK_F32)
        rows.setdefault("rmsnorm", []).append(entry)

    # quant / dequant: one 8 MiB chunk of a full-width KV leaf (4 layers of a
    # 1024-token prompt), flattened to f32 as the wire codec does; then other
    # block sizes.  Tolerance: exact.
    n = 4 * 1024 * 8 * 128
    nbytes_q = 4 * n + n + 4 * (n // 256)
    nbytes_d = n + 4 * (n // 256) + 4 * n
    k = sets_for(nbytes_q)
    xs = [rnd(4, 1024, 8, 128).reshape(1, -1).float() for _ in range(k)]
    q, s = quant.quant_int8_2d(xs[0], block=256)
    qr, sr = ref.quant_int8_ref(xs[0], 256)
    check(torch.equal(q, qr) and torch.equal(s, sr), "quant 8 MiB chunk exact")
    qs = [quant.quant_int8_2d(x, block=256) for x in xs]
    y = quant.dequant_int8_2d(q, s, block=256)
    check(torch.equal(y, ref.dequant_int8_ref(q, s, 256)), "dequant 8 MiB chunk exact")
    extra = []
    for R, nn, block in ((3, 768, 256), (5, 700, 100), (2, 96, 1)):
        x = rnd(R, nn, dtype=torch.float32, scale=7.0)
        x[0, :block] = 0.0
        qb, sb = quant.quant_int8_2d(x, block=block)
        qbr, sbr = ref.quant_int8_ref(x, block)
        check(torch.equal(qb, qbr) and torch.equal(sb, sbr), f"quant block={block} exact")
        for dt in (torch.float32, torch.bfloat16):
            check(torch.equal(quant.dequant_int8_2d(qb, sb, block=block, dtype=dt),
                              ref.dequant_int8_ref(qb, sb, block, dt)),
                  f"dequant block={block} {dt} exact")
        extra.append({"shape": [R, nn], "block": block, "exact": True})
    qe = {"shape": [1, n], "block": 256, "max_abs_err": 0.0, "exact": True,
          "ms": cuda_ms(torch, lambda i: quant.quant_int8_2d(xs[i], block=256), k, 100),
          "plain_ms": cuda_ms(torch, lambda i: ref.quant_int8_ref(xs[i], 256), k, 10),
          "library_ms": None, "other_blocks": extra}
    qe["bound_ms"], qe["bound_by"] = bound(nbytes_q, 3 * n, PEAK_F32)
    de = {"shape": [1, n], "block": 256, "max_abs_err": 0.0, "exact": True,
          "ms": cuda_ms(torch, lambda i: quant.dequant_int8_2d(*qs[i], block=256), k, 100),
          "plain_ms": cuda_ms(torch, lambda i: ref.dequant_int8_ref(*qs[i], 256), k, 10),
          "library_ms": None}
    de["bound_ms"], de["bound_by"] = bound(nbytes_d, n, PEAK_F32)
    rows["quant_int8"] = [qe]
    rows["dequant_int8"] = [de]

    # flash attention: prefill at full width (24 q heads over 8 kv heads,
    # head dim 128), a ragged length, a query suffix, and head dim 64 with
    # a window.  Tolerance: 2e-2 (bf16 output, sums in another order).
    def sdpa(q, k, v, causal):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    cases = [(1, 1024, 1024, 24, 8, 128, None), (1, 777, 777, 24, 8, 128, None),
             (1, 128, 1024, 24, 8, 128, None), (2, 512, 512, 8, 2, 64, 256)]
    for B, Sq, Sk, H, KH, D, window in cases:
        qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=dev)[None, :]
        valid = kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        pairs = int(valid.sum())
        nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KH * D)
        k = sets_for(nbytes)
        qkv = [(rnd(B, Sq, H, D), rnd(B, Sk, KH, D), rnd(B, Sk, KH, D))
               for _ in range(k)]
        got = fa.flash_attention_bshd(*qkv[0], causal=True, window=window)
        want = ref.flash_attention_ref(*qkv[0], causal=True, window=window)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all()),
              f"flash {(B, Sq, Sk, H, KH, D, window)} max err {err}")
        e = {"shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KH": KH, "D": D,
                       "causal": True, "window": window},
             "max_abs_err": err,
             "ms": cuda_ms(torch, lambda i: fa.flash_attention_bshd(
                 *qkv[i], causal=True, window=window), k, 20),
             "plain_ms": cuda_ms(torch, lambda i: ref.flash_attention_ref(
                 *qkv[i], causal=True, window=window), k, 5),
             "library_ms": (cuda_ms(torch, lambda i: sdpa(*qkv[i], Sq == Sk), k, 20)
                            if window is None and (Sq == Sk) else None)}
        e["bound_ms"], e["bound_by"] = bound(nbytes, 4 * D * H * B * pairs, PEAK_BF16)
        rows.setdefault("flash_attention", []).append(e)
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU, small
# ---------------------------------------------------------------------------

def phase_small(torch, dev) -> dict:
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    cfg = smoke_config(get_config("llama3.2-3b"))
    model = build_model(cfg)
    p_cpu = tree_init(model.param_defs(), 0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(1, 40))
    errs = {}
    with torch.inference_mode():
        out = {}
        for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            logits, pc = model.prefill(p, {"tokens": torch.as_tensor(prompt, device=d)})
            cache = tree_init(model.cache_defs(1, 64), 0, device=d)
            for n in ("k", "v"):
                cache[n][:, :, :40].copy_(pc[n])
            dl, _ = model.decode_step(p, cache, torch.as_tensor([40], device=d),
                                      torch.as_tensor([[7]], device=d))
            out[name] = (logits.float().cpu(), dl.float().cpu())
        for i, what in enumerate(("prefill", "decode")):
            a, b = out["gpu"][i], out["cpu"][i]
            check(bool(torch.isfinite(a).all()), f"small {what} logits finite")
            errs[what] = float((a - b).abs().max())
            # bf16 end to end on both sides, rounded at other places
            check(errs[what] <= 5e-2, f"small {what} logits vs CPU: {errs[what]}")
    return {"max_abs_err": errs, "tolerance": 5e-2, "config": cfg.name}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 5: the serving engine at full width
# ---------------------------------------------------------------------------

def full_width(torch, dev):
    """llama3.2-3b at its published widths and depth, random bf16 weights
    from seed 0 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = tree_init(build_model(cfg).param_defs(), 0, device=dev)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def phase_engine(torch, dev, cfg, params) -> dict:
    import numpy as np
    from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core.kvship import kv_cache_bytes, plan_kv_ship
    from repro_torch.core.path import WAN_LONDON_POZNAN, WidePath
    from repro_torch.core.telemetry import get_telemetry
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServingEngine

    rc = RunConfig(model=cfg, shape=ShapeConfig("serve", 2048, 8, "decode"),
                   comm=CommConfig(), train=TrainConfig())
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(16):
        plen = int(rng.integers(128, 1025))
        mnew = int(rng.integers(16, 65))
        reqs.append((rng.integers(1, cfg.vocab_size, size=plen), mnew))
    tel = get_telemetry()
    runs = {}
    for label, compress in (("mono", None), ("disagg", "none"), ("disagg_int8", "int8")):
        path = None
        if compress is not None:
            path = WidePath(axis="pod", comm=CommConfig(streams=16, compress=compress),
                            link=WAN_LONDON_POZNAN, name="kvship")
        for rid in range(len(reqs)):
            key = f"serve/req{rid}/kv"
            tel.reset(key)
            if path is not None:
                for h, hop in enumerate(path.route):
                    tel.reset(f"{key}/hop{h}:{hop.name}")
        eng = ServingEngine(rc, mode="mono" if path is None else "disagg",
                            path=path, params=params, device=dev)
        for prompt, mnew in reqs:
            check(eng.submit(prompt, mnew) is not None, "request admitted")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(stats["completed"] == len(reqs), f"{label}: all {len(reqs)} requests complete")
        for rid, (_, mnew) in enumerate(reqs):
            toks = eng.results[rid]
            check(len(toks) == mnew, f"{label}: req{rid} max_new honoured")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: token ids")
        check(launches["flash_attention"] > 0 and launches["rmsnorm"] > 0,
              f"{label}: flash and rmsnorm kernels launched {launches}")
        wire_ok = None
        if path is not None:
            wire_ok = True
            for rid, (prompt, _) in enumerate(reqs):
                shape = (cfg.num_layers, len(prompt), cfg.num_kv_heads, cfg.resolved_head_dim)
                tmpl = {n: torch.empty(shape, dtype=torch.bfloat16, device="meta")
                        for n in ("k", "v")}
                plan = plan_kv_ship(tmpl, path)
                got = tel.path(f"serve/req{rid}/kv").total_bytes
                check(got == plan.wire_bytes_total,
                      f"{label}: req{rid} wire bytes {got} == plan {plan.wire_bytes_total}")
                if compress == "none":
                    check(got == kv_cache_bytes(cfg.num_layers, cfg.num_kv_heads,
                                                cfg.resolved_head_dim, len(prompt)),
                          f"{label}: req{rid} none codec ships the KV bytes")
        total_tokens = int(sum(len(t) for t in eng.results.values()))
        dec = sorted(eng.timings["decode_s"])
        runs[label] = {
            "results": dict(eng.results), "launches": launches,
            "summary": {
                "wall_s": wall, "tokens": total_tokens, "tokens_per_s": total_tokens / wall,
                "mean_prefill_ms": 1e3 * float(np.mean(eng.timings["prefill_s"])),
                "mean_ship_ms": 1e3 * float(np.mean(eng.timings["ship_s"])),
                "p50_decode_step_ms": 1e3 * dec[len(dec) // 2],
                "decode_steps": len(dec), "launches": launches,
                "wire_bytes_equal_plan": wire_ok,
                "modeled_ttft_p50_s": stats["ttft_p50_s"],
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
        emit({"phase": "engine", "run": label, **runs[label]["summary"]})
        del eng
        torch.cuda.empty_cache()
    mono, dis, q8 = (runs[k]["results"] for k in ("mono", "disagg", "disagg_int8"))
    for rid in mono:
        check(np.array_equal(mono[rid], dis[rid]), f"req{rid}: mono and disagg tokens bit-identical")
    l8 = runs["disagg_int8"]["launches"]
    check(all(v > 0 for v in l8.values()), f"int8 run launched every kernel: {l8}")
    agree = float(np.mean([np.mean(mono[r] == q8[r]) for r in mono]))
    return {"arch": cfg.name,
            "params": int(sum(p.numel() for p in _leaves(params))),
            "requests": len(reqs),
            "mono_disagg_bit_identical": True,
            "int8_token_agreement_with_mono": agree,
            "launches": runs["disagg_int8"]["launches"]}


# ---------------------------------------------------------------------------
# phase 6: where the device time goes, by kernel
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _bucket(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention (ours)"
    if "rmsnorm_kernel" in name:
        return "rmsnorm (ours)"
    if "quant_kernel" in name:
        return "quant/dequant (ours)"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions, softmax)"


def phase_profile(torch, dev, cfg, params) -> dict:
    """torch.profiler over one full-width prefill of 1024 tokens and over
    decode steps of 8 slots against a 2048-token cache: device time per
    call by kernel, and the share of the host-clock time the device idles."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (1, 1024), generator=g, device=dev)
    cache = tree_init(model.cache_defs(8, 2048), 0, device=dev)
    pos = torch.arange(8, device=dev) * 128 + 512
    dtok = torch.randint(1, cfg.vocab_size, (8, 1), generator=g, device=dev)
    windows = {
        "prefill_1024": (lambda: model.prefill(params, {"tokens": toks}), 3),
        "decode_step_b8_cache2048": (
            lambda: model.decode_step(params, cache, pos, dtok), 10)}
    out = {}
    with torch.inference_mode():
        for name, (fn, n) in windows.items():
            fn()
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / n
            kernels = {}
            for e in prof.key_averages():
                if not str(e.device_type).endswith("CUDA"):
                    continue
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                if us > 0:
                    kernels[e.key] = (us / 1e3 / n, e.count // n)
            busy = sum(ms for ms, _ in kernels.values())
            buckets = {}
            for k, (ms, cnt) in kernels.items():
                b = buckets.setdefault(_bucket(k), [0.0, 0])
                b[0] += ms
                b[1] += cnt
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
            out[name] = {
                "wall_ms_per_call": wall_ms,
                "device_busy_ms_per_call": busy if kernels else None,
                "device_idle_share": (1 - busy / wall_ms) if kernels else None,
                "by_bucket_ms": {k: round(v[0], 4) for k, v in sorted(
                    buckets.items(), key=lambda kv: -kv[1][0])},
                "launches_per_call_by_bucket": {k: v[1] for k, v in buckets.items()},
                "top_kernels": [[k[:90], round(ms, 4), cnt] for k, (ms, cnt) in top]}
    return out


# (name, source, the TPU kernel it replaces, tolerance against its plain version)
KERNELS = [
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:24", "abs 2e-2 + rel 2e-2"),
    ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:14", "one bf16 ulp"),
    ("quant_int8", "src/repro_torch/kernels/csrc/quant.cu",
     "src/repro/kernels/quant.py:17", "exact"),
    ("dequant_int8", "src/repro_torch/kernels/csrc/quant.cu",
     "src/repro/kernels/quant.py:26", "exact"),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t_start = time.perf_counter()
    if "env" in phases:
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi})
    if "build" in phases:
        t0 = time.perf_counter()
        built = build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": built, "dir": str(build.BUILD_DIR.relative_to(ROOT))})
    krows = phase_kernels(torch, dev) if "kernels" in phases else {}
    if krows:
        emit({"phase": "kernels", "card": smi, **krows})
    if "small" in phases:
        emit({"phase": "small", **phase_small(torch, dev)})
    eng = {}
    if "engine" in phases or "profile" in phases:
        cfg, params, init_s = full_width(torch, dev)
        if "engine" in phases:
            eng = phase_engine(torch, dev, cfg, params)
            emit({"phase": "engine_summary", "param_init_s": init_s, **eng})
        if "profile" in phases:
            emit({"phase": "profile", "card": smi,
                  **phase_profile(torch, dev, cfg, params)})
        del params
    if krows:
        line = []
        for name, source, replaces, tol in KERNELS:
            main_row = krows[name][0]
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": eng.get("launches", {}).get(name, 0),
                         "max_abs_err": main_row["max_abs_err"],
                         "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                         "bound_ms": main_row["bound_ms"],
                         "bound_by": main_row["bound_by"],
                         "library_ms": main_row["library_ms"],
                         "shape": main_row["shape"], "tolerance": tol,
                         "agrees_with_plain": True,   # a disagreement raised above
                         "checks": len(krows[name]) + len(main_row.get("other_blocks", []))})
        emit({"kernels": line})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
