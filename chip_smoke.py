#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, one JSON line each; any failure raises and exits nonzero:

1. env      torch/CUDA versions and the card (nvidia-smi name, power limit);
2. build    nvcc builds the five kernels from ``src/repro_torch/kernels/csrc``
            (one nvcc per source, all started together) and reports each
            kernel's registers and spills (ptxas); no kernel may spill;
3. kernels  each kernel against its plain PyTorch version on the card, at the
            serving and training paths' shapes (the flash forward also at
            h2o-danube-3-4b's head dim 120; the flash backward at the
            llama3.2-3b, qwen1.5-0.5b and danube shapes, causal and
            windowed), with times (CUDA events), the bound and a PyTorch
            library call as a yardstick where one exists (SDPA; with a
            dense boolean mask for a window), and the launch floor (an
            empty kernel, timed the same way); the backward's device time
            split into its delta, dK/dV and dQ kernels (torch.profiler),
            with each one's registers and shared memory;
4. small    the port on the card against the port on the CPU (plain
            versions) at smoke size: prefill and decode logits, and one
            training step's loss and gradients;
5. engine   full-width llama3.2-3b (random weights from seed 0) serving 16
            seeded requests with continuous batching, three ways: mono,
            disagg over the London-Poznan WAN path, and disagg with the int8
            wire codec; mono and disagg tokens must be bit-identical, every
            ship's telemetry wire bytes must equal the plan, and each kernel
            must have launched during the run (counts reset just before it);
6. profile  torch.profiler over a full-width prefill, a decode step and
            one KV ship of a 1024-token prompt (int8 codec, and none): device
            time by kernel, the device's idle share, the host ops that take
            the most time, and each window's wall time without the profiler;
7. train    ``python -m repro_torch.launch.train``'s path: full-width
            qwen1.5-0.5b (24 layers, random weights from seed 0) as 2 pod
            ranks, two processes sharing the one card, 4096 tokens a step
            per pod, 3 steps with each wire codec (none, bf16, int8) over the
            hierarchical streamed psum; both pods' parameters bit-identical
            after every step, every step's chunks and wire bytes equal to the
            plan, and the kernels launched in each run (counts reset in each
            rank just before it trains); step ms, tokens/s per pod, sync ms,
            wire bytes and peak memory per rank, and one profiled int8 step.

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12            # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_BF16 = 989e12           # dense bf16 tensor-core rate
PEAK_F32 = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 << 20
PHASES = ("env", "build", "kernels", "small", "engine", "profile", "train")
CODECS = ("none", "bf16", "int8")


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

    # the least time a launch takes on this card, timed as the kernels are:
    # what no kernel design can remove from a small call
    floor_ms = cuda_ms(torch, lambda i: torch.cuda._sleep(0), 1, 200)
    rows["launch_floor_ms"] = floor_ms

    # rmsnorm: every block's two norms and the final one; rows = prompt tokens
    # in prefill, slots in decode (llama3.2-3b, d 3072), tokens of a training
    # step (qwen1.5-0.5b, d 1024).  Tolerance: one bf16 ulp.
    for R, d, on in ((1024, 3072, "serving"), (8, 3072, "serving"),
                     (4096, 1024, "train")):
        nbytes = 2 * R * d * 2 + d * 2
        k = sets_for(nbytes)
        xs = [rnd(R, d) for _ in range(k)]
        w = rnd(d)
        got = rmsnorm.rmsnorm_rows(xs[0], w)
        want = ref.rmsnorm_ref(xs[0], w)
        ulps = bf16_ulp_err(torch, got, want)
        check(ulps <= 1.0, f"rmsnorm ({R},{d}) within one bf16 ulp, got {ulps}")
        y = torch.empty_like(xs[0])
        entry = {"on_path": on, "shape": [R, d], "dtype": "bfloat16",
                 "path": ["scalar", "vector", "row"][rmsnorm.row_path(
                     d, 2, xs[0].data_ptr(), y.data_ptr(), w.data_ptr())],
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "max_err_bf16_ulps": ulps,
                 "ms": cuda_ms(torch, lambda i: rmsnorm.rmsnorm_rows(xs[i], w), k, 200),
                 "plain_ms": cuda_ms(torch, lambda i: ref.rmsnorm_ref(xs[i], w), k, 20),
                 "library_ms": cuda_ms(torch, lambda i: torch.nn.functional.rms_norm(
                     xs[i], (d,), w, 1e-5), k, 50)}
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, 4 * R * d, PEAK_F32)
        rows.setdefault("rmsnorm", []).append(entry)

    # quant / dequant: one 8 MiB bf16 chunk of a full-width KV leaf (4 layers
    # of a 1024-token prompt) as the KV ship hands it over, and the same
    # elements in f32 (the gradient codec's input once it is ported); quant
    # takes its warp path, dequant its vector path.  Then the block paths:
    # other block sizes and a misaligned view.  Tolerance: exact.
    n = 4 * 1024 * 8 * 128
    rows["quant_int8"], rows["dequant_int8"] = [], []
    for dt in (torch.bfloat16, torch.float32):
        nbytes = dt.itemsize * n + n + 4 * (n // 256)     # x (or out), q and s, once each
        k = sets_for(nbytes)
        xs = [rnd(1, n, dtype=dt, scale=3.0) for _ in range(k)]
        check(quant.quant_path(256, xs[0].data_ptr()) == quant.PATH_VECTOR,
              "quant takes the warp path on the KV chunk")
        q, s = quant.quant_int8_2d(xs[0], block=256)
        qr, sr = ref.quant_int8_ref(xs[0], 256)
        check(torch.equal(q, qr) and torch.equal(s, sr), f"quant 8 MiB chunk {dt} exact")
        check(quant.dequant_path(256, q.data_ptr()) == quant.PATH_VECTOR,
              "dequant takes the vector path on the KV chunk")
        y = quant.dequant_int8_2d(q, s, block=256, dtype=dt)
        check(torch.equal(y, ref.dequant_int8_ref(q, s, 256, dt)),
              f"dequant 8 MiB chunk to {dt} exact")
        qs = [quant.quant_int8_2d(x, block=256) for x in xs]
        name = str(dt).removeprefix("torch.")
        qe = {"on_path": "serving", "shape": [1, n], "dtype_in": name, "block": 256,
              "path": "warp",
              "max_abs_err": 0.0, "exact": True,
              "ms": cuda_ms(torch, lambda i: quant.quant_int8_2d(xs[i], block=256), k, 100),
              "plain_ms": cuda_ms(torch, lambda i: ref.quant_int8_ref(xs[i], 256), k, 10),
              "library_ms": None}
        qe["bound_ms"], qe["bound_by"] = bound(nbytes, 3 * n, PEAK_F32)
        de = {"on_path": "serving", "shape": [1, n], "dtype_out": name, "block": 256,
              "path": "vector",
              "max_abs_err": 0.0, "exact": True,
              "ms": cuda_ms(torch, lambda i: quant.dequant_int8_2d(
                  *qs[i], block=256, dtype=dt), k, 100),
              "plain_ms": cuda_ms(torch, lambda i: ref.dequant_int8_ref(
                  *qs[i], 256, dt), k, 10),
              "library_ms": None}
        de["bound_ms"], de["bound_by"] = bound(nbytes, n, PEAK_F32)
        for e in (qe, de):
            e["share_of_bound"] = e["bound_ms"] / e["ms"]
        rows["quant_int8"].append(qe)
        rows["dequant_int8"].append(de)
        del xs, qs
    extra = []
    for R, nn, block, misaligned in ((3, 768, 256, False), (3, 768, 256, True),
                                     (5, 700, 100, False), (2, 96, 1, False),
                                     (4, 21, 7, False), (4, 144, 48, False)):
        for dt in (torch.bfloat16, torch.float32):
            x = rnd(R * nn + misaligned, dtype=dt, scale=7.0)[int(misaligned):].view(R, nn)
            x[0, :block] = 0.0
            qb, sb = quant.quant_int8_2d(x, block=block)
            qbr, sbr = ref.quant_int8_ref(x, block)
            check(torch.equal(qb, qbr) and torch.equal(sb, sbr),
                  f"quant block={block} {dt} misaligned={misaligned} exact")
            for odt in (torch.float32, torch.bfloat16):
                check(torch.equal(quant.dequant_int8_2d(qb, sb, block=block, dtype=odt),
                                  ref.dequant_int8_ref(qb, sb, block, odt)),
                      f"dequant block={block} to {odt} exact")
            extra.append({"shape": [R, nn], "block": block,
                          "dtype_in": str(dt).removeprefix("torch."),
                          "misaligned": misaligned,
                          "quant_path": ["block", "warp"][quant.quant_path(block, x.data_ptr())],
                          "dequant_path": ["block", "vector"][quant.dequant_path(
                              block, qb.data_ptr())],
                          "exact": True})
    rows["quant_int8"][0]["other_blocks"] = extra

    # the gradient codec's commonest call in a qwen1.5-0.5b training step:
    # an f32 chunk of 63 rows of a (24, 1024, 2816) leaf, its scatter dim
    # moved last and padded to one 256-block (67584 rows of 256), and the
    # dequantize of the two pods' gathered chunks.  Tolerance: exact.
    R, nb = 67584, 256
    n = R * nb
    nbytes_q = 4 * n + n + 4 * (n // 256)
    k = sets_for(nbytes_q)
    xs = [rnd(R, nb, dtype=torch.float32, scale=1e-3) for _ in range(k)]
    q, s = quant.quant_int8_2d(xs[0], block=256)
    qr, sr = ref.quant_int8_ref(xs[0], 256)
    check(torch.equal(q, qr) and torch.equal(s, sr), "quant gradient chunk exact")
    gathered = [tuple(torch.cat([t, t]) for t in quant.quant_int8_2d(x, block=256))
                for x in xs]
    y = quant.dequant_int8_2d(*gathered[0], block=256, dtype=torch.float32)
    check(torch.equal(y, ref.dequant_int8_ref(*gathered[0], 256, torch.float32)),
          "dequant gathered gradient chunks exact")
    qe = {"on_path": "train", "shape": [R, nb], "dtype_in": "float32", "block": 256,
          "path": "warp", "max_abs_err": 0.0, "exact": True,
          "ms": cuda_ms(torch, lambda i: quant.quant_int8_2d(xs[i], block=256), k, 50),
          "plain_ms": cuda_ms(torch, lambda i: ref.quant_int8_ref(xs[i], 256), k, 5),
          "library_ms": None}
    qe["bound_ms"], qe["bound_by"] = bound(nbytes_q, 3 * n, PEAK_F32)
    n2 = 2 * n
    nbytes_d = n2 + 4 * (n2 // 256) + 4 * n2
    de = {"on_path": "train", "shape": [2 * R, nb], "dtype_out": "float32", "block": 256,
          "path": "vector", "max_abs_err": 0.0, "exact": True,
          "ms": cuda_ms(torch, lambda i: quant.dequant_int8_2d(
              *gathered[i], block=256, dtype=torch.float32), k, 50),
          "plain_ms": cuda_ms(torch, lambda i: ref.dequant_int8_ref(
              *gathered[i], 256, torch.float32), k, 5),
          "library_ms": None}
    de["bound_ms"], de["bound_by"] = bound(nbytes_d, n2, PEAK_F32)
    for e, name in ((qe, "quant_int8"), (de, "dequant_int8")):
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        rows[name].append(e)
    del xs, gathered

    # flash attention: prefill at full width (24 q heads over 8 kv heads,
    # head dim 128) at the engine's prompt lengths 1024, 512 and 128, a
    # ragged length, a query suffix, head dim 64 with a window, and
    # h2o-danube-3-4b's full width (32 q heads over 8, head dim 120), with
    # and without a window.
    # Tolerance: 2e-2 (bf16 output, P rounded to bf16, sums in another order).
    from torch.nn.attention.bias import causal_lower_right

    def sdpa(q, k, v, window=None):
        """Causal SDPA with queries aligned to the end of the keys; a window
        as a dense boolean mask, with enable_gqa only where the heads differ
        (SDPA's memory-efficient backend takes a mask but no GQA)."""
        Sq, Sk = q.shape[1], k.shape[1]
        if window is not None:
            mask = dict(attn_mask=window_mask(torch, dev, Sq, Sk, window),
                        enable_gqa=q.shape[2] != k.shape[2])
        elif Sq == Sk:
            mask = dict(is_causal=True, enable_gqa=True)
        else:
            mask = dict(attn_mask=causal_lower_right(Sq, Sk), enable_gqa=True)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **mask).transpose(1, 2)

    cases = [(1, 1024, 1024, 24, 8, 128, None), (1, 777, 777, 24, 8, 128, None),
             (1, 128, 1024, 24, 8, 128, None), (2, 512, 512, 8, 2, 64, 256),
             (1, 512, 512, 24, 8, 128, None), (1, 128, 128, 24, 8, 128, None),
             (1, 1024, 1024, 32, 8, 120, None), (1, 1024, 1024, 32, 8, 120, 256),
             (1, 4096, 4096, 16, 16, 64, None)]    # qwen1.5-0.5b's training step
    for B, Sq, Sk, H, KH, D, window in cases:
        pairs = causal_pairs(torch, dev, Sq, Sk, window)
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
        e = {"on_path": "train" if Sq == 4096 else "serving",
             "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KH": KH, "D": D,
                       "causal": True, "window": window},
             "max_abs_err": err,
             "ms": cuda_ms(torch, lambda i: fa.flash_attention_bshd(
                 *qkv[i], causal=True, window=window), k, 50),
             "plain_ms": cuda_ms(torch, lambda i: ref.flash_attention_ref(
                 *qkv[i], causal=True, window=window), k, 5)}
        e["library_ms"] = cuda_ms(torch, lambda i: sdpa(*qkv[i], window), k, 50)
        e["library_max_abs_err"] = float(
            (sdpa(*qkv[0], window).float() - want.float()).abs().max())
        e["bound_ms"], e["bound_by"] = bound(nbytes, 4 * D * H * B * pairs, PEAK_BF16)
        rows.setdefault("flash_attention", []).append(e)
    rows["flash_attention_bwd"] = phase_kernels_flash_bwd(torch, dev, rnd)
    torch.cuda.synchronize()
    return rows


def window_mask(torch, dev, Sq: int, Sk: int, window):
    """(Sq, Sk) bool, True where a query (aligned to the end of the keys)
    sees a key: causal, and within `window` keys when it is not None."""
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    valid = kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    return valid


def causal_pairs(torch, dev, Sq: int, Sk: int, window) -> int:
    """(query, key) pairs a causal (windowed) attention computes."""
    return int(window_mask(torch, dev, Sq, Sk, window).sum())


def phase_kernels_flash_bwd(torch, dev, rnd) -> list:
    """The flash backward against autograd through the plain version, at
    the training shapes: qwen1.5-0.5b (16 heads, head dim 64, 4096 tokens,
    the train phase's), llama3.2-3b (24 over 8, 128) and h2o-danube-3-4b
    (32 over 8, 120) at 1024 tokens, each causal and with a window.
    Tolerance: each gradient elementwise within 2 % of its largest entry
    plus 2 % of the entry (bf16 output, P and dS rounded to bf16 before the
    products, delta from the bf16 output, sums in another order).  Bound:
    the forward's causal operations times 2.5 (five products against two)
    at the bf16 peak, against the bytes of q, k, v, o, dO, lse read once and
    dq, dk, dv written once.  Library: SDPA forward + backward minus SDPA
    forward, at the same shape; a window as a dense boolean mask.  Parts:
    each of the backward's three kernels' device time from torch.profiler
    over back-to-back calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    F = torch.nn.functional

    def plain_grads(q, k, v, do, window):
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = ref.flash_attention_ref(qs, ks, vs, causal=True, window=window)
        return torch.autograd.grad(o, (qs, ks, vs), do)

    out = []
    cases = [(1, 4096, 16, 16, 64, None), (1, 4096, 16, 16, 64, 1024),
             (1, 1024, 24, 8, 128, None), (1, 1024, 24, 8, 128, 256),
             (1, 1024, 32, 8, 120, None), (1, 1024, 32, 8, 120, 256)]
    for B, S, H, KH, D, window in cases:
        pairs = causal_pairs(torch, dev, S, S, window)
        nbytes = 2 * 4 * (B * S * H * D + B * S * KH * D) + 4 * B * H * S
        k_sets = sets_for(nbytes)
        sets = []
        for _ in range(k_sets):
            q, k, v = rnd(B, S, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D)
            do = rnd(B, S, H, D)
            o, lse = fa.flash_attention_bshd(q, k, v, causal=True, window=window,
                                             return_lse=True)
            sets.append((q, k, v, o, lse, do))
        got = fa.flash_attention_bwd_bshd(*sets[0], causal=True, window=window)
        q, k, v, _, _, do = sets[0]
        want = plain_grads(q, k, v, do, window)
        err, rel = 0.0, 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            d = (g.float() - w.float()).abs()
            top = float(w.float().abs().max())
            check(bool(torch.isfinite(g).all()), f"flash bwd {name} finite")
            check(bool((d <= 2e-2 * top + 2e-2 * w.float().abs()).all()),
                  f"flash bwd {(B, S, H, KH, D, window)} {name}: max err "
                  f"{float(d.max())} against largest entry {top}")
            err, rel = max(err, float(d.max())), max(rel, float(d.max()) / top)
        del got, want
        e = {"on_path": "train" if S == 4096 else "shape of another model",
             "shape": {"B": B, "Sq": S, "Sk": S, "H": H, "KH": KH, "D": D,
                       "causal": True, "window": window},
             "max_abs_err": err, "max_err_over_largest": rel,
             "ms": cuda_ms(torch, lambda i: fa.flash_attention_bwd_bshd(
                 *sets[i], causal=True, window=window), k_sets, 20),
             "plain_ms": cuda_ms(torch, lambda i: plain_grads(
                 *[sets[i][j] for j in (0, 1, 2, 5)], window), k_sets, 3)}
        mask = None if window is None else window_mask(torch, dev, S, S, window)
        t_fb, t_f = sdpa_bwd_ms(torch, F, sets, k_sets, mask)
        e["library_ms"] = t_fb - t_f
        e["library_fwd_bwd_ms"], e["library_fwd_ms"] = t_fb, t_f
        e["parts_ms"] = bwd_parts_ms(torch, lambda i: fa.flash_attention_bwd_bshd(
            *sets[i], causal=True, window=window), k_sets, 20)
        e["resources"] = fa.bwd_resources(D)
        e["bound_ms"], e["bound_by"] = bound(nbytes, 2.5 * 4 * D * H * B * pairs,
                                             PEAK_BF16)
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        out.append(e)
        del sets
        torch.cuda.empty_cache()
    return out


def sdpa_bwd_ms(torch, F, sets, n_sets: int, mask):
    """(forward + backward ms, forward ms) of SDPA on the inputs of `sets`:
    causal, or with the dense boolean `mask` (enable_gqa only where the
    heads differ, as in `phase_kernels`' forward)."""
    lib = []
    for q, k, v, _, _, do in sets:
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib.append((qg, kg, vg, do.transpose(1, 2)))
    kw = dict(is_causal=True, enable_gqa=True) if mask is None else dict(
        attn_mask=mask, enable_gqa=sets[0][0].shape[2] != sets[0][1].shape[2])

    def fwd(i):
        qg, kg, vg, _ = lib[i]
        return F.scaled_dot_product_attention(qg, kg, vg, **kw)

    def fwd_bwd(i):
        torch.autograd.grad(fwd(i), lib[i][:3], lib[i][3])

    return cuda_ms(torch, fwd_bwd, n_sets, 20), cuda_ms(torch, fwd, n_sets, 20)


BWD_KERNEL = re.compile(r"flash_bwd_(delta|dkdv|dq)_kernel")


def bwd_parts_ms(torch, fn, n_sets: int, iters: int) -> dict:
    """Device ms per call of each of the flash backward's kernels (delta,
    dkdv, dq) over `iters` back-to-back calls of fn(i) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_sets)
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        m = BWD_KERNEL.search(e.key)
        if m is None:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        parts[m.group(1)] = parts.get(m.group(1), 0.0) + us / 1e3 / iters
    check(set(parts) == {"delta", "dkdv", "dq"},
          f"the profiler saw the backward's three kernels: {sorted(parts)}")
    return parts


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
    return {"max_abs_err": errs, "tolerance": 5e-2, "config": cfg.name,
            "train_step": phase_small_train(torch, dev, cfg, model, p_cpu)}


# leaves whose gradients the small phase compares
GRAD_LEAVES = (("embed",), ("blocks", "attn", "wq"), ("blocks", "attn", "wo"),
               ("blocks", "ffn", "down"), ("blocks", "ln1"), ("ln_f",))


# AdamW's step moves an element by lr * (m_hat / sqrt(v_hat) + wd * p).  After
# the second step of beta1 = 0.9, beta2 = 0.95 (the first has lr 0),
# |m_hat / sqrt(v_hat)| <= sqrt(beta1^2 / beta2 + 1) * sqrt(1 + beta2) /
# (1 + beta1) = 1.0003 for any two gradients (Cauchy-Schwarz), so a gradient
# whose sign differs between card and CPU moves that element at most
# 2.0006 * lr apart, before the rounding to the parameter's dtype.
ADAM_STEP2_SPREAD = 2.0006
# share of the update that may differ between card and CPU, leaf by leaf
UPDATE_SHARE = 0.5


def _ulp(torch, x):
    """One ulp of each element of `x` (its dtype's), 0 counted as the
    smallest normal."""
    fi = torch.finfo(x.dtype)
    a = x.float().abs().clamp(min=fi.tiny)
    return torch.exp2(torch.floor(torch.log2(a))) * fi.eps


def phase_small_train(torch, dev, cfg, model, p_cpu) -> dict:
    """One smoke-size training run (1 pod, 3 steps) on the card against the
    same run on the CPU, from the same parameters and tokens.

    Compared: the gradients of a few leaves at the initial parameters; the
    losses of the three steps (the first has lr 0 and steps 1 and 2 take
    their loss before their own update, so the third is the first loss
    after a real update); and those leaves' parameters after step 2, the
    first update.  Tolerances: loss 2e-2, gradients 5e-2 relative to the
    leaf's largest entry (bf16 on both sides, rounded at other places; the
    card's flash kernels round P and dS to bf16).  The parameters: each
    element within ADAM_STEP2_SPREAD * lr plus one ulp of the parameter's
    dtype (a gradient near zero may take the other sign), and, leaf by
    leaf, the mean |card - CPU| at most UPDATE_SHARE of the mean distance
    the CPU's update moved the leaf (a card that applied no update, or the
    wrong one, fails this)."""
    import numpy as np
    from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core.tree import flatten, unflatten
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.step import build_train_step
    tc = TrainConfig(warmup_steps=1, total_steps=10, lr=1e-3)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                   comm=CommConfig(), train=tc)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 4, 65))

    def pick(tree):
        out = []
        for keys in GRAD_LEAVES:
            t = tree
            for k in keys:
                t = t[k]
            out.append(t.detach().cpu())
        return out

    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        params = _to(p_cpu, d)
        batch = {"tokens": torch.as_tensor(toks[0], device=d)}
        leaves, td = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = model.loss(unflatten(td, ps), batch)
        grads = unflatten(td, list(torch.autograd.grad(loss, ps)))
        b = build_train_step(rc, make_local_mesh(pod=1, device=d))
        state = {"params": params, "opt": init_opt_state(params)}
        ops.reset_launch_counts()
        losses = []
        for i in range(3):
            state, m = b.fn(state, {"tokens": torch.as_tensor(toks[i], device=d)})
            losses.append(float(m["loss"]))
            if i == 1:
                after = pick(state["params"])
        res[name] = {"losses": losses, "grads": [g.float() for g in pick(grads)],
                     "params": after, "launches": ops.launch_counts()}
    g, c = res["gpu"], res["cpu"]
    lg = g["launches"]
    check(lg["flash_attention"] > 0 and lg["flash_attention_bwd"] > 0
          and lg["rmsnorm"] > 0, f"small train step launched the kernels: {lg}")
    loss_err = max(abs(a - b) for a, b in zip(g["losses"], c["losses"]))
    check(all(math.isfinite(x) for x in g["losses"]) and loss_err <= 2e-2,
          f"small train step losses {g['losses']} vs CPU {c['losses']}")
    errs = {}
    for keys, a, b in zip(GRAD_LEAVES, g["grads"], c["grads"]):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(e <= 5e-2, f"small train grad {'/'.join(keys)}: {e}")
        errs["grad/" + "/".join(keys)] = e
    p0 = pick(p_cpu)
    for keys, a, b, x0 in zip(GRAD_LEAVES, g["params"], c["params"], p0):
        name = "/".join(keys)
        diff = (a.float() - b.float()).abs()
        limit = ADAM_STEP2_SPREAD * tc.lr + _ulp(torch, torch.maximum(a.abs(), b.abs()))
        worst = float((diff / limit).max())
        check(worst <= 1.0, f"small train param {name} after the first update: "
              f"|card - CPU| reaches {worst} of its limit")
        moved = float((b.float() - x0.float()).abs().mean())
        share = (float(diff.mean()) / moved if moved > 0
                 else 0.0 if float(diff.max()) == 0 else math.inf)
        check(share <= UPDATE_SHARE, f"small train param {name} after the first "
              f"update: mean |card - CPU| is {share} of the update's mean size")
        errs["param/" + name] = {"worst_over_limit": worst, "share_of_update": share,
                                 "update_mean_abs": moved}
    return {"losses_gpu": g["losses"], "losses_cpu": c["losses"],
            "loss_max_abs_err": loss_err, "errors": errs,
            "launches_gpu": lg,
            "tolerance": {"loss": 2e-2, "grad": 5e-2,
                          "param": f"{ADAM_STEP2_SPREAD} * lr + 1 ulp per element; "
                                   f"mean {UPDATE_SHARE} of the update per leaf"}}


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
    check(all(l8[k] > 0 for k in SERVING_KERNELS),
          f"int8 run launched every serving kernel: {l8}")
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
    if "flash_fwd_wgmma_kernel" in name:
        return "flash_attention (ours)"
    if (m := BWD_KERNEL.search(name)):
        return f"flash_attention_bwd {m.group(1)} (ours)"
    if "rmsnorm_warp_kernel" in name or "rmsnorm_twopass_kernel" in name:
        return "rmsnorm (ours)"
    if re.search(r"quant_(warp|block|vec)_kernel", name):
        return "quant/dequant (ours)"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions, softmax)"


def phase_profile(torch, dev, cfg, params) -> dict:
    """torch.profiler over one full-width prefill of 1024 tokens, over decode
    steps of 8 slots against a 2048-token cache, and over one KV ship of a
    1024-token prompt with the int8 codec and without one: device time per
    call by kernel, the share of the host-clock time the device idles, the
    torch ops' own host time (the rest of the wall time is Python and the
    wrappers), and the host-clock time of the same calls without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CommConfig
    from repro_torch.core.kvship import plan_kv_ship, ship_kv
    from repro_torch.core.path import WAN_LONDON_POZNAN, WidePath
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (1, 1024), generator=g, device=dev)
    cache = tree_init(model.cache_defs(8, 2048), 0, device=dev)
    pos = torch.arange(8, device=dev) * 128 + 512
    dtok = torch.randint(1, cfg.vocab_size, (8, 1), generator=g, device=dev)
    kv_shape = (cfg.num_layers, 1024, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = {n: torch.randn(kv_shape, generator=g, device=dev).to(torch.bfloat16)
          for n in ("k", "v")}
    plans = {c: plan_kv_ship(kv, WidePath(axis="pod", comm=CommConfig(streams=16, compress=c),
                                          link=WAN_LONDON_POZNAN, name="kvship"))
             for c in ("int8", "none")}
    windows = {
        "prefill_1024": (lambda: model.prefill(params, {"tokens": toks}), 3),
        "decode_step_b8_cache2048": (
            lambda: model.decode_step(params, cache, pos, dtok), 10),
        # the same ship without a codec: what the int8 codec adds to a ship
        "ship_kv_int8_1024": (lambda: ship_kv(kv, plans["int8"], 10_000), 10),
        "ship_kv_none_1024": (lambda: ship_kv(kv, plans["none"], 10_001), 10)}
    out = {}
    with torch.inference_mode():
        for name, (fn, n) in windows.items():
            fn()
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            plain_wall_ms = 1e3 * (time.perf_counter() - t0) / n
            ops.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / n
            ours = {k: v / n for k, v in ops.launch_counts().items()}
            kernels, host = {}, {}
            for e in prof.key_averages():
                if not str(e.device_type).endswith("CUDA"):
                    host[e.key] = (e.self_cpu_time_total / 1e3 / n, e.count / n)
                    continue
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                if us > 0:
                    kernels[e.key] = (us / 1e3 / n, e.count / n)
            busy = sum(ms for ms, _ in kernels.values())
            buckets = {}
            for k, (ms, cnt) in kernels.items():
                b = buckets.setdefault(_bucket(k), [0.0, 0])
                b[0] += ms
                b[1] += cnt
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
            top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
            out[name] = {
                "wall_ms_per_call": wall_ms,
                "wall_ms_per_call_unprofiled": plain_wall_ms,
                "device_busy_ms_per_call": busy if kernels else None,
                "device_idle_share": (1 - busy / wall_ms) if kernels else None,
                "host_ops_self_ms_per_call": sum(ms for ms, _ in host.values()),
                "launches_per_call": sum(v[1] for v in buckets.values()),
                "our_kernel_launches_per_call": ours,
                "by_bucket_ms": {k: round(v[0], 4) for k, v in sorted(
                    buckets.items(), key=lambda kv: -kv[1][0])},
                "share_of_busy_by_bucket": {k: v[0] / busy for k, v in buckets.items()}
                if busy else None,
                "launches_per_call_by_bucket": {k: v[1] for k, v in buckets.items()},
                "top_kernels": [[k[:90], round(ms, 4), cnt] for k, (ms, cnt) in top],
                "top_host_ops_self_ms": [[k[:60], round(ms, 4), cnt]
                                         for k, (ms, cnt) in top_host]}
    return out


# ---------------------------------------------------------------------------
# phase 7: full-width training across two pods on the one card
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--global-batch", "2",
              "--steps", "3", "--pods", "2", "--mode", "hierarchical",
              "--check-replicas"]
PROFILE_STEP = 3     # the int8 run takes a fourth step, under the profiler


def phase_train(torch, out_dir: str) -> dict:
    """``python -m repro_torch.launch.train`` with each wire codec: 2 pod
    ranks (spawned processes, gloo) on the card, full-width qwen1.5-0.5b at
    4096 tokens, 3 steps; the int8 run takes a fourth step, which rank 0
    runs under torch.profiler.  Each rank resets the kernel counts just before it
    trains and reports them after; the launcher fails if the two pods'
    parameters differ after any step (``--check-replicas``)."""
    import numpy as np
    from repro_torch.launch import train as launcher
    runs = {}
    for codec in CODECS:
        rep = os.path.join(out_dir, f"train_{codec}")
        argv = TRAIN_ARGS + ["--compress", codec, "--report", rep]
        if codec == "int8":
            argv += ["--steps", str(PROFILE_STEP + 1), "--profile-step", str(PROFILE_STEP)]
        t0 = time.perf_counter()
        launcher.main(argv)
        wall = time.perf_counter() - t0
        reps = [json.load(open(f"{rep}.rank{r}.json")) for r in range(2)]
        r0 = reps[0]
        plan = r0["plan"]
        for r, rp in enumerate(reps):
            check(rp["plan"] == plan, f"{codec}: rank {r} noted the same plan")
            la = rp["launches"]
            check(la["flash_attention"] > 0 and la["flash_attention_bwd"] > 0
                  and la["rmsnorm"] > 0, f"{codec} rank {r}: kernels launched {la}")
            want_q = plan["n_chunks"] * len(rp["history"]) if codec == "int8" else 0
            check(la["quant_int8"] == la["dequant_int8"] == want_q,
                  f"{codec} rank {r}: quant/dequant once per chunk per step "
                  f"({want_q}), got {la}")
            for h in rp["history"]:
                check(math.isfinite(h["loss"]), f"{codec} rank {r}: finite loss {h}")
                check(h["n_chunks"] == plan["n_chunks"]
                      and h["payload_bytes"] == plan["payload_bytes"]
                      and round(h["wire_bytes"]) == plan["wire_bytes"],
                      f"{codec} rank {r} step {h['step']}: chunks {h['n_chunks']}, "
                      f"payload {h['payload_bytes']}, wire {h['wire_bytes']} "
                      f"against the plan {plan}")
        sums = [[h["checksum"] for h in rp["history"]] for rp in reps]
        check(sums[0] == sums[1], f"{codec}: pods' parameters bit-identical "
                                  f"after every step {sums}")
        h = r0["history"][1:3]            # steps 2 and 3, unprofiled
        step_s = float(np.median([x["time_s"] for x in h]))
        tokens = r0["seq_len"] * r0["global_batch"] // r0["pods"]
        runs[codec] = {
            "wall_s_with_spawn": wall, "losses": [x["loss"] for x in r0["history"]],
            "step_ms_median_steps_2_3": 1e3 * step_s,
            "tokens_per_s_per_pod": tokens / step_s,
            "sync_ms_median_steps_2_3": 1e3 * float(np.median([x["sync_s"] for x in h])),
            "step_ms": [1e3 * x["time_s"] for x in r0["history"]],
            "step_ms_rank1": [1e3 * x["time_s"] for x in reps[1]["history"]],
            "sync_ms": [1e3 * x["sync_s"] for x in r0["history"]],
            "wire_bytes_per_step": r0["history"][-1]["wire_bytes"],
            "sent_bytes_per_step": r0["history"][-1]["sent_bytes"],
            "n_chunks": plan["n_chunks"], "streams": r0["streams"],
            "chunk_mb": r0["chunk_mb"], "plan_wire_bytes": plan["wire_bytes"],
            "payload_bytes": plan["payload_bytes"],
            "peak_mem_gb_per_rank": [(rp["peak_mem_bytes"] or 0) / 1e9 for rp in reps],
            "launches_rank0": r0["launches"], "device": r0["device_name"],
            "params": r0["params"], "seq_len": r0["seq_len"],
            "global_batch": r0["global_batch"]}
        if r0["profile"] is not None:
            p = r0["profile"]
            buckets: dict = {}
            for name, sec, cnt in p["device_ops"]:
                b = buckets.setdefault(_bucket(name), [0.0, 0])
                b[0] += 1e3 * sec
                b[1] += cnt
            runs[codec]["profile"] = {
                "step": p["step"], "wall_ms": 1e3 * p["wall_s"],
                "device_busy_ms": 1e3 * p["device_busy_s"],
                "device_idle_share": p["device_idle_share"],
                "device_launches": p["device_launches"],
                "device_ops_by_bucket_ms": buckets,
                "top_device_ops": [[n[:90], 1e3 * sec, cnt]
                                   for n, sec, cnt in p["device_ops"][:12]]}
        emit({"phase": "train", "codec": codec, **runs[codec]})
    return runs


def _demangle(names: list[str]) -> list[str]:
    """`void (anonymous namespace)::k<128, 4>(...)` -> `k<128, 4>`, by
    c++filt where the toolkit has it; the mangled names otherwise."""
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return names
    return [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in out]


def phase_build_resources(build, built: list[str]) -> dict:
    """Registers and spill bytes of every kernel this process compiled;
    fails if a flash, rmsnorm, quant or dequant kernel spills."""
    res = {}
    for name in built:
        found = build.resources(name)
        for short, (mangled, r) in zip(_demangle(list(found)), found.items()):
            res[short] = r
            if any(t in mangled for t in ("flash_fwd", "flash_bwd", "rmsnorm", "quant_")):
                check(r["spill_bytes"] == 0, f"{short} spills {r['spill_bytes']} bytes")
    return res


# (name, source, the TPU kernel it replaces, tolerance against its plain version)
SERVING_KERNELS = ("flash_attention", "rmsnorm", "quant_int8", "dequant_int8")
KERNELS = [
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:24", "abs 2e-2 + rel 2e-2"),
    # no Pallas backward: the JAX package differentiates its blocked jnp
    # attention (causal_blocked) on the CPU
    ("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/ops.py:154", "2% of the largest entry + rel 2%"),
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
              "built": built, "dir": str(build.BUILD_DIR.relative_to(ROOT)),
              "ptxas": phase_build_resources(build, built)})
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
        torch.cuda.empty_cache()
    train = {}
    if "train" in phases:
        import tempfile
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
            train = phase_train(torch, d)
    if krows:
        line = []
        # launches on the training path (int8 run, rank 0: all five kernels);
        # the serving path's, from the engine's int8 run, beside them
        on_path = train.get("int8", {}).get("launches_rank0", {})
        for name, source, replaces, tol in KERNELS:
            # the row at the training path's shape
            main_row = next(r for r in krows[name] if r.get("on_path") == "train")
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": on_path.get(name, 0),
                         "launches_serving": eng.get("launches", {}).get(name, 0),
                         "max_abs_err": main_row["max_abs_err"],
                         "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                         "bound_ms": main_row["bound_ms"],
                         "bound_by": main_row["bound_by"],
                         "library_ms": main_row["library_ms"],
                         "shape": main_row["shape"], "tolerance": tol,
                         "agrees_with_plain": True,   # a disagreement raised above
                         "checks": len(krows[name])
                         + len(krows[name][0].get("other_blocks", [])),
                         **{k: main_row[k] for k in ("parts_ms", "resources")
                            if k in main_row}})
        emit({"kernels": line})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
