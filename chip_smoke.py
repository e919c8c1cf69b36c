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
            h2o-danube-3-4b's head dim 120, and not causal at
            whisper-medium's encoder and cross-attention shapes, a query
            block under 64 rows, a one-key last tile and GQA with
            Sq != Sk; the flash backward at the
            llama3.2-3b, qwen1.5-0.5b and danube shapes, causal and
            windowed, and at the families' training shapes: whisper's
            encoder and cross-attention not causal, Sq != Sk), with times (CUDA events), the bound and a PyTorch
            library call as a yardstick where one exists (SDPA; with a
            dense boolean mask for a window), and the launch floor (an
            empty kernel, timed the same way); the backward's device time
            split into its delta, dK/dV and dQ kernels (torch.profiler),
            with each one's registers and shared memory;
4. small    the port on the card against the port on the CPU (plain
            versions) at smoke size: prefill and decode logits, and a
            3-step training run's losses, gradients and first update, for
            llama3.2-3b and for each family's smoke config (mamba2,
            zamba2 and phi3.5-moe in f32 with attention's plain version,
            whisper-medium and pixtral-12b in bf16 through the flash
            forward and backward);
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
            qwen1.5-0.5b (24 layers, random weights from seed 0) as 2 pods x
            1 data rank, two processes sharing the one card, 4096 tokens a
            step per pod, 3 steps with each wire codec (none, bf16, int8)
            over the hierarchical streamed psum; both pods' parameters
            bit-identical after every step, every step's chunks and wire
            bytes equal to the plan, and the kernels launched in each run
            (counts reset in each rank just before it trains); step ms,
            tokens/s per pod, sync ms, wire bytes and peak memory per rank,
            and one profiled int8 step.  The three codecs run one after the
            other through the launcher's per-rank entry
            (``launch.train.train_runs``) at the start of the 2 x 1 spawn
            that the families_train phase's families then share, as the
            zero and buckets phases' runs start its 2 x 2 spawn; the ring
            phase's run in a spawn of the launcher's own
            (``launch.train.main_runs``);
8. zero     the same launcher on 2 pods x 2 data ranks at 6 of qwen's 24
            layers (``--layers``, ZERO_LAYERS), four processes on
            the card, ZeRO-3 (parameters and moments scattered over each
            pod's data ranks, weights gathered at use, gradients
            reduce-scattered in the backward, the 1/2 shards across pods),
            one 4096-token sequence a rank, 3 steps with no codec and with
            int8; the same checks, each data index's shards bit-identical
            across pods, and the peak memory of all four ranks;
9. buckets  the zero phase's mesh with ``CommConfig.bucket_mb = 64`` (given
            to the launcher as its ``comm`` keyword): no codec runs the
            backward flush (each bucket's sync from a hook in the backward),
            its step-1 loss bit-identical to the zero phase's and steps 2-3
            within 1e-3 of it; int8 runs the tail mode, every step's
            parameter checksums equal to the zero phase's int8 run; every
            bucket's chunks and wire bytes its ``train/bkt{i}`` plan's;
            step, per-bucket sync, in-pod gather and reduce-scatter ms and
            peak memory (runs the zero phase first when it is not asked for);
10. ring    full-width qwen1.5-0.5b on 3 pods x 1 data rank (three processes
            on the card), ``algo="ring"`` with int8, ``"ring2"`` with int8
            and ``"ring"`` with no codec, 3 steps each: the three replicas
            bit-identical after every step, wire bytes the plan's (2(P-1)/P
            of the wire), quant P and dequant 2P-1 times per chunk per
            direction per step; step and sync ms, the bytes sent against
            the psum path's modeled wire, and the int8 wire blocks used.  Then quant
            and dequant against their plain versions and timed at the wire
            block shape the int8 ring run used most;
11. sites   (``CUT_SPEC``: 2 of the 24 layers, as ckpt and facade)
            ``runtime.Trainer`` driven in four spawned ranks on the card:
            qwen1.5-0.5b on 2 sites x 2 pods (``site_groups``
            from a ``core/topology.py`` Topology), 3 steps each of the
            gateway ring with int8 and the masked psum with no codec, and
            the plain 4-pod run: replicas bit-identical after every step,
            step 1's loss the plain run's bit for bit and steps 2-3 within
            1e-3, the ``/intra`` and ``/wan`` plans the host planner's, no
            WAN-stage byte from a non-gateway on the ring, quant and
            dequant as a ring of the 2 gateways needs; step, sync
            and sent bytes per rank, peak memory;
12. autotune the Trainer with ``autotune_every=2`` on 2 pods, int8, 8 steps:
            every rank on the same config at every step, at least one
            retune, replicas bit-identical, the first step of each new
            bundle kept out of the straggler detector, stream groups the
            most streams used; the retunes and each config's step ms.
13. route   the Trainer on 4 pods of the CosmoGrid topology (``core/
            topology.py``), the gradient sync over the 2-hop tokyo ->
            amsterdam -> espoo Forwarder route with int8, 3 steps, then the
            plain 4-pod int8 run: replicas bit-identical, step 1's loss the
            plain run's, the per-hop plans the host planner's, per-hop
            samples, quant and dequant once per chunk;
14. ckpt    (``CUT_SPEC``) the route run with checkpoints every 2 steps (keep 1), the
            replica shipped over the route with mpw-cp, and a fault on one
            rank at step 3: every rank restores the step-2 checkpoint
            (its checksum the saved one's), the recovered steps equal a
            fresh Trainer's replay of the same checkpoint and batches bit for
            bit, the replica's files the primary's sha256, a restore from
            the replica once the primary is gone; save, replicate and
            restore seconds and the per-hop wire bytes;
15. facade  one ``MPW`` session a rank on the 4-pod mesh: SendRecv, Cycle,
            Relay and Forward (both ways) over the tokyo -> espoo Forwarder
            of an f32 tree shaped like the parameters (``CUT_SPEC``),
            SendRecv and ISendRecv/Wait over one link, DSendRecv, Barrier,
            the int8 AllReduce against the plain sum; FileCopy of the ckpt phase's checkpoint along the route,
            failing its CRC first, then resumed; each verb's GB/s;
16. chaos   (``CUT_SPEC``, as elastic) the Trainer on the 4 CosmoGrid pods
            with the backup link, the
            amsterdam -> tokyo route, no codec: a control run and a run with
            the light path dropped at step 4 under a ``ChaosMonitor``, 8
            steps each: the timeline inject 4, detect 5, replan 5, retune 5,
            recover 7 on every rank, the detour via edinburgh, losses within
            1e-6 of the control's, replicas bit-identical, the new hops'
            plans the host planner's; then tokyo partitioned at step 7 with
            checkpoints every 5 steps and the replica over the route, the
            primary removed after 6 steps: failover restored at step 6 with
            the saved checksum on every rank;
17. elastic local SGD every 4 steps on the CosmoGrid star with a
            ``SiteMembership``, tokyo's link down for steps 6-14, 20 steps:
            the reference's ten golden rows on every rank, members
            bit-identical after every delta sync, tokyo amsterdam's after
            the catch-up, the ``{key}/delta`` plans the host planner's, the
            3-site baseline within 0.25; then ``elastic_restart`` of a 2 x 2
            ZeRO Trainer onto 1 pod x 4 data ranks, the saved parameters
            restored;
18. serve_chaos (run after the engine phase, on its weights and requests)
            the 16 requests disaggregated amsterdam -> tokyo over the
            CosmoGrid route with its backup link, the light path dropped over
            the middle requests' ships: the mono tokens bit for bit, reships
            and a reroute, every ship's per-hop wire bytes its hops' plan;
            then with no detour the engine degrades and completes them all;
19. families (run after the profile phase) mamba2-780m and zamba2-1.2b at
            published width and depth (seed-0 weights): the prefill bundle on
            8 prompts of 2048 tokens, its state landed in a 4096-token cache,
            ``Server.generate`` of 64 greedy tokens, twice (the same tokens),
            rmsnorm launched (and flash for zamba2's shared attention); every
            mamba block and shared block of the model, given its prefill
            input, decoded token by token against its prefill (64 tokens,
            5e-2), and the smoke configs' units card against CPU; then
            phi3.5-moe-42b-a6.6b at published width, 8 of its 32 layers,
            through the ServingEngine mono, disagg and disagg-int8 (8
            requests, the engine phase's checks, all four kernels; each
            request's first int8 departure from mono with mono's margin,
            the logit change and the MoE routing of that step, ROADMAP.md
            section C 17), and its smoke MoE layer
            card against CPU with tied router logits and with drops at
            capacity; then whisper-medium (24 + 24 layers, 8 requests of
            1500 source frames and 256 tokens, a 448-token cache) and
            pixtral-12b (40 layers, 8 requests of 1024 patch embeddings and
            1024 tokens, a 3072-token cache) at published width and depth:
            the prefill bundle, ``land_prefill`` and ``Server.generate`` of
            64 greedy tokens from the prefix and prompt's end, twice (the
            same tokens), the flash and rmsnorm launches the path's count;
            the whole model in f32 on the card (pixtral at 16 of 40
            layers), a prefill against a prefill of all but the last 16
            prompt tokens and 16 decode steps, within 1e-2 relative L2; the
            smoke config's prefill logits card against CPU within 5e-2.
            Tokens/s, encoder and prefill ms, decode ms per token, peak
            memory and launches per arch;
20. families_train (run after families) ``build_train_step`` on 2 pods x
            1 data rank, two processes sharing the card, every family in
            turn in one spawn (after the train phase's runs; the spawn's
            allocator has expandable segments) at published width (FAMILY_TRAIN_RUNS; depths
            from tools/train_family_memory.py): mamba2-780m, zamba2-1.2b
            and phi3.5-moe (4096 tokens a pod), whisper-medium (8 x 448
            tokens over 8 x 1500 frames a pod, with no codec and with
            int8), pixtral-12b (1024 patches and 3072 tokens a pod), 3
            steps each over the hierarchical psum; then whisper-medium on
            2 x 2 ZeRO-3 (four processes).  Finite losses and grad norms
            (the MoE aux loss above 0), the pods bit-identical after every
            step (under ZeRO each data index's shards), chunks and wire
            bytes the plan's, rmsnorm and the flash forward and backward
            launched at the path's count every step
            (``family_train_launches``); step, sync ms, tokens/s per pod,
            wire bytes and peak memory per rank.
21. tp     (run after the 2-pod spawns) tensor and expert parallelism on the
            model axis: qwen1.5-0.5b through the launcher's ``--model 2`` on
            2 pods x 1 data rank x 2 model ranks (four processes, in the
            2 x 2 spawn after the zero and buckets runs) at 24 layers on the
            train phase's batch, 3 steps with no codec and with int8:
            losses equal on every rank and step 1's within 5e-3 of the train
            phase's no-codec 2 x 1 run's (queued when only tp is asked),
            each model index's parameters bit-identical across pods,
            every step's chunks the plan's and the model ranks' bytes the
            plan's plus the replicated leaves' once more, the kernels'
            launches the path's; then one spawn of 1 x 1 x 2: llama3.2-3b
            at 28 layers and phi3.5-moe at 8 of 32 (its prefill through
            ``moe_ep``, its decode through the expert-sharded fallback)
            serving 8 prompts of 1024 tokens and 64 greedy tokens through
            ``Server.generate`` (prefill, decode ms a token, tokens/s, the
            model group's all-reduce and all-to-all ms, launches, peak
            memory), the share of tokens equal to one rank's with the
            margins where they depart (phi's also against one rank routing
            each half of a prompt with its own capacity, as ``moe_ep``
            does), the f32 decode and the f32 prefill against one rank's
            within 1e-2 relative L2 (phi's prefill at the path's 8 x 1024
            tokens against that local-capacity run, each side's dropped
            pairs beside); and phi3.5-moe's training step at 3 of 32
            layers (3 steps, 4096 tokens).

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12            # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_BF16 = 989e12           # dense bf16 tensor-core rate
PEAK_F32 = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 << 20
PHASES = ("env", "build", "kernels", "small", "engine", "serve_chaos", "profile",
          "families", "families_train", "train", "zero", "buckets", "tp", "ring", "sites",
          "autotune", "route", "ckpt", "facade", "chaos", "elastic")
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
    # in prefill, slots in decode (llama3.2-3b, d 3072; phi3.5-moe, d 4096),
    # tokens of a training step (qwen1.5-0.5b, d 1024), of a B8 S2048 prefill
    # (mamba2-780m, d 1536; zamba2-1.2b, d 2048), pixtral-12b's B8 prefill of
    # 1024 patches and 1024 tokens and its decode (d 5120: the row path's
    # 20-step instance), whisper-medium's encoder over 8 x 1500 frames
    # (d 1024).  Tolerance: one bf16 ulp.
    for R, d, on in ((1024, 3072, "serving"), (8, 3072, "serving"),
                     (4096, 1024, "train"), (16384, 1536, "families"),
                     (16384, 2048, "families"), (1024, 4096, "families"),
                     (8, 4096, "families"), (16384, 5120, "families"),
                     (8, 5120, "families"), (12000, 1024, "families")):
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
    # ragged length, a query suffix, head dim 64 with a window,
    # h2o-danube-3-4b's full width (32 q heads over 8, head dim 120), with
    # and without a window, qwen1.5-0.5b's training step, zamba2-1.2b's
    # prefill, phi3.5-moe's longest engine prompt (32 over 8, head dim 128)
    # and pixtral-12b's prefill of 1024 patches and 1024 tokens; then the
    # non-causal branch: whisper-medium's encoder (B8 over 1500 frames, 16
    # heads of 64) and its prefill's cross-attention (256 tokens to 1500
    # frames), with its causal decoder self-attention at S 256 beside them,
    # a query block shorter than one 64-row tile, a last key tile of one
    # key (Sk 65), and GQA with Sq != Sk.
    # Tolerance: 2e-2 (bf16 output, P rounded to bf16, sums in another order).
    from torch.nn.attention.bias import causal_lower_right

    def sdpa(q, k, v, window=None, causal=True):
        """SDPA with queries aligned to the end of the keys (causal), or
        not causal; a window as a dense boolean mask, with enable_gqa only
        where the heads differ (SDPA's memory-efficient backend takes a mask
        but no GQA)."""
        Sq, Sk = q.shape[1], k.shape[1]
        if not causal:
            mask = dict(is_causal=False, enable_gqa=True)
        elif window is not None:
            mask = dict(attn_mask=window_mask(torch, dev, Sq, Sk, window),
                        enable_gqa=q.shape[2] != k.shape[2])
        elif Sq == Sk:
            mask = dict(is_causal=True, enable_gqa=True)
        else:
            mask = dict(attn_mask=causal_lower_right(Sq, Sk), enable_gqa=True)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **mask).transpose(1, 2)

    cases = [(1, 1024, 1024, 24, 8, 128, None, True, "serving"),
             (1, 777, 777, 24, 8, 128, None, True, "serving"),
             (1, 128, 1024, 24, 8, 128, None, True, "serving"),
             (2, 512, 512, 8, 2, 64, 256, True, "serving"),
             (1, 512, 512, 24, 8, 128, None, True, "serving"),
             (1, 128, 128, 24, 8, 128, None, True, "serving"),
             (1, 1024, 1024, 32, 8, 120, None, True, "serving"),
             (1, 1024, 1024, 32, 8, 120, 256, True, "serving"),
             (1, 4096, 4096, 16, 16, 64, None, True, "train"),
             (8, 2048, 2048, 32, 32, 64, None, True, "families"),
             (1, 1024, 1024, 32, 8, 128, None, True, "families"),
             (8, 2048, 2048, 32, 8, 128, None, True, "families"),
             (8, 1500, 1500, 16, 16, 64, None, False, "families"),
             (8, 256, 1500, 16, 16, 64, None, False, "families"),
             (8, 256, 256, 16, 16, 64, None, True, "families"),
             (2, 20, 1500, 16, 16, 64, None, False, "check"),
             (2, 100, 65, 16, 16, 64, None, False, "check"),
             (2, 200, 1500, 32, 8, 128, None, False, "check"),
             # the tp phase's rank-local shapes (2 model ranks): llama3.2-3b's
             # prefill (12 of 24 q heads over 4 of 8), qwen1.5-0.5b's and
             # phi3.5-moe's training steps (8 of 16 over 8; 16 of 32 over 4)
             (8, 1024, 1024, 12, 4, 128, None, True, "tp"),
             (1, 4096, 4096, 8, 8, 64, None, True, "tp"),
             (1, 4096, 4096, 16, 4, 128, None, True, "tp")]
    for B, Sq, Sk, H, KH, D, window, causal, on in cases:
        pairs = causal_pairs(torch, dev, Sq, Sk, window) if causal else Sq * Sk
        nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KH * D)
        k = sets_for(nbytes)
        qkv = [(rnd(B, Sq, H, D), rnd(B, Sk, KH, D), rnd(B, Sk, KH, D))
               for _ in range(k)]
        got = fa.flash_attention_bshd(*qkv[0], causal=causal, window=window)
        want = ref.flash_attention_ref(*qkv[0], causal=causal, window=window)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all()),
              f"flash {(B, Sq, Sk, H, KH, D, window, causal)} max err {err}")
        e = {"on_path": on,
             "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KH": KH, "D": D,
                       "causal": causal, "window": window},
             "max_abs_err": err,
             "ms": cuda_ms(torch, lambda i: fa.flash_attention_bshd(
                 *qkv[i], causal=causal, window=window), k, 50),
             "plain_ms": cuda_ms(torch, lambda i: ref.flash_attention_ref(
                 *qkv[i], causal=causal, window=window), k, 5)}
        e["library_ms"] = cuda_ms(torch, lambda i: sdpa(*qkv[i], window, causal), k, 50)
        e["library_max_abs_err"] = float(
            (sdpa(*qkv[0], window, causal).float() - want.float()).abs().max())
        e["bound_ms"], e["bound_by"] = bound(nbytes, 4 * D * H * B * pairs, PEAK_BF16)
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        rows.setdefault("flash_attention", []).append(e)
        del qkv, got, want, diff
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


# the flash backward's cases: (B, Sq, Sk, H, KH, D, window, causal, path)
FLASH_BWD_CASES = [
    (1, 4096, 4096, 16, 16, 64, None, True, "train"),
    (1, 4096, 4096, 16, 16, 64, 1024, True, "shape of another model"),
    (1, 1024, 1024, 24, 8, 128, None, True, "shape of another model"),
    (1, 1024, 1024, 24, 8, 128, 256, True, "shape of another model"),
    (1, 1024, 1024, 32, 8, 120, None, True, "shape of another model"),
    (1, 1024, 1024, 32, 8, 120, 256, True, "shape of another model"),
    # the families' training steps (families_train): whisper-medium's
    # encoder (not causal, 1500 frames: a last key tile of 28), its
    # decoder's cross-attention (448 tokens to 1500 frames, not causal) and
    # causal self-attention, zamba2-1.2b's shared block, phi3.5-moe's and
    # pixtral-12b's attention (32 over 8 heads of 128; pixtral's 1024
    # patches and 3072 tokens), and a query block under one 64-row tile
    (8, 1500, 1500, 16, 16, 64, None, False, "families_train"),
    (8, 448, 1500, 16, 16, 64, None, False, "families_train"),
    (8, 448, 448, 16, 16, 64, None, True, "families_train"),
    (1, 4096, 4096, 32, 32, 64, None, True, "families_train"),
    (1, 4096, 4096, 32, 8, 128, None, True, "families_train"),
    (2, 40, 333, 16, 16, 64, None, False, "check"),
    # the tp phase's rank-local training shapes: qwen1.5-0.5b's 8 of 16
    # heads, phi3.5-moe's 16 of 32 over 4 of 8
    (1, 4096, 4096, 8, 8, 64, None, True, "tp"),
    (1, 4096, 4096, 16, 4, 128, None, True, "tp"),
]


def phase_kernels_flash_bwd(torch, dev, rnd) -> list:
    """The flash backward against autograd through the plain version, at
    FLASH_BWD_CASES: qwen1.5-0.5b's training shape (16 heads, head dim 64,
    4096 tokens, the train phase's), llama3.2-3b (24 over 8, 128) and
    h2o-danube-3-4b (32 over 8, 120) at 1024 tokens, each causal and with a
    window; the families' training shapes, whisper-medium's not causal with
    Sq != Sk among them; a not-causal query block under 64 rows.
    Tolerance: each gradient elementwise within 2 % of its largest entry
    plus 2 % of the entry (bf16 output, P and dS rounded to bf16 before the
    products, delta from the bf16 output, sums in another order).  Bound:
    five products of 2·D operations per visible (query, key) pair at the
    bf16 peak, against the bytes of q, k, v, o, dO, lse read once and dq,
    dk, dv written once.  Library: SDPA forward + backward minus SDPA
    forward, at the same shape (``is_causal`` as the case has it,
    ``enable_gqa``); a window as a dense boolean mask.  Parts: each of the
    backward's three kernels' device time from torch.profiler over
    back-to-back calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    F = torch.nn.functional

    def plain_grads(q, k, v, do, window, causal):
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = ref.flash_attention_ref(qs, ks, vs, causal=causal, window=window)
        return torch.autograd.grad(o, (qs, ks, vs), do)

    out = []
    for B, Sq, Sk, H, KH, D, window, causal, on in FLASH_BWD_CASES:
        pairs = causal_pairs(torch, dev, Sq, Sk, window) if causal else Sq * Sk
        nbytes = 2 * 4 * (B * Sq * H * D + B * Sk * KH * D) + 4 * B * H * Sq
        k_sets = sets_for(nbytes)
        sets = []
        for _ in range(k_sets):
            q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KH, D), rnd(B, Sk, KH, D)
            do = rnd(B, Sq, H, D)
            o, lse = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            sets.append((q, k, v, o, lse, do))
        got = fa.flash_attention_bwd_bshd(*sets[0], causal=causal, window=window)
        q, k, v, _, _, do = sets[0]
        want = plain_grads(q, k, v, do, window, causal)
        case = (B, Sq, Sk, H, KH, D, window, causal)
        err, rel = 0.0, 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            d = (g.float() - w.float()).abs()
            top = float(w.float().abs().max())
            check(bool(torch.isfinite(g).all()), f"flash bwd {case} {name} finite")
            check(bool((d <= 2e-2 * top + 2e-2 * w.float().abs()).all()),
                  f"flash bwd {case} {name}: max err "
                  f"{float(d.max())} against largest entry {top}")
            err, rel = max(err, float(d.max())), max(rel, float(d.max()) / top)
        del got, want
        e = {"on_path": on,
             "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KH": KH, "D": D,
                       "causal": causal, "window": window},
             "max_abs_err": err, "max_err_over_largest": rel,
             "ms": cuda_ms(torch, lambda i: fa.flash_attention_bwd_bshd(
                 *sets[i], causal=causal, window=window), k_sets, 20),
             "plain_ms": cuda_ms(torch, lambda i: plain_grads(
                 *[sets[i][j] for j in (0, 1, 2, 5)], window, causal), k_sets, 3)}
        mask = None if window is None else window_mask(torch, dev, Sq, Sk, window)
        t_fb, t_f = sdpa_bwd_ms(torch, F, sets, k_sets, mask, causal)
        e["library_ms"] = t_fb - t_f
        e["library_fwd_bwd_ms"], e["library_fwd_ms"] = t_fb, t_f
        e["parts_ms"] = bwd_parts_ms(torch, lambda i: fa.flash_attention_bwd_bshd(
            *sets[i], causal=causal, window=window), k_sets, 20)
        e["resources"] = fa.bwd_resources(D)
        e["bound_ms"], e["bound_by"] = bound(nbytes, 2.5 * 4 * D * H * B * pairs,
                                             PEAK_BF16)
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        out.append(e)
        del sets
        torch.cuda.empty_cache()
    return out


def sdpa_bwd_ms(torch, F, sets, n_sets: int, mask, causal: bool = True):
    """(forward + backward ms, forward ms) of SDPA on the inputs of `sets`:
    causal (``is_causal``) or not, or with the dense boolean `mask`
    (enable_gqa only where the heads differ, as in `phase_kernels`'
    forward)."""
    lib = []
    for q, k, v, _, _, do in sets:
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib.append((qg, kg, vg, do.transpose(1, 2)))
    kw = dict(is_causal=causal, enable_gqa=True) if mask is None else dict(
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
            "train_step": phase_small_train(torch, dev, cfg, model, p_cpu),
            "train_families": phase_small_train_families(torch, dev)}


# leaves whose gradients the small phase compares
GRAD_LEAVES = (("embed",), ("blocks", "attn", "wq"), ("blocks", "attn", "wo"),
               ("blocks", "ffn", "down"), ("blocks", "ln1"), ("ln_f",))
_SSM_LEAVES = (("embed",), ("blocks", "w_x"), ("blocks", "w_B"), ("blocks", "w_out"),
               ("blocks", "A"), ("blocks", "ln"), ("ln_f",))
# the other families' smoke training runs: (arch, parameter dtype, leaves,
# kernels the card's run must launch).  The ssm, hybrid and moe families run
# in f32 with attention's plain version (the flash kernel takes bf16 only):
# in bf16 their gradients are rounding-dominated (the ssm blocks' pre-norm
# amplifies the embeddings ~50x a layer, the MoE router flips experts at
# near ties), so two correct runs that round at other places disagree far
# beyond the bounds; tests/test_torch_train_families_pods.py measures it
# against the JAX package.  The audio and vlm families run in bf16 through
# the flash forward and backward (whisper's encoder and cross-attention not
# causal, Sq != Sk).
SMALL_TRAIN_FAMILIES = (
    ("mamba2-780m", "float32", _SSM_LEAVES, ("rmsnorm",)),
    ("zamba2-1.2b", "float32", _SSM_LEAVES + (("shared", "attn", "wq"),
                                              ("shared", "ffn", "down")), ("rmsnorm",)),
    ("phi3.5-moe-42b-a6.6b", "float32",
     (("embed",), ("blocks", "attn", "wq"), ("blocks", "ffn", "router"),
      ("blocks", "ffn", "down"), ("blocks", "ln1"), ("ln_f",)), ("rmsnorm",)),
    ("whisper-medium", "bfloat16",
     GRAD_LEAVES + (("blocks", "xattn", "wk"), ("encoder", "attn", "wq"),
                    ("encoder", "ffn", "down")),
     ("flash_attention", "flash_attention_bwd", "rmsnorm")),
    ("pixtral-12b", "bfloat16", GRAD_LEAVES,
     ("flash_attention", "flash_attention_bwd", "rmsnorm")),
)


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


def phase_small_train(torch, dev, cfg, model, p_cpu, leaves=GRAD_LEAVES,
                      expect=("flash_attention", "flash_attention_bwd", "rmsnorm"),
                      plain_attn: bool = False) -> dict:
    """One smoke-size training run (1 pod, 3 steps) on the card against the
    same run on the CPU, from the same parameters and tokens (and the
    family's stub inputs, seeded, in the parameters' dtype).  `leaves`: the
    leaves compared; `expect`: the kernels the card's run must launch;
    `plain_attn`: attention's plain version on the card (f32 runs).

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
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 4, 65))
    stub_np = {}
    if cfg.vision_tokens:
        stub_np["patch_embeds"] = rng.standard_normal((3, 4, cfg.vision_tokens, cfg.d_model))
    if cfg.encoder_layers:
        stub_np["source_frames"] = rng.standard_normal((3, 4, cfg.source_len, cfg.d_model))
    dtype = p_cpu["embed"].dtype

    def batch_of(i, d):
        return {"tokens": torch.as_tensor(toks[i], device=d),
                **{k: torch.as_tensor(v[i], dtype=torch.float32).to(d, dtype)
                   for k, v in stub_np.items()}}

    def pick(tree):
        out = []
        for keys in leaves:
            t = tree
            for k in keys:
                t = t[k]
            out.append(t.detach().cpu())
        return out

    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        params = _to(p_cpu, d)
        p_leaves, td = flatten(params)
        ps = [p.detach().requires_grad_(True) for p in p_leaves]
        with plain_attention() if plain_attn else contextlib.nullcontext():
            loss, _ = model.loss(unflatten(td, ps), batch_of(0, d))
            grads = unflatten(td, list(torch.autograd.grad(loss, ps)))
            b = build_train_step(rc, make_local_mesh(pod=1, device=d))
            state = {"params": params, "opt": init_opt_state(params)}
            ops.reset_launch_counts()
            losses = []
            for i in range(3):
                state, m = b.fn(state, batch_of(i, d))
                losses.append(float(m["loss"]))
                if i == 1:
                    after = pick(state["params"])
        res[name] = {"losses": losses, "grads": [g.float() for g in pick(grads)],
                     "params": after, "launches": ops.launch_counts()}
    g, c = res["gpu"], res["cpu"]
    lg = g["launches"]
    check(all(lg[k] > 0 for k in expect),
          f"{cfg.name}: small train step launched the kernels {expect}: {lg}")
    loss_err = max(abs(a - b) for a, b in zip(g["losses"], c["losses"]))
    check(all(math.isfinite(x) for x in g["losses"]) and loss_err <= 2e-2,
          f"{cfg.name}: small train step losses {g['losses']} vs CPU {c['losses']}")
    errs = {}
    for keys, a, b in zip(leaves, g["grads"], c["grads"]):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(e <= 5e-2, f"{cfg.name}: small train grad {'/'.join(keys)}: {e}")
        errs["grad/" + "/".join(keys)] = e
    p0 = pick(p_cpu)
    for keys, a, b, x0 in zip(leaves, g["params"], c["params"], p0):
        name = "/".join(keys)
        diff = (a.float() - b.float()).abs()
        limit = ADAM_STEP2_SPREAD * tc.lr + _ulp(torch, torch.maximum(a.abs(), b.abs()))
        worst = float((diff / limit).max())
        check(worst <= 1.0, f"{cfg.name}: small train param {name} after the first "
              f"update: |card - CPU| reaches {worst} of its limit")
        moved = float((b.float() - x0.float()).abs().mean())
        share = (float(diff.mean()) / moved if moved > 0
                 else 0.0 if float(diff.max()) == 0 else math.inf)
        check(share <= UPDATE_SHARE, f"{cfg.name}: small train param {name} after "
              f"the first update: mean |card - CPU| is {share} of the update's mean size")
        errs["param/" + name] = {"worst_over_limit": worst, "share_of_update": share,
                                 "update_mean_abs": moved}
    return {"config": cfg.name, "dtype": str(dtype).removeprefix("torch."),
            "losses_gpu": g["losses"], "losses_cpu": c["losses"],
            "loss_max_abs_err": loss_err, "errors": errs,
            "launches_gpu": lg,
            "tolerance": {"loss": 2e-2, "grad": 5e-2,
                          "param": f"{ADAM_STEP2_SPREAD} * lr + 1 ulp per element; "
                                   f"mean {UPDATE_SHARE} of the update per leaf"}}


def phase_small_train_families(torch, dev) -> dict:
    """:func:`phase_small_train` for each of SMALL_TRAIN_FAMILIES' smoke
    configs, at the dense run's tolerances: parameters from seed 0 in the
    family's dtype (f32 draws cast)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    out = {}
    for arch, dtype, leaves, expect in SMALL_TRAIN_FAMILIES:
        cfg = smoke_config(get_config(arch))
        model = build_model(cfg)
        p_cpu = tree_init(model.param_defs(), 0, device="cpu")
        if dtype == "float32":
            p_cpu = tree_map(lambda t: t.float(), p_cpu)
        out[arch] = phase_small_train(torch, dev, cfg, model, p_cpu, leaves, expect,
                                      plain_attn=dtype == "float32")
    return out


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


def phase_engine(torch, dev, cfg, params, n_requests: int = 16,
                 phase: str = "engine", trace: bool = False) -> tuple:
    """`cfg` with `params` serving `n_requests` seeded requests (prompts
    128-1024, 16-64 new tokens) on 8 slots of a 2048-token cache through the
    ServingEngine, mono, disagg with no codec and disagg-int8; each run's
    checks, and mono against disagg with no codec bit for bit.  With
    `trace` the mono and disagg-int8 runs are recorded (:class:`_EngineTrace`)
    and each request's first departure of int8 from mono is measured
    (:func:`int8_departures`)."""
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
    for _ in range(n_requests):
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
        tr = _EngineTrace(torch, eng) if trace and label != "disagg" else None
        for prompt, mnew in reqs:
            check(eng.submit(prompt, mnew) is not None, "request admitted")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if tr is not None:
            tr.close()
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
            "results": dict(eng.results), "launches": launches, "trace": tr,
            "timeline": eng.batcher.timeline(),
            "summary": {
                "wall_s": wall, "tokens": total_tokens, "tokens_per_s": total_tokens / wall,
                "mean_prefill_ms": 1e3 * float(np.mean(eng.timings["prefill_s"])),
                "mean_ship_ms": 1e3 * float(np.mean(eng.timings["ship_s"])),
                "p50_decode_step_ms": 1e3 * dec[len(dec) // 2],
                "decode_steps": len(dec), "launches": launches,
                "wire_bytes_equal_plan": wire_ok,
                "modeled_ttft_p50_s": stats["ttft_p50_s"],
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
        emit({"phase": phase, "arch": cfg.name, "run": label, **runs[label]["summary"]})
        del eng
        torch.cuda.empty_cache()
    mono, q8 = runs["mono"]["results"], runs["disagg_int8"]["results"]
    for rid in mono:
        check(np.array_equal(mono[rid], runs["disagg"]["results"][rid]),
              f"req{rid}: mono and disagg tokens bit-identical")
    l8 = runs["disagg_int8"]["launches"]
    check(all(l8[k] > 0 for k in SERVING_KERNELS),
          f"int8 run launched every serving kernel: {l8}")
    agree = float(np.mean([np.mean(mono[r] == q8[r]) for r in mono]))
    ctx = {"reqs": reqs, "rc": rc, "mono_results": mono,
           "mono_timeline": runs["mono"]["timeline"]}
    out = {"arch": cfg.name,
           "params": int(sum(p.numel() for p in _leaves(params))),
           "requests": len(reqs),
           "mono_disagg_bit_identical": True,
           "int8_token_agreement_with_mono": agree,
           "launches": runs["disagg_int8"]["launches"],
           "summaries": {k: r["summary"] for k, r in runs.items()}}
    if trace:
        out["int8_departures"] = int8_departures(runs["mono"]["trace"],
                                                 runs["disagg_int8"]["trace"], mono, q8)
    return out, ctx


class _EngineTrace:
    """A ServingEngine's decode steps, recorded while it runs: each
    decoding request's f32 logits on the host, keyed by (rid, index of the
    token the step chose), and for the MoE family every layer's expert ids
    and kept assignments of the whole batch (``models.moe.slots`` wrapped),
    with the requests the step decoded.  :meth:`close` unwraps both, so
    that nothing holds the engine (and its parameters) once it is gone."""

    def __init__(self, torch, eng):
        from repro_torch.models import moe
        real_slots = moe.slots
        self.logits, self.step_of, self.steps = {}, {}, []
        calls = []

        def slots(ids, E, C):
            pos, keep = real_slots(ids, E, C)
            calls.append((ids, keep.reshape(ids.shape)))
            return pos, keep

        fn = eng.server.bundle.fn

        def step(params, cache, pos, tok):
            calls.clear()
            logits, cache = fn(params, cache, pos, tok)
            lg = logits[:, -1].float().cpu().numpy()
            route = None
            if calls:           # (layers, slots, top_k) each
                route = (torch.stack([c[0] for c in calls]).cpu().numpy(),
                         torch.stack([c[1] for c in calls]).cpu().numpy())
            members = {rid: (slot, len(eng._outputs[rid]))
                       for slot, rid in eng._decoding.items()}
            for rid, (slot, t) in members.items():
                self.logits[(rid, t)] = lg[slot]
                self.step_of[(rid, t)] = (len(self.steps), slot)
            self.steps.append((members, route))
            return logits, cache

        self._restore = [(moe, "slots", real_slots), (eng.server.bundle, "fn", fn)]
        moe.slots = slots
        eng.server.bundle.fn = step

    def close(self) -> None:
        for obj, name, real in self._restore:
            setattr(obj, name, real)
        self._restore = []


def int8_departures(mono: _EngineTrace, q8: _EngineTrace, mono_res: dict,
                    q8_res: dict) -> dict:
    """Each request's first token where the disagg-int8 run departs from
    mono, read from the two runs' traces (the same schedule: the same
    requests decode in the same slots at the same steps): mono's top-1 minus
    top-2 logit there; the largest change of that step's logits between the
    runs; whether the step's routing (every layer's expert ids and kept
    assignments, all slots) differs between the runs, from which layer,
    and whether this request's own assignments differ or were dropped at
    capacity; and which other requests of the batch had departed already
    (their tokens, hence their rows, differ).  Beside them, the int8 KV's
    own effect: the largest logit change at the steps before any departure
    where the routing is the same and no request of the batch has departed.
    A departure is "routing" where the routing differs, "near_tie" where it
    does not and mono's margin is within that own effect, else
    "unexplained"."""
    import numpy as np
    first = {}
    for rid, m in mono_res.items():
        d = np.flatnonzero(m != q8_res[rid])
        first[rid] = int(d[0]) if d.size else None

    def departed(members, rid, t) -> list:
        return sorted(r for r, (_, tt) in members.items()
                      if r != rid and first[r] is not None and first[r] < tt)

    def same_route(a, b) -> bool:
        if a is None or b is None:
            return a is b
        return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))

    own = []
    for key, lm in mono.logits.items():
        rid, t = key
        if key not in q8.logits or (first[rid] is not None and t >= first[rid]):
            continue
        (sm, _), (sq, _) = mono.step_of[key], q8.step_of[key]
        (mem, rm), (_, rq) = mono.steps[sm], q8.steps[sq]
        if same_route(rm, rq) and not departed(mem, rid, t):
            own.append(float(np.abs(q8.logits[key] - lm).max()))
    own_max = max(own) if own else 0.0
    rows = []
    for rid, t in sorted(first.items()):
        if t is None:
            continue
        key = (rid, t)
        lm, lq = mono.logits[key], q8.logits[key]
        top = np.sort(lm)
        (sm, slot), (sq, _) = mono.step_of[key], q8.step_of[key]
        (mem, rm), (_, rq) = mono.steps[sm], q8.steps[sq]
        row = {"rid": rid, "token": t, "of": int(len(mono_res[rid])),
               "step": sm, "slot": slot,
               "mono_margin": float(top[-1] - top[-2]),
               "max_logit_change": float(np.abs(lq - lm).max()),
               "others_departed": departed(mem, rid, t)}
        if rm is not None:
            diff_l = [int(i) for i in range(rm[0].shape[0])
                      if not (np.array_equal(rm[0][i], rq[0][i])
                              and np.array_equal(rm[1][i], rq[1][i]))]
            row.update(
                routing_differs=bool(diff_l),
                first_layer_routing_differs=diff_l[0] if diff_l else None,
                own_routing_differs=not (np.array_equal(rm[0][:, slot], rq[0][:, slot])
                                         and np.array_equal(rm[1][:, slot], rq[1][:, slot])),
                own_dropped_mono=int((~rm[1][:, slot]).sum()),
                own_dropped_int8=int((~rq[1][:, slot]).sum()),
                batch_dropped_mono=int((~rm[1]).sum()),
                batch_assignments=int(rm[1].size))
        else:
            row["routing_differs"] = False
        if row["routing_differs"]:
            row["kind"] = "routing"
        elif not row["others_departed"] and row["mono_margin"] <= own_max:
            row["kind"] = "near_tie"
        else:
            row["kind"] = "unexplained"
        rows.append(row)
    routes = [r for _, r in mono.steps if r is not None]
    kinds = [r["kind"] for r in rows]
    return {"departures": rows,
            "requests_departing": len(rows), "requests": len(first),
            "by_kind": {k: kinds.count(k) for k in ("routing", "near_tie", "unexplained")},
            "int8_own_max_logit_change": own_max,
            "int8_own_positions": len(own),
            "mono_decode_steps_with_a_drop": (
                sum(bool((~r[1]).any()) for r in routes) / len(routes) if routes else None),
            "mono_dropped_share": (
                float(np.mean([float((~r[1]).mean()) for r in routes])) if routes else None)}


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
# phase 7: full-width training across pods on the one card
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--global-batch", "2",
              "--steps", "3", "--pods", "2", "--mode", "hierarchical",
              "--check-replicas"]
PROFILE_STEP = 3     # the int8 run takes a fourth step, under the profiler
# 2 pods x 2 data ranks, ZeRO-3 (zero1 is on by default): one sequence a rank.
# The zero and buckets phases run 6 of qwen's 24 layers (published widths;
# 232,684,544 parameters, the embedding whole): at 24 the script took
# 1095.3 s, over its 1020 s budget (PERF.md section 4); 64 MB buckets still
# cut the layers into 3 buckets and a rest
ZERO_LAYERS = 6
ZERO_ARGS = ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--global-batch", "4",
             "--steps", "3", "--pods", "2", "--ranks", "4", "--mode", "hierarchical",
             "--check-replicas", "--layers", str(ZERO_LAYERS)]
ZERO_CODECS = ("none", "int8")
BUCKET_MB = 64.0     # a point of the reference's BUCKET_GRID_MB
FLUSH_LOSS_TOL = 1e-3
# 3 pods x 1 data rank: one sequence a pod
RING_ARGS = ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--global-batch", "3",
             "--steps", "3", "--pods", "3", "--mode", "hierarchical",
             "--check-replicas"]
RING_RUNS = (("ring", "int8"), ("ring2", "int8"), ("ring", "none"))


def ring_calls(sizes: list, world: int, algo: str) -> tuple[int, dict]:
    """(directions, {(rows, padded extent, block): quant calls}) of one
    step's ring over chunks of [extent, f32 bytes]: ring2 halves a chunk of
    extent >= 2 into two directions; each direction pads its extent to a
    multiple of the world, and quantizes `world` segments of it, each moved
    last and padded to its wire block min(256, m)."""
    dirs, calls = 0, {}
    for n, nbytes in sizes:
        rows = nbytes // 4 // max(n, 1)
        parts = [n // 2, n - n // 2] if algo == "ring2" and n >= 2 else [n]
        for e in parts:
            dirs += 1
            m = (e + (-e) % world) // world
            block = max(1, min(256, m))
            key = (rows, m + (-m) % block, block)
            calls[key] = calls.get(key, 0) + world
    return dirs, calls


def _launcher_argv(runs: list, out_dir: str) -> list:
    """(argv, comm) of each of `runs`, ``(codec, argv, label, comm)`` (`comm`:
    the launcher's CommConfig keyword), with the codec and the report path
    (``{out_dir}/{label}_{codec}``) added."""
    return [(argv + ["--compress", codec, "--report",
                     os.path.join(out_dir, f"{label}_{codec}")], comm)
            for codec, argv, label, comm in runs]


def _checked_runs(runs: list, out_dir: str) -> list:
    """The numbers of each of `runs` (see :func:`_launcher_argv`), its
    reports checked by :func:`_check_run`."""
    return [_check_run(codec, os.path.join(out_dir, f"{label}_{codec}"), label)
            for codec, _, label, _ in runs]


def _train_runs(runs: list, out_dir: str) -> tuple[list, float]:
    """``launch.train.main_runs`` of `runs` in one spawn of the ranks, then
    :func:`_checked_runs`.  Returns the runs' numbers and the spawn's wall
    seconds."""
    from repro_torch.launch import train as launcher
    t0 = time.perf_counter()
    launcher.main_runs(_launcher_argv(runs, out_dir))
    wall = time.perf_counter() - t0
    return _checked_runs(runs, out_dir), wall


def _check_run(codec: str, rep: str, label: str) -> dict:
    """Check one launcher run's reports (rank r's at ``{rep}.rank{r}.json``)
    and return the run's numbers.
    Checks: each rank noted the plan (and each bucket's); the flash forward
    and backward and rmsnorm launched on every rank; with int8, quant and
    dequant once per chunk per step on the gather path, and on a ring P and
    2P-1 times per chunk per direction, never without int8; every step's
    loss finite and its chunks, payload and wire bytes the plan's (each
    bucket's the bucket's plan's); the replicas' checksums equal after every
    step (the launcher's ``--check-replicas`` fails first if they differ):
    every rank's without ZeRO, under ZeRO the pods' shards of each data
    index (and the data indices' shards differ)."""
    import numpy as np
    n = json.load(open(f"{rep}.rank0.json"))["ranks"]
    reps = [json.load(open(f"{rep}.rank{r}.json")) for r in range(n)]
    r0 = reps[0]
    plan, bplans = r0["plan"], r0["bucket_plans"]
    algo, pods = r0["algo"], r0["pods"]
    # a bucketed step sends the buckets' chunks: a slice of a stacked leaf
    # is cut as its whole leaf is along the scatter dim
    step_chunks = sum(b["n_chunks"] for b in bplans) if bplans else plan["n_chunks"]
    step_wire = sum(b["wire_bytes"] for b in bplans) if bplans else plan["wire_bytes"]
    tag = f"{label} {codec}"
    if algo != "psum":
        factor = {"none": 1.0, "bf16": 0.5, "int8": 0.25}[codec]
        check(plan["wire_bytes"] == round(2 * (pods - 1) / pods * factor
                                          * plan["payload_bytes"]),
              f"{tag}: the {algo} plan's wire is 2(P-1)/P of the codec's bytes")
    for r, rp in enumerate(reps):
        check(rp["plan"] == plan and rp["bucket_plans"] == bplans,
              f"{tag}: rank {r} noted the same plans")
        la = rp["launches"]
        check(la["flash_attention"] > 0 and la["flash_attention_bwd"] > 0
              and la["rmsnorm"] > 0, f"{tag} rank {r}: kernels launched {la}")
        want_q = want_dq = 0
        if codec == "int8":
            for h in rp["history"]:
                if algo == "psum":
                    want_q += h["n_chunks"]
                    want_dq += h["n_chunks"]
                else:
                    dirs = ring_calls(h["chunk_sizes"], pods, algo)[0]
                    want_q += pods * dirs
                    want_dq += (2 * pods - 1) * dirs
        check(la["quant_int8"] == want_q and la["dequant_int8"] == want_dq,
              f"{tag} rank {r}: quant {want_q} and dequant {want_dq} launches "
              f"expected, got {la}")
        for h in rp["history"]:
            check(math.isfinite(h["loss"]), f"{tag} rank {r}: finite loss {h}")
            check(h["n_chunks"] == step_chunks
                  and h["payload_bytes"] == plan["payload_bytes"]
                  and round(h["wire_bytes"]) == step_wire,
                  f"{tag} rank {r} step {h['step']}: chunks {h['n_chunks']}, "
                  f"payload {h['payload_bytes']}, wire {h['wire_bytes']} "
                  f"against the plan {plan} and buckets {bplans}")
            check(h["n_buckets"] == len(bplans),
                  f"{tag} rank {r}: {h['n_buckets']} buckets, plan {len(bplans)}")
            for b, bp in zip(h["buckets"], bplans):
                check(b["n_chunks"] == bp["n_chunks"]
                      and round(b["wire_bytes"]) == bp["wire_bytes"]
                      and b["payload_bytes"] == bp["payload_bytes"],
                      f"{tag} rank {r} step {h['step']} bucket {b['index']}: "
                      f"{b} against its plan {bp}")
    sums = {(rp["pod_index"], rp["data_index"]): [h["checksum"] for h in rp["history"]]
            for rp in reps}
    data = r0["data"]
    check(r0["zero"] == (data > 1), f"{tag}: ZeRO on exactly when data > 1")
    for d in range(data):
        same = [sums[(p, d)] for p in range(r0["pods"])]
        check(all(x == same[0] for x in same),
              f"{tag}: data index {d}'s parameters bit-identical across pods "
              f"after every step {same}")
    if data > 1:
        check(sums[(0, 0)] != sums[(0, 1)], f"{tag}: data ranks hold other shards")
    h = r0["history"][1:3]            # steps 2 and 3, unprofiled
    step_s = float(np.median([x["time_s"] for x in h]))
    tokens = r0["seq_len"] * r0["global_batch"] // r0["pods"]
    out = {
        "pods": r0["pods"], "data": data, "zero": r0["zero"], "algo": algo,
        "bucket_mb": r0["bucket_mb"], "bucket_mode": r0["history"][0]["bucket_mode"],
        "n_buckets": len(bplans),
        "checksums_by_rank": [[x["checksum"] for x in rp["history"]] for rp in reps],
        "run_s": r0["run_s"], "losses": [x["loss"] for x in r0["history"]],
        "grad_norms": [x["grad_norm"] for x in r0["history"]],
        "step_ms_median_steps_2_3": 1e3 * step_s,
        "tokens_per_s_per_pod": tokens / step_s,
        "sync_ms_median_steps_2_3": 1e3 * float(np.median([x["sync_s"] for x in h])),
        # under ZeRO: the in-pod gathers (forward and recompute) and the
        # backward's reduce-scatters, host clock from a device sync
        "gather_ms_median_steps_2_3": 1e3 * float(np.median([x["gather_s"] for x in h])),
        "reduce_scatter_ms_median_steps_2_3":
            1e3 * float(np.median([x["reduce_scatter_s"] for x in h])),
        "step_ms_by_rank": [[1e3 * x["time_s"] for x in rp["history"]] for rp in reps],
        "sync_ms": [1e3 * x["sync_s"] for x in r0["history"]],
        "wire_bytes_per_step": r0["history"][-1]["wire_bytes"],
        "sent_bytes_per_step": r0["history"][-1]["sent_bytes"],
        "n_chunks": step_chunks, "streams": r0["streams"],
        "chunk_mb": r0["chunk_mb"], "plan_wire_bytes": plan["wire_bytes"],
        "payload_bytes": plan["payload_bytes"],
        "peak_mem_gb_per_rank": [(rp["peak_mem_bytes"] or 0) / 1e9 for rp in reps],
        "launches_rank0": r0["launches"], "device": r0["device_name"],
        "chunk_sizes_step1": r0["history"][0]["chunk_sizes"],
        "params": r0["params"], "seq_len": r0["seq_len"],
        "global_batch": r0["global_batch"]}
    if bplans:
        out["bucket_sync_ms_median_steps_2_3"] = [
            1e3 * float(np.median([x["buckets"][i]["sync_s"] for x in h]))
            for i in range(len(bplans))]
        out["bucket_bounds"] = [[b["lo"], b["hi"]] for b in r0["history"][0]["buckets"]]
        out["bucket_payload_bytes"] = [b["payload_bytes"] for b in bplans]
    if r0["profile"] is not None:
        p = r0["profile"]
        buckets: dict = {}
        for name, sec, cnt in p["device_ops"]:
            b = buckets.setdefault(_bucket(name), [0.0, 0])
            b[0] += 1e3 * sec
            b[1] += cnt
        out["profile"] = {
            "step": p["step"], "wall_ms": 1e3 * p["wall_s"],
            "device_busy_ms": 1e3 * p["device_busy_s"],
            "device_idle_share": p["device_idle_share"],
            "device_launches": p["device_launches"],
            "device_ops_by_bucket_ms": buckets,
            "top_device_ops": [[n[:90], 1e3 * sec, cnt]
                               for n, sec, cnt in p["device_ops"][:12]]}
    return out


def train_specs() -> list:
    """The train phase's runs (:func:`_launcher_argv`): each codec, the int8
    run with a fourth, profiled step."""
    specs = []
    for codec in CODECS:
        argv = list(TRAIN_ARGS)
        if codec == "int8":
            argv += ["--steps", str(PROFILE_STEP + 1), "--profile-step", str(PROFILE_STEP)]
        specs.append((codec, argv, "train", None))
    return specs


def zero_specs() -> list:
    return [(c, ZERO_ARGS, "zero", None) for c in ZERO_CODECS]


def bucket_specs() -> list:
    from repro_torch.configs import CommConfig
    return [(c, ZERO_ARGS, "buckets",
             CommConfig(mode="hierarchical", compress=c, bucket_mb=BUCKET_MB))
            for c in ZERO_CODECS]


def phase_train(torch, out_dir: str) -> dict:
    """The launcher (``launch.train.train_runs``, the per-rank entry of
    ``python -m repro_torch.launch.train``) on 2 pods x 1 data rank, full-width
    qwen1.5-0.5b at 4096 tokens a pod, 3 steps with each wire codec; the int8
    run takes a fourth step, which rank 0 runs under torch.profiler.  Each
    rank resets the kernel counts just before it trains and reports them
    after.  The runs ran in :func:`phase_families_train`'s 2 x 1 spawn;
    this checks their reports (:func:`_check_run`)."""
    runs = dict(zip(CODECS, _checked_runs(train_specs(), out_dir)))
    for codec in CODECS:
        emit({"phase": "train", "mesh": "2x1", "codec": codec, **runs[codec]})
    return runs


def phase_zero(torch, out_dir: str) -> dict:
    """The same launcher on 2 pods x 2 data ranks (four processes on the one
    card), ZeRO-3, one 4096-token sequence a rank, 3 steps with no codec and
    with int8.  The runs ran in :func:`phase_families_train`'s 2 x 2 spawn;
    this checks their reports (:func:`_check_run`)."""
    runs = dict(zip(ZERO_CODECS, _checked_runs(zero_specs(), out_dir)))
    for codec in ZERO_CODECS:
        emit({"phase": "zero", "mesh": "2x2", "codec": codec, **runs[codec]})
    return runs


def phase_buckets(torch, out_dir: str, zero: dict) -> dict:
    """The zero phase's launcher and mesh with ``bucket_mb = 64``: no codec
    runs the backward flush, int8 the tail mode (:func:`_check_run` checks
    every run, each bucket against its plan).  Held to the zero phase's runs
    (`zero`): the flush run's step-1 loss bit-identical, steps 2-3 within
    FLUSH_LOSS_TOL (the hook rounds each synced block gradient to bf16 once
    more, as the reference's does); the tail run's parameter checksums equal
    at every step on every rank.  The runs ran after the zero phase's in
    :func:`phase_families_train`'s 2 x 2 spawn."""
    done = _checked_runs(bucket_specs(), out_dir)
    runs = {}
    for codec, r in zip(ZERO_CODECS, done):
        z = zero[codec]
        mode = "flush" if codec == "none" else "tail"
        check(r["bucket_mode"] == mode and r["n_buckets"] >= 3,
              f"buckets {codec}: {r['n_buckets']} buckets in mode {r['bucket_mode']}")
        gaps = [abs(a - b) for a, b in zip(r["losses"], z["losses"])]
        if codec == "none":
            check(r["losses"][0] == z["losses"][0],
                  f"buckets none: step-1 loss {r['losses'][0]} is the zero run's "
                  f"{z['losses'][0]}")
            check(all(g <= FLUSH_LOSS_TOL for g in gaps),
                  f"buckets none: losses {r['losses']} within {FLUSH_LOSS_TOL} "
                  f"of the zero run's {z['losses']}")
        else:
            check(r["checksums_by_rank"] == z["checksums_by_rank"],
                  "buckets int8: tail-mode parameters bit-identical to the zero "
                  "phase's unbucketed int8 run at every step")
        r["loss_gap_to_zero_run"] = gaps
        runs[codec] = r
        emit({"phase": "buckets", "mesh": "2x2", "codec": codec, "mode": mode,
              **{k: v for k, v in r.items() if k != "chunk_sizes_step1"}})
    return runs


def phase_ring(torch, out_dir: str) -> dict:
    """The launcher on 3 pods x 1 data rank (three processes on the card),
    ring with int8, ring2 with int8 and ring with no codec, 3 steps each
    (:func:`_check_run` checks every run: replicas bit-identical, wire bytes
    the plan's, quant and dequant P and 2P-1 times per chunk per direction).
    Reports the bytes each rank sent against the psum path's modeled
    per-pod wire (gather-based with a codec: (P-1) times the codec's bytes)
    and the int8 wire blocks."""
    from repro_torch.configs import CommConfig
    from repro_torch.core.ring import wire_bytes_per_pod
    done, spawn_s = _train_runs(
        [(codec, RING_ARGS, f"ring_{algo}",
          CommConfig(mode="hierarchical", compress=codec, algo=algo))
         for algo, codec in RING_RUNS], out_dir)
    runs = {}
    for (algo, codec), r in zip(RING_RUNS, done):
        pods = r["pods"]
        r["psum_path_wire_bytes_per_step"] = round(wire_bytes_per_pod(
            r["payload_bytes"], pods, algo="psum", compress=codec))
        dirs, calls = ring_calls(r["chunk_sizes_step1"], pods, algo)
        r["directions_per_step"] = dirs
        if codec == "int8":
            blocks: dict = {}
            for (_, _, block), n in calls.items():
                blocks[block] = blocks.get(block, 0) + n
            r["wire_blocks_quant_calls"] = dict(sorted(blocks.items()))
            top = max(calls.items(), key=lambda kv: (kv[1], kv[0][0] * kv[0][1]))
            r["top_wire_shape"] = {"rows": top[0][0], "n": top[0][1],
                                   "block": top[0][2], "quant_calls_per_step": top[1]}
        runs[f"{algo}_{codec}"] = r
        emit({"phase": "ring", "mesh": "3x1", "algo": algo, "codec": codec,
              **{k: v for k, v in r.items() if k != "chunk_sizes_step1"}})
    emit({"phase": "ring_spawn", "runs": [f"{a}_{c}" for a, c in RING_RUNS],
          "spawn_s": spawn_s})
    return runs


def phase_kernels_ring(torch, dev, shape: dict) -> dict:
    """quant (f32 in, as the ring's partial sums) and dequant (to f32) at the
    wire-block shape the int8 ring run used most, against their plain
    versions (exact) and timed; bound: each input read once and each output
    written once, at the memory rate."""
    from repro_torch.kernels import quant, ref
    R, n, block = shape["rows"], shape["n"], shape["block"]
    g = torch.Generator(device=dev).manual_seed(3)
    nbytes = 4 * R * n + R * n + 4 * (R * n // block)
    k = sets_for(nbytes)
    xs = [torch.randn((R, n), generator=g, device=dev) * 1e-3 for _ in range(k)]
    q, s = quant.quant_int8_2d(xs[0], block=block)
    qr, sr = ref.quant_int8_ref(xs[0], block)
    check(torch.equal(q, qr) and torch.equal(s, sr), f"quant ring wire {shape} exact")
    y = quant.dequant_int8_2d(q, s, block=block, dtype=torch.float32)
    check(torch.equal(y, ref.dequant_int8_ref(q, s, block, torch.float32)),
          f"dequant ring wire {shape} exact")
    qs = [quant.quant_int8_2d(x, block=block) for x in xs]
    paths = {"quant": ["block", "warp"][quant.quant_path(block, xs[0].data_ptr())],
             "dequant": ["block", "vector"][quant.dequant_path(block, q.data_ptr())]}
    rows = {}
    for name, fn, plain, ops_n in (
            ("quant_int8", lambda i: quant.quant_int8_2d(xs[i], block=block),
             lambda i: ref.quant_int8_ref(xs[i], block), 3 * R * n),
            ("dequant_int8", lambda i: quant.dequant_int8_2d(*qs[i], block=block,
                                                             dtype=torch.float32),
             lambda i: ref.dequant_int8_ref(*qs[i], block, torch.float32), R * n)):
        e = {"on_path": "ring", "shape": [R, n], "block": block,
             "path": paths[name.split("_")[0]], "max_abs_err": 0.0, "exact": True,
             "ms": cuda_ms(torch, fn, k, 50), "plain_ms": cuda_ms(torch, plain, k, 5),
             "library_ms": None}
        e["bound_ms"], e["bound_by"] = bound(nbytes, ops_n, PEAK_F32)
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        rows[name] = e
    del xs, qs
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phases 11 and 12: site groups and online autotuning, Trainer in spawned ranks
# ---------------------------------------------------------------------------

# the Trainer's model and batch, as the launcher builds them from TRAIN_ARGS:
# full-width qwen1.5-0.5b, 4096 tokens a pod (one sequence)
TRAINER_SPEC = {"arch": "qwen1.5-0.5b", "smoke": False, "seq_len": 4096,
                "device": "cuda", "gloo_timeout_s": 900}
# the sites, ckpt, facade, chaos and elastic phases at 2 of the 24 layers
# (published widths; 181,283,840 parameters, 39 % of the bytes: the
# embedding stays whole), so that the whole script fits its time with the
# families phase.  The route and autotune phases keep their depth: their
# int8 syncs are the embedding's padded chunks (ROADMAP §C 4) at any depth
CUT_SPEC = dict(TRAINER_SPEC, layers=2)
SITE_STEPS = 3
# (run, algo, codec, site groups on): the gateway ring, the masked psum, and
# the plain 4-pod hierarchical run they are held to
SITE_RUNS = (("ring_int8", "ring", "int8", True), ("psum_none", "psum", "none", True),
             ("plain_none", "psum", "none", False))
SITE_LOSS_TOL = 1e-3
AUTOTUNE_STEPS = 8
AUTOTUNE_EVERY = 2


def spec_config(spec: dict):
    """The model config of a Trainer phase's `spec`: its arch at published
    widths (smoke-sized with ``smoke``), its depth cut to ``layers`` where
    the spec sets it (a phase cut to fit the script's time)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    cfg = get_config(spec["arch"])
    if spec["smoke"]:
        cfg = smoke_config(cfg)
    if spec.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    return cfg


def _trainer_rc(spec: dict, n_pods: int, steps: int, comm):
    from repro_torch.configs import RunConfig, ShapeConfig, TrainConfig
    cfg = spec_config(spec)
    # the launcher's TrainConfig for --steps `steps` at its default lr
    return RunConfig(model=cfg, shape=ShapeConfig("train_4k", spec["seq_len"], n_pods,
                                                  "train"), comm=comm,
                     train=TrainConfig(lr=3e-4, total_steps=steps,
                                       warmup_steps=max(steps // 10, 1)))


def _rank_setup(torch, rank: int, world: int, init: str, spec: dict, pods: int,
                data: int = 1):
    """Join the gloo world and build the mesh of `pods` pods x `data` data
    ranks on this rank's device (the ranks share the card)."""
    import datetime
    import resource
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    # every stream group is a gloo group with a socket to each peer: a
    # route's bottleneck hop may use hundreds of streams
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    timeout = datetime.timedelta(seconds=spec["gloo_timeout_s"])
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=timeout)
    dev = torch.device("cpu")
    if spec["device"] != "cpu":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dist, dev, make_local_mesh(pod=pods, data=data, device=dev, timeout=timeout)


def _run_record(torch, tr, dev, hist, launches) -> dict:
    path = tr.bundle.path
    return {"history": hist, "launches": launches, "streams": path.streams,
            "chunk_bytes": path.chunk_bytes, "pacing": path.comm.pacing,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}


def _site_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 4 ranks (4 pods x 1 data rank): the SITE_RUNS one after the
    other, each a Trainer from seed 0 for SITE_STEPS steps; writes its report."""
    import torch
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.topology import LinkProfile, Topology
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer
    dist, dev, mesh = _rank_setup(torch, rank, 4, init, spec, pods=4)
    try:
        topo = Topology()
        topo.add_site("s0", n_pods=2)
        topo.add_site("s1", n_pods=2)
        topo.connect("s0", "s1", LinkProfile("wan", 50e-3, 1e8))
        groups, gateways = topo.pod_groups(), topo.gateways()
        rep = {"rank": rank, "site_groups": groups, "gateways": gateways, "runs": {}}
        for name, algo, codec, sited in SITE_RUNS:
            rc = _trainer_rc(spec, 4, SITE_STEPS, CommConfig(
                mode="hierarchical", compress=codec, algo=algo))
            data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                            seq_len=spec["seq_len"], global_batch=4),
                                 prefetch=0)
            tel.get_telemetry().reset()
            tr = Trainer(rc, mesh, site_groups=groups if sited else None,
                         check_replicas=True)
            tr.init_or_restore(0)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            hist = tr.run(data, SITE_STEPS, log_every=0)
            r = _run_record(torch, tr, dev, hist, ops.launch_counts())
            key = tr.bundle.path.key
            r["plans"] = {k: v["plan"] for k, v in
                          tel.get_telemetry().report(prefix=key).items()}
            rep["runs"][name] = r
            del tr
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        with open(os.path.join(out, f"sites.rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def _autotune_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 2 ranks (2 pods): a Trainer with the int8 wire and
    ``autotune_every=AUTOTUNE_EVERY`` for AUTOTUNE_STEPS steps, one step a
    call so that each step's plan can be read; writes its report."""
    import torch
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer
    dist, dev, mesh = _rank_setup(torch, rank, 2, init, spec, pods=2)
    try:
        rc = _trainer_rc(spec, 2, AUTOTUNE_STEPS,
                         CommConfig(mode="hierarchical", compress="int8"))
        data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                        seq_len=spec["seq_len"], global_batch=2),
                             prefetch=0)
        tel.get_telemetry().reset()
        tr = Trainer(rc, mesh, autotune_every=AUTOTUNE_EVERY, check_replicas=True)
        tr.init_or_restore(0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        streams_used = []
        for _ in range(AUTOTUNE_STEPS):
            streams_used.append(tel.get_telemetry().path(tr.bundle.path.key)
                                .plan.streams_used)
            tr.run(data, 1, log_every=0,
                   log=print if rank == 0 else (lambda *_: None))
        r = _run_record(torch, tr, dev, tr.history, ops.launch_counts())
        r.update(rank=rank, streams_used=streams_used, stream_groups=mesh.n_streams,
                 retunes=tel.get_telemetry().path(tr.bundle.path.key).retunes,
                 tune_bucket=tr.tuner.tune_bucket, n_bundles=len(tr._bundles),
                 flagged=tr.detector.flagged)
        with open(os.path.join(out, f"autotune.rank{rank}.json"), "w") as f:
            json.dump(r, f)
    finally:
        dist.destroy_process_group()


# The ranks of :func:`_spawn` fork from one fork server that imported these
# once: a freshly spawned rank imports torch again, and torch._dynamo at its
# first torch.utils.checkpoint call, 14-19 s a spawn of 2 ranks on the H100
# machine against 1.5 s from the warm server (measured on one H100).  None of
# them touches CUDA when imported, so each rank initializes the card itself.
SPAWN_PRELOAD = ["torch", "torch._dynamo", "torch.utils.checkpoint",
                 "torch.distributed", "numpy", "repro_torch.runtime",
                 "repro_torch.launch.train"]
# the environment a rank takes from the spawner at its spawn: a forked rank
# starts with the fork server's, fixed when the server started
SPAWN_ENV = ("PYTORCH_CUDA_ALLOC_CONF",)


def _rank_main(rank: int, fn, env: dict, *args) -> None:
    """A rank of :func:`_spawn`: the spawner's SPAWN_ENV (None: unset), then
    ``fn(rank, *args)``."""
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    fn(rank, *args)


def _spawn(torch, fn, n: int, out_dir: str, spec: dict, label: str) -> list:
    import multiprocessing
    multiprocessing.get_context("forkserver").set_forkserver_preload(SPAWN_PRELOAD)
    rdv = os.path.join(out_dir, f"{label}_rdv")
    env = {k: os.environ.get(k) for k in SPAWN_ENV}
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, env, f"file://{rdv}", out_dir, spec), nprocs=n,
        join=True, start_method="forkserver")
    return [json.load(open(os.path.join(out_dir, f"{label}.rank{r}.json")))
            for r in range(n)]


def stop_fork_server() -> None:
    """End :func:`_spawn`'s fork server, if one was started."""
    from multiprocessing import forkserver
    forkserver._forkserver._stop()


def _kernels_ran(la: dict, tag: str, kernels: bool) -> None:
    check(not kernels or (la["flash_attention"] > 0 and la["flash_attention_bwd"] > 0
                          and la["rmsnorm"] > 0), f"{tag}: kernels launched {la}")


def _sync_stats(hist: list, pod: int) -> dict:
    h = hist[1:]                       # steps 2.., past the first one's warm-up
    import numpy as np
    return {"step_ms_median_steps_2_3": 1e3 * float(np.median([x["time_s"] for x in h])),
            "sync_ms_median_steps_2_3": 1e3 * float(np.median([x["sync_s"] for x in h])),
            "sent_bytes_per_step": hist[-1]["sent_bytes"], "pod": pod}


def site_plans(spec: dict, run: dict, algo: str, codec: str, sites: int,
               pods: int) -> dict:
    """The ``/intra`` and ``/wan`` plans of the site sync of `spec`'s model,
    from the port's planner on the host: f32 gradients chunked along their
    scatter dims (no ZeRO at one data rank), the intra stage unchunked-in-
    one-stream over a site's pods, the WAN stage over the gateways with the
    path's knobs (`run`'s), its wire the gateways' averaged over the pods."""
    from repro_torch.core import streams as st
    from repro_torch.core.ring import wire_bytes_per_pod
    from repro_torch.models import build_model
    from repro_torch.runtime.step import _eff_grad_leaves
    from repro_torch.sharding import tree_fsdp_dims
    cfg = spec_config(spec)
    defs = build_model(cfg).param_defs()
    leaves, dims = _eff_grad_leaves(defs, tree_fsdp_dims(defs, 1, 1), 1)
    dims = st.normalize_dims(leaves, dims)
    chunk_bytes, streams = run["chunk_bytes"], run["streams"]
    intra = st.plan_chunks(leaves, dims, chunk_bytes)
    wan = st.plan_chunks(leaves, dims, chunk_bytes)
    wire = wire_bytes_per_pod(sum(c.nbytes for c in wan), sites, algo=algo,
                              compress=codec) * sites / pods
    return {"intra": st.plan_summary(intra, st.assign_streams(intra, 1), 1,
                                     chunk_bytes, 1.0, world=pods // sites),
            "wan": st.plan_summary(wan, st.assign_streams(wan, streams), streams,
                                   chunk_bytes, run["pacing"], algo=algo, world=sites,
                                   compress=codec, wire_bytes=int(round(wire)))}


def phase_sites(torch, out_dir: str, spec: dict = TRAINER_SPEC,
                kernels: bool = True) -> dict:
    """`spec`'s qwen1.5-0.5b on 2 sites x 2 pods (four spawned ranks on
    the card), ``Trainer(site_groups=[[0, 1], [2, 3]])`` from a Topology of
    two sites, hierarchical, 3 steps each of the gateway ring with int8 and
    the masked psum with no codec, then the plain 4-pod run.  Checks: the
    replicas bit-identical on all four ranks after every step (the
    Trainer's check_replicas raises first), step 1's loss the plain run's
    bit for bit and steps 2-3 within SITE_LOSS_TOL of it (psum: the sums
    differ in order only; ring: and by the int8 codec), the ``/intra`` and
    ``/wan`` plans the host planner's, every step's WAN chunks and wire
    bytes the ``/wan`` plan's, no WAN-stage byte from a non-gateway on the
    ring, and quant 2 and
    dequant 3 launches per WAN chunk per step on a gateway (a ring of 2),
    none elsewhere; the flash kernels and rmsnorm on every rank."""
    reps = _spawn(torch, _site_rank, 4, out_dir, spec, "sites")
    gateways = reps[0]["gateways"]
    plain = reps[0]["runs"]["plain_none"]["history"]
    out = {"site_groups": reps[0]["site_groups"], "gateways": gateways}
    for name, algo, codec, sited in SITE_RUNS:
        runs = [rp["runs"][name] for rp in reps]
        r0 = runs[0]
        tag = f"sites {name}"
        sums = [[h["checksum"] for h in r["history"]] for r in runs]
        check(all(s == sums[0] for s in sums), f"{tag}: replicas bit-identical {sums}")
        losses = [h["loss"] for h in r0["history"]]
        check(all(math.isfinite(x) for x in losses), f"{tag}: finite losses {losses}")
        row = {"algo": algo, "codec": codec, "site_groups": sited, "losses": losses,
               "checksums": sums[0], "streams": r0["streams"],
               "chunk_bytes": r0["chunk_bytes"],
               "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in runs],
               "launches_rank0": r0["launches"],
               "by_rank": [_sync_stats(r["history"], p) for p, r in enumerate(runs)]}
        for p, r in enumerate(runs):
            _kernels_ran(r["launches"], f"{tag} rank {p}", kernels)
        if sited:
            gaps = [abs(a["loss"] - b["loss"]) for a, b in zip(r0["history"], plain)]
            row["loss_gap_to_plain"] = gaps
            check(losses[0] == plain[0]["loss"],
                  f"{tag}: step-1 loss {losses[0]} is the plain run's {plain[0]['loss']}")
            check(all(g <= SITE_LOSS_TOL for g in gaps),
                  f"{tag}: losses within {SITE_LOSS_TOL} of the plain run's {gaps}")
            want = site_plans(spec, r0, algo, codec, sites=len(gateways), pods=4)
            key = "train:interpod"
            for r in runs:
                check(r["plans"][f"{key}/intra"] == want["intra"]
                      and r["plans"][f"{key}/wan"] == want["wan"],
                      f"{tag}: /intra and /wan plans {r['plans']} are the host "
                      f"planner's {want}")
            wan = want["wan"]
            for p, r in enumerate(runs):
                gw = p in gateways
                for h in r["history"]:
                    check(h["n_chunks"] == wan["n_chunks"]
                          and h["payload_bytes"] == wan["payload_bytes"]
                          and round(h["wire_bytes"]) == wan["wire_bytes"],
                          f"{tag} rank {p} step {h['step']}: WAN chunks and wire "
                          f"{h['n_chunks']} {h['wire_bytes']} against {wan}")
                    if algo != "psum":
                        check((h["sent_bytes"] > 0) == gw,
                              f"{tag} rank {p}: WAN-stage bytes {h['sent_bytes']} "
                              f"(gateway: {gw})")
                la = r["launches"]
                want_q = want_dq = 0
                if codec == "int8" and gw:
                    for h in r["history"]:
                        dirs = ring_calls(h["chunk_sizes"], len(gateways), algo)[0]
                        want_q += len(gateways) * dirs
                        want_dq += (2 * len(gateways) - 1) * dirs
                check(not kernels or (la["quant_int8"] == want_q
                                      and la["dequant_int8"] == want_dq),
                      f"{tag} rank {p}: quant {want_q} and dequant {want_dq} "
                      f"launches expected, got {la}")
            row["plans"] = want
            row["quant_dequant_by_rank"] = [[r["launches"]["quant_int8"],
                                             r["launches"]["dequant_int8"]] for r in runs]
        out[name] = row
        emit({"phase": "sites", "mesh": "2 sites x 2 pods x 1", "run": name, **row})
    return out


def phase_autotune(torch, out_dir: str, spec: dict = TRAINER_SPEC,
                   kernels: bool = True) -> dict:
    """`spec`'s qwen1.5-0.5b on 2 pods (two spawned ranks on the card),
    int8 wire, ``Trainer(autotune_every=2)`` for 8 steps.  Checks: every
    rank ran the same config at every step and noted the same retunes (the
    tuners were fed the same, slowest, step time); at least one retune; the
    replicas bit-identical after every step; exactly the first step of the
    initial bundle and of each newly built one is fresh and none of them is
    flagged a straggler; the stream groups created are the most streams a
    step's plan used; the flash kernels and rmsnorm on both ranks, quant
    and dequant once per chunk (the int8 psum).  Reports
    the retunes, each config's step ms and any straggler flags."""
    reps = _spawn(torch, _autotune_rank, 2, out_dir, spec, "autotune")
    r0 = reps[0]
    for r in reps[1:]:
        for k in ("retunes", "streams_used", "stream_groups", "n_bundles"):
            check(r[k] == r0[k], f"autotune: rank {r['rank']}'s {k} {r[k]} is rank 0's {r0[k]}")
        for a, b in zip(r["history"], r0["history"]):
            check(a["config"] == b["config"] and a["tuner_s"] == b["tuner_s"],
                  f"autotune: step {a['step']} ran {a['config']} on rank "
                  f"{r['rank']}, {b['config']} on rank 0")
    hist = r0["history"]
    check(len(r0["retunes"]) >= 1, "autotune: at least one retune")
    sums = [[h["checksum"] for h in r["history"]] for r in reps]
    check(sums[0] == sums[1], f"autotune: replicas bit-identical {sums}")
    seen, fresh = set(), []
    for h in hist:
        key = json.dumps(h["config"], sort_keys=True)
        fresh.append(key not in seen)
        seen.add(key)
    for r in reps:
        check([h["fresh"] for h in r["history"]] == fresh,
              f"autotune: first steps of new bundles {fresh}")
        check(not any(h["straggler"] for h in r["history"] if h["fresh"]),
              f"autotune rank {r['rank']}: a new bundle's first step was flagged")
        check(all(math.isfinite(h["loss"]) for h in r["history"]),
              "autotune: finite losses")
        _kernels_ran(r["launches"], f"autotune rank {r['rank']}", kernels)
        # the int8 psum: one quant and one dequant launch per chunk
        n = sum(h["n_chunks"] for h in r["history"])
        la = r["launches"]
        check(not kernels or la["quant_int8"] == la["dequant_int8"] == n,
              f"autotune rank {r['rank']}: quant and dequant {n} launches "
              f"expected, got {la}")
    check(r0["stream_groups"] == max(r0["streams_used"]),
          f"autotune: {r0['stream_groups']} stream groups, most streams used "
          f"{max(r0['streams_used'])}")
    by_cfg: dict = {}
    for h in hist:
        if not h["fresh"]:
            by_cfg.setdefault(json.dumps(h["config"], sort_keys=True), []).append(
                1e3 * h["time_s"])
    out = {"retunes": r0["retunes"], "tune_bucket": r0["tune_bucket"],
           "configs_by_step": [h["config"] for h in hist],
           "step_ms_by_rank": [[1e3 * h["time_s"] for h in r["history"]] for r in reps],
           "tuner_ms": [1e3 * h["tuner_s"] for h in hist],
           "step_ms_by_config": by_cfg, "streams_used": r0["streams_used"],
           "stream_groups": r0["stream_groups"], "n_bundles": r0["n_bundles"],
           "losses": [h["loss"] for h in hist], "checksums": sums[0],
           "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in reps],
           "stragglers_flagged": [r["flagged"] for r in reps],
           "launches_rank0": r0["launches"]}
    emit({"phase": "autotune", "mesh": "2x1", **out})
    return out


# --- slice 9: routes, checkpoints and the MPW facade on the CosmoGrid topology

ROUTE = ("tokyo", "espoo")   # no direct link: 2 hops through Amsterdam
ROUTE_SHIFTS = [-1, 2]
ROUTE_STEPS = 3
CKPT_STEPS = 5
CKPT_EVERY = 2
CKPT_FAULT_STEP = 3
CKPT_FAULT_RANK = 1          # one rank's hook raises; every rank recovers
CKPT_BATCHES = 7             # steps 0-2, the failed step 3, steps 2-4 again
FACADE_SEED = 1000


def _say_failed(rank: int) -> None:
    """Print a failing rank's traceback at once: its group going down makes
    the other ranks fail too, and the spawner may report one of them."""
    import traceback
    print(f"chip_smoke: rank {rank} failed:\n{traceback.format_exc()}",
          file=sys.stderr, flush=True)


def _cosmogrid():
    from repro_torch.core.topology import cosmogrid_topology
    topo = cosmogrid_topology()
    return topo, topo.route(*ROUTE)


def _hop_rows(path) -> list:
    """Each hop of a multi-hop path: its knobs, plan and telemetry samples."""
    from repro_torch.core import telemetry as tel
    rows = []
    for i, h in enumerate(path.route):
        pt = tel.get_telemetry().path(path.hop_key(i))
        rows.append({"key": path.hop_key(i), "name": h.name, "shift": h.shift,
                     "streams": h.streams, "chunk_bytes": h.chunk_bytes,
                     "pacing": h.comm.pacing,
                     "plan": None if pt.plan is None else dict(pt.plan.__dict__),
                     "samples": pt.transfers, "total_bytes": pt.total_bytes})
    return rows


def _route_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 4 ranks (4 pods x 1 data rank, one pod a CosmoGrid site): a
    Trainer over the tokyo -> espoo route with the topology's site groups,
    int8, ROUTE_STEPS steps, then the plain 4-pod int8 run; writes its report."""
    import torch
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer
    dist, dev, mesh = _rank_setup(torch, rank, 4, init, spec, pods=4)
    try:
        topo, route = _cosmogrid()
        rep = {"rank": rank, "route": route.describe(), "runs": {}}
        for name, routed in (("route_int8", True), ("plain_int8", False)):
            rc = _trainer_rc(spec, 4, ROUTE_STEPS,
                             CommConfig(mode="hierarchical", compress="int8"))
            data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                            seq_len=spec["seq_len"], global_batch=4),
                                 prefetch=0)
            tel.get_telemetry().reset()
            tr = Trainer(rc, mesh, route=route if routed else None,
                         site_groups=topo.pod_groups() if routed else None,
                         check_replicas=True)
            tr.init_or_restore(0)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            hist = tr.run(data, ROUTE_STEPS, log_every=0)
            r = _run_record(torch, tr, dev, hist, ops.launch_counts())
            path = tr.bundle.path
            r["key"] = path.key
            r["hops"] = _hop_rows(path) if path.hops else []
            rep["runs"][name] = r
            del tr
            _free(torch, dev)
        with open(os.path.join(out, f"route.rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    except BaseException:
        _say_failed(rank)
        raise
    finally:
        dist.destroy_process_group()


def hop_plans(spec: dict, hops: list) -> list:
    """The per-hop plans of the route sync of `spec`'s model from the port's
    planner on the host: the f32 gradients (no ZeRO at one data rank)
    chunked with each hop's chunk bytes, balanced over its streams, every
    hop carrying the whole payload once (``algo="shift"``)."""
    from repro_torch.core import streams as st
    from repro_torch.models import build_model
    from repro_torch.runtime.step import _eff_grad_leaves
    from repro_torch.sharding import tree_fsdp_dims
    cfg = spec_config(spec)
    defs = build_model(cfg).param_defs()
    leaves, dims = _eff_grad_leaves(defs, tree_fsdp_dims(defs, 1, 1), 1)
    dims = st.normalize_dims(leaves, dims)
    out = []
    for h in hops:
        chunks = st.plan_chunks(leaves, dims, h["chunk_bytes"])
        out.append(st.plan_summary(chunks, st.assign_streams(chunks, h["streams"]),
                                   h["streams"], h["chunk_bytes"], h["pacing"],
                                   algo="shift"))
    return out


def phase_route(torch, out_dir: str, spec: dict = TRAINER_SPEC,
                kernels: bool = True) -> dict:
    """`spec`'s qwen1.5-0.5b as 4 pods x 1 data rank on the CosmoGrid
    topology (four spawned ranks on the card), ``Trainer(route=tokyo ->
    espoo, site_groups=topo.pod_groups())``, hierarchical with int8, 3
    steps, then the plain 4-pod int8 run.  Checks: the route's hops are
    tokyo -> amsterdam -> espoo with shifts [-1, 2]; replicas bit-identical
    after every step; step 1's loss the plain run's bit for bit and steps
    2-3 within SITE_LOSS_TOL of it; every rank's per-hop plans equal the
    host planner's and each other's; each hop's ``train/hop{i}`` slot has a
    sample of every step but the first; quant and dequant once per chunk
    (the int8 psum) on every rank; the flash kernels and rmsnorm ran."""
    t0 = time.perf_counter()
    # the plain 4-pod int8 run's padded gathers (ROADMAP §C 4) take the host
    # down to ~10 GB available: a lower floor than the other phases'
    watch = _MemWatch("route", floor_gb=4.0)
    try:
        reps = _spawn(torch, _route_rank, 4, out_dir, spec, "route")
    finally:
        watch.stop()
    plain = reps[0]["runs"]["plain_int8"]["history"]
    out = {"route": reps[0]["route"], "phase_s": time.perf_counter() - t0}
    for name in ("route_int8", "plain_int8"):
        runs = [rp["runs"][name] for rp in reps]
        r0 = runs[0]
        tag = f"route {name}"
        sums = [[h["checksum"] for h in r["history"]] for r in runs]
        check(all(s == sums[0] for s in sums), f"{tag}: replicas bit-identical {sums}")
        losses = [h["loss"] for h in r0["history"]]
        check(all(math.isfinite(x) for x in losses), f"{tag}: finite losses {losses}")
        row = {"key": r0["key"], "losses": losses, "checksums": sums[0],
               "streams": r0["streams"], "chunk_bytes": r0["chunk_bytes"],
               "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in runs],
               "launches_rank0": r0["launches"],
               "by_rank": [_sync_stats(r["history"], p) for p, r in enumerate(runs)]}
        for p, r in enumerate(runs):
            _kernels_ran(r["launches"], f"{tag} rank {p}", kernels)
            n = sum(h["n_chunks"] for h in r["history"])
            la = r["launches"]
            check(not kernels or la["quant_int8"] == la["dequant_int8"] == n,
                  f"{tag} rank {p}: quant and dequant {n} launches expected, got {la}")
        row["quant_dequant_by_rank"] = [[r["launches"]["quant_int8"],
                                         r["launches"]["dequant_int8"]] for r in runs]
        if name == "route_int8":
            hops = r0["hops"]
            check([h["shift"] for h in hops] == ROUTE_SHIFTS
                  and [h["name"] for h in hops] == ["tokyo->amsterdam", "amsterdam->espoo"],
                  f"{tag}: hops {[(h['name'], h['shift']) for h in hops]}")
            want = hop_plans(spec, hops)
            for p, r in enumerate(runs):
                check([h["plan"] for h in r["hops"]] == want,
                      f"{tag} rank {p}: hop plans {[h['plan'] for h in r['hops']]} "
                      f"are the host planner's {want}")
                check(all(h["samples"] == ROUTE_STEPS - 1 for h in r["hops"]),
                      f"{tag} rank {p}: per-hop samples {[h['samples'] for h in r['hops']]}")
            check(losses[0] == plain[0]["loss"],
                  f"{tag}: step-1 loss {losses[0]} is the plain run's {plain[0]['loss']}")
            gaps = [abs(a["loss"] - b["loss"]) for a, b in zip(r0["history"], plain)]
            check(all(g <= SITE_LOSS_TOL for g in gaps),
                  f"{tag}: losses within {SITE_LOSS_TOL} of the plain run's {gaps}")
            row.update(hops=[{k: h[k] for k in ("name", "shift", "streams", "chunk_bytes",
                                                 "pacing", "plan", "samples")}
                             for h in hops], loss_gap_to_plain=gaps)
        out[name] = row
        emit({"phase": "route", "mesh": "4 pods x 1 (CosmoGrid)", "run": name,
              "phase_s": out["phase_s"], **row})
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.core.tree import flatten
    return sum(x.numel() * x.element_size() for x in flatten(tree)[0])


def _dir_sha(path: str) -> dict:
    """{relative file name: sha256} of every file under `path`."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.filetransfer import file_sha256
    names = sorted(os.path.relpath(os.path.join(r, f), path)
                   for r, _, fs in os.walk(path) for f in fs)
    with ThreadPoolExecutor(8) as pool:
        return dict(zip(names, pool.map(lambda n: file_sha256(os.path.join(path, n)),
                                        names)))


def _ckpt_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 4 ranks: the route_int8 Trainer with checkpoints every
    CKPT_EVERY steps (keep 1), a replica shipped over the route, and a
    fault at step CKPT_FAULT_STEP on rank CKPT_FAULT_RANK; then a fresh
    Trainer on the checkpoint the recovery restored, fed the same batches;
    then, the primary removed, a fresh Trainer restored from the replica."""
    import torch
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import InjectedFault, Trainer
    from repro_torch.runtime.train_loop import replica_checksum
    dist, dev, mesh = _rank_setup(torch, rank, 4, init, spec, pods=4)
    home = spec.get("ckpt_home", out)
    ckpt, replica = os.path.join(home, "ckpt"), os.path.join(home, "replica")
    snap = os.path.join(home, "ckpt_at_fault")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    try:
        topo, route = _cosmogrid()
        rc = _trainer_rc(spec, 4, CKPT_STEPS,
                         CommConfig(mode="hierarchical", compress="int8"))
        data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                        seq_len=spec["seq_len"], global_batch=4),
                             prefetch=0)
        batches = [next(data) for _ in range(CKPT_BATCHES)]
        fired = []

        def hook(step):
            if step == CKPT_FAULT_STEP and not fired:
                fired.append(step)
                if rank == CKPT_FAULT_RANK:
                    raise InjectedFault(f"injected on rank {rank} at step {step}")

        kw = dict(route=route, site_groups=topo.pod_groups(), check_replicas=True)
        tel.get_telemetry().reset()
        tr = Trainer(rc, mesh, ckpt_dir=ckpt, replica_dir=replica,
                     ckpt_every=CKPT_EVERY, keep=1, fault_hook=hook, **kw)
        tr.init_or_restore(0)
        saved, restored, rep = {}, [], {"rank": rank}
        save0, restore0 = tr._save, tr._restore

        def save(block):
            saved[tr.step] = replica_checksum(tr.state)
            save0(block)

        def restore():
            sync()
            t0 = time.perf_counter()
            ok = restore0()
            sync()
            restored.append({"step": tr.step, "s": time.perf_counter() - t0,
                             "checksum": replica_checksum(tr.state)})
            if rank == 0:   # keep the checkpoint the recovery read for the replay
                shutil.copytree(tr.manager.path(tr.step),
                                os.path.join(snap, os.path.basename(tr.manager.path(tr.step))),
                                copy_function=os.link)
            return ok

        tr._save, tr._restore = save, restore
        if rank == 0:
            rep0 = tr.manager.replicate_now

            def replicate_now():
                t0 = time.perf_counter()
                n = rep0()
                rep["replicate_now"] = {"s": time.perf_counter() - t0, "files": n}
                return n
            tr.manager.replicate_now = replicate_now
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = tr.run(iter(batches), CKPT_STEPS, log_every=0,
                      log=print if rank == 0 else (lambda *_: None))
        rep.update(run_s=time.perf_counter() - t0, launches=ops.launch_counts(),
                   history=hist, saved={str(k): v for k, v in saved.items()},
                   restored=restored, final_step=tr.step,
                   final_checksum=replica_checksum(tr.state),
                   peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None))
        if rank == 0:
            rep["timings"] = tr.manager.timings
            rep["ckpt_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                    for r, _, fs in os.walk(ckpt) for f in fs)
            rep["gathered_files"] = tr.manager.gatherer.copied_total
            rep["ckpt_tel"] = {k: {"total_bytes": v["total_bytes"],
                                   "transfers": v["transfers"],
                                   "modeled_s": v["total_seconds"],
                                   "plan": v.get("plan")}
                               for k, v in tel.get_telemetry().report().items()
                               if k.startswith("ckpt:")}
        tr.close()
        # the wrappers' bound methods hold the trainer and its state
        del tr, save0, restore0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        # the replay: a fresh Trainer restores the checkpoint the recovery
        # read and takes the batches the recovered steps took
        tr2 = Trainer(rc, mesh, ckpt_dir=snap, **kw)
        rep["replay"] = {"how": tr2.init_or_restore(0), "step": tr2.step,
                         "checksum": replica_checksum(tr2.state)}
        n_after = CKPT_BATCHES - 1 - CKPT_FAULT_STEP
        rep["replay"]["history"] = tr2.run(iter(batches[CKPT_FAULT_STEP + 1:]), n_after,
                                           log_every=0)
        tr2.close()
        del tr2
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            rep["sha_primary"] = _dir_sha(ckpt)
            rep["sha_replica"] = _dir_sha(replica)
            shutil.rmtree(ckpt)           # the primary site's storage is gone
        dist.barrier()
        tr3 = Trainer(rc, mesh, ckpt_dir=ckpt, replica_dir=replica, **kw)
        sync()
        t0 = time.perf_counter()
        how = tr3.init_or_restore(0)
        sync()
        rep["from_replica"] = {"how": how, "step": tr3.step,
                               "s": time.perf_counter() - t0,
                               "checksum": replica_checksum(tr3.state)}
        tr3.close()
        del tr3
        dist.barrier()
        if rank == 0:
            # the checkpoint moves on to the facade phase's FileCopy
            step_dir = sorted(os.listdir(replica))[-1]
            os.replace(os.path.join(replica, step_dir), os.path.join(home, "facade_src"))
            for d in (ckpt, replica, snap):
                shutil.rmtree(d, ignore_errors=True)
        with open(os.path.join(out, f"ckpt.rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    except BaseException:
        _say_failed(rank)
        raise
    finally:
        dist.destroy_process_group()


def _host_mem() -> dict:
    """The host's available memory, dirty page cache and shared memory, and
    the memory of this process's control group, GB."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            if k in ("MemAvailable", "Dirty", "Shmem", "Cached"):
                info[k] = int(v.split()[0]) / 1e6
    for name in ("/sys/fs/cgroup/memory.current", "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        if os.path.exists(name):
            info["cgroup"] = int(open(name).read()) / 1e9
            break
    return info


def _children_rss() -> dict:
    """{pid: resident GB} of this process's descendants (the ranks of a
    spawn are the fork server's children)."""
    status = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/status") as f:
                status[pid] = dict(line.split(":", 1) for line in f if ":" in line)
        except OSError:
            continue
    out, parents = {}, {str(os.getpid())}
    while parents:
        kids = {pid for pid, st in status.items()
                if st.get("PPid", "").strip() in parents and int(pid) not in out}
        for pid in kids:
            out[int(pid)] = int(status[pid].get("VmRSS", "0 kB").split()[0]) / 1e6
        parents = kids
    return out


class _MemWatch:
    """Samples _host_mem() every `every` seconds on a thread, printing each
    sample and the children's resident memory to stderr; `low` is the
    least available memory seen.  Below `floor_gb` available it kills the
    children, so that the run fails with its output instead of the machine
    running out of memory."""

    def __init__(self, tag: str, every: float = 1.0, floor_gb: float = 12.0):
        import threading
        self.tag, self.every, self.low, self.floor = tag, every, None, floor_gb
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        import signal
        t0 = time.perf_counter()
        while not self._stop.wait(self.every):
            m = _host_mem()
            a = m.get("MemAvailable")
            self.low = a if self.low is None or (a is not None and a < self.low) else self.low
            kids = _children_rss()
            n = getattr(self, "_n", 0)
            self._n = n + 1
            if n % 10 == 0 or (a is not None and a < 2 * self.floor):
                print(f"chip_smoke: {self.tag} +{time.perf_counter() - t0:.0f}s host "
                      f"memory {json.dumps(m)} children {json.dumps(kids)}",
                      file=sys.stderr, flush=True)
            if a is not None and a < self.floor:
                print(f"chip_smoke: {self.tag}: {a:.1f} GB of host memory left; "
                      f"stopping the ranks", file=sys.stderr, flush=True)
                for pid in kids:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def phase_ckpt(torch, out_dir: str, spec: dict = TRAINER_SPEC,
               kernels: bool = True) -> dict:
    """The route phase's Trainer (4 pods, tokyo -> espoo, int8) with
    ``ckpt_dir``, ``replica_dir`` over the route, ``ckpt_every=2``,
    ``keep=1`` and a ``fault_hook`` that raises ``InjectedFault`` on rank 1
    at step 3, for 5 steps.  Checks: every rank recovered at step 3 to the
    step-2 checkpoint, whose restored checksum (parameters and moments) is
    the saved one's; the recovered steps equal bit for bit (losses and
    checksums) those of a fresh Trainer that restores the same checkpoint
    and takes the same batches; the replica's files have the primary's
    sha256 and crossed both hops zlib-compressed (``ckpt:*`` wire bytes
    below the checkpoint bytes); with the primary removed, a fresh
    Trainer's ``init_or_restore()`` is "restored" from the replica at step
    5 with the final state's checksum; replicas bit-identical; the kernels
    ran.  Reports save (host copy, then write), replicate and restore
    seconds, checkpoint bytes and the per-hop wire bytes."""
    t0 = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=out_dir)
    free = shutil.disk_usage(home).free
    emit({"phase": "ckpt_disk", "dir": home, "free_gb": free / 1e9})
    watch = _MemWatch("ckpt")
    try:
        reps = _spawn(torch, _ckpt_rank, 4, out_dir, dict(spec, ckpt_home=home), "ckpt")
    except BaseException:
        shutil.rmtree(home, ignore_errors=True)
        raise
    finally:
        watch.stop()
    r0 = reps[0]
    tag = "ckpt"
    for r in reps:
        steps = [h["step"] for h in r["history"]]
        check(steps == [0, 1, 2, 2, 3, 4], f"{tag} rank {r['rank']}: steps {steps}")
        check(len(r["restored"]) == 1 and r["restored"][0]["step"] == CKPT_EVERY,
              f"{tag} rank {r['rank']}: one recovery to step {CKPT_EVERY}: {r['restored']}")
        check(r["restored"][0]["checksum"] == r["saved"][str(CKPT_EVERY)],
              f"{tag} rank {r['rank']}: restored checksum is the saved one's")
        check(r["final_step"] == CKPT_STEPS, f"{tag}: final step {r['final_step']}")
        rp = r["replay"]
        check(rp["how"] == "restored" and rp["step"] == CKPT_EVERY
              and rp["checksum"] == r["saved"][str(CKPT_EVERY)],
              f"{tag} rank {r['rank']}: replay restored {rp['how']} at {rp['step']}")
        after = r["history"][-len(rp["history"]):]
        check([(h["loss"], h["checksum"]) for h in after]
              == [(h["loss"], h["checksum"]) for h in rp["history"]],
              f"{tag} rank {r['rank']}: recovered steps equal the replay bit for bit "
              f"{[h['loss'] for h in after]} {[h['loss'] for h in rp['history']]}")
        fr = r["from_replica"]
        check(fr["how"] == "restored" and fr["step"] == CKPT_STEPS
              and fr["checksum"] == r["final_checksum"] == r["saved"][str(CKPT_STEPS)],
              f"{tag} rank {r['rank']}: restored from the replica {fr}")
        _kernels_ran(r["launches"], f"{tag} rank {r['rank']}", kernels)
        check(all(math.isfinite(h["loss"]) for h in r["history"]), f"{tag}: finite losses")
    sums = [[h["checksum"] for h in r["history"]] for r in reps]
    check(all(s == sums[0] for s in sums), f"{tag}: replicas bit-identical {sums}")
    check(r0["sha_primary"] == r0["sha_replica"] and len(r0["sha_primary"]) > 1,
          f"{tag}: the replica's {len(r0['sha_replica'])} files have the primary's sha256")
    hops = {k: v for k, v in r0["ckpt_tel"].items() if "/hop" in k}
    check(len(hops) == 2 and all(0 < v["total_bytes"] for v in hops.values()),
          f"{tag}: per-hop ckpt wire bytes {hops}")
    out = {"history_steps": [h["step"] for h in r0["history"]],
           "losses": [h["loss"] for h in r0["history"]],
           "replay_losses": [h["loss"] for h in r0["replay"]["history"]],
           "ckpt_bytes": r0["ckpt_bytes"], "files": len(r0["sha_primary"]),
           "saves": r0["timings"], "replicate_now": r0["replicate_now"],
           "gathered_files": r0["gathered_files"],
           "restore_s_by_rank": [r["restored"][0]["s"] for r in reps],
           "replica_restore_s_by_rank": [r["from_replica"]["s"] for r in reps],
           "run_s": r0["run_s"], "ckpt_wire": r0["ckpt_tel"],
           "step_ms": [1e3 * h["time_s"] for h in r0["history"]],
           "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in reps],
           "launches_rank0": r0["launches"], "free_gb_before": free / 1e9,
           "host_mem_low_available_gb": watch.low,
           "facade_src": os.path.join(home, "facade_src"),
           "phase_s": time.perf_counter() - t0}
    emit({"phase": "ckpt", "mesh": "4 pods x 1 (CosmoGrid)", **out})
    return out


def _rss_gb() -> float:
    """This process's resident memory, GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return 0.0


def _facade_tree(torch, defs, rank: int, dev):
    """An f32 tree shaped like the parameters, drawn from a
    generator seeded by `rank`."""
    from repro_torch.core.tree import tree_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(FACADE_SEED + rank)
    return tree_map(lambda pd: torch.randn(pd.shape, generator=gen, device=dev,
                                           dtype=torch.float32), defs)


def _facade_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 4 ranks, one MPW session each: the verbs over the tokyo ->
    espoo Forwarder and a single-link path on a full-width tree, the int8
    AllReduce against the plain sum, and (rank 0) the FileCopy of the
    checkpoint along the route, interrupted and resumed."""
    import threading
    import torch
    from repro_torch.configs import CommConfig
    from repro_torch.core.api import MPW
    from repro_torch.core.filetransfer import ChecksumError, FileTransfer, file_sha256
    from repro_torch.core.tree import flatten
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import replica_checksum
    from repro_torch.sharding import tree_fsdp_dims
    dist, dev, mesh = _rank_setup(torch, rank, 4, init, spec, pods=4)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    try:
        cfg = spec_config(spec)
        defs = build_model(cfg).param_defs()
        # each leaf crosses along its scatter dim, as the gradient sync's do:
        # along the stacked layer dim the int8 codec would pad each one-layer
        # chunk's extent of 1 to its 256-element block (ROADMAP.md §C 4)
        dims = tree_fsdp_dims(defs, 1, 1)
        topo, _ = _cosmogrid()
        mpw = MPW.Init(mesh)
        fid = mpw.CreateForwarder(topo, *ROUTE)
        lid = mpw.CreatePath(nstreams=32)
        # paced to one stream a wave: the int8 psum gathers every rank's
        # padded chunks (§C 4), and a whole tree's at once would not fit in
        # the host memory of four ranks
        qid = mpw.CreatePath(comm=CommConfig(compress="int8", pacing=1 / 32))
        mine = _facade_tree(torch, defs, rank, dev)
        nbytes = _tree_bytes(mine)
        every = [torch.zeros(1, dtype=torch.int64) for _ in range(4)]
        dist.all_gather(every, torch.tensor([replica_checksum(mine)]))
        sums = [int(t) for t in every]
        rep = {"rank": rank, "tree_bytes": nbytes, "verbs": {}}

        def timed(fn):
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            res = fn()
            sync()
            return res, time.perf_counter() - t0

        ops.reset_launch_counts()
        verbs = [("SendRecv", lambda: mpw.SendRecv(fid, mine, dims=dims), 1, 2),
                 ("Cycle", lambda: mpw.Cycle(fid, fid, mine, dims=dims), 2, 4),
                 ("Relay", lambda: mpw.Relay(fid, mine, dims=dims), 1, 2),
                 ("Forward", lambda: mpw.Forward(fid, mine, dims=dims), 1, 2),
                 ("Forward_reverse", lambda: mpw.Forward(fid, mine, dims=dims,
                                                         reverse=True), -1, 2),
                 ("SendRecv_link", lambda: mpw.SendRecv(lid, mine, dims=dims), 1, 1),
                 ("ISendRecv_Wait", lambda: mpw.Wait(*mpw.ISendRecv(lid, mine)), 1, 1)]
        for name, fn, shift, legs in verbs:
            got, dt = timed(fn)
            want = sums[(rank - shift) % 4]
            rep["verbs"][name] = {"ok": replica_checksum(got) == want, "s": dt,
                                  "legs": legs, "GBps": nbytes * legs / dt / 1e9,
                                  "rss_gb": _rss_gb()}
            del got
        buf = torch.zeros(1 << 20, device=dev)
        buf[:1000 + rank] = float(rank + 1)
        (gbuf, glen), dt = timed(lambda: mpw.DSendRecv(lid, buf, 1000 + rank, 1 << 20))
        src = (rank - 1) % 4
        rep["verbs"]["DSendRecv"] = {
            "ok": int(glen) == 1000 + src and bool((gbuf[:int(glen)] == src + 1).all())
            and bool((gbuf[int(glen):] == 0).all()), "s": dt}
        bar, dt = timed(mpw.Barrier)
        rep["verbs"]["Barrier"] = {"ok": float(bar) == 4.0, "s": dt}
        got, dt = timed(lambda: mpw.AllReduce(qid, mine, dims=dims))
        # against the plain sum of the four ranks' trees in rank order,
        # within the int8 codec's bound: half a quantization step of each
        # rank's block, at most its leaf's absmax / 127 / 2
        worst = 0.0
        leaves_got = flatten(got)[0]
        seeds = [torch.Generator(device=dev) for _ in range(4)]
        for r, g in enumerate(seeds):
            g.manual_seed(FACADE_SEED + r)
        for x, pd in zip(leaves_got, flatten(defs)[0]):
            xs = [torch.randn(pd.shape, generator=g, device=dev, dtype=torch.float32)
                  for g in seeds]
            want = xs[0] + xs[1] + xs[2] + xs[3]
            bound = (sum(float(v.abs().max()) for v in xs) / 127 / 2
                     + 1e-6 * float(want.abs().max()))
            err = float((x - want).abs().max())
            worst = max(worst, err / bound)
            del xs, want
        rep["verbs"]["AllReduce_int8"] = {"ok": worst <= 1.0, "s": dt,
                                          "err_over_bound": worst,
                                          "GBps": nbytes / dt / 1e9}
        del got
        rep["launches"] = ops.launch_counts()
        rep["report_keys"] = sorted(mpw.Report())
        dist.barrier()
        if rank == 0:
            src_dir = spec["facade_src"]
            dst_dir = os.path.join(os.path.dirname(src_dir), "facade_copy")
            # chunks of at most half the largest file, so that a file crosses
            # in several chunks whatever the model's width
            biggest = max(os.path.getsize(os.path.join(src_dir, f))
                          for f in os.listdir(src_dir))
            mpw.setChunkSize(fid, max(1 << 16, min(mpw.path(fid).chunk_bytes,
                                                   biggest // 2)))
            path = mpw.path(fid)
            # the first try: hop 1 corrupts every arrival of the second
            # chunk of a file, past the retries; one stream, so the chunks
            # before it have landed and their sidecar is kept
            lock, hits = threading.Lock(), [0]

            def corrupt(c, hop, payload):
                if hop == 1 and c.leaf == 1:
                    with lock:
                        hits[0] += 1
                    return b"\0" * len(payload)
                return payload

            eng = FileTransfer(path.with_(streams=1), fault_hook=corrupt)
            failed = None
            try:
                eng.copy_tree(src_dir, dst_dir)
            except ChecksumError as e:
                failed = str(e)
            t0 = time.perf_counter()
            results = mpw.FileCopy(fid, src_dir, dst_dir)
            dt = time.perf_counter() - t0
            src_sha = _dir_sha(src_dir)
            ok = all(res.sha256 == src_sha[os.path.relpath(res.src, src_dir)]
                     for res in results) and _dir_sha(dst_dir) == src_sha
            report = mpw.Report()
            copied = sum(res.nbytes for res in results)
            rep["FileCopy"] = {
                "failed_first": failed, "corrupted_arrivals": hits[0],
                "ok": ok and failed is not None, "s": dt, "bytes": copied,
                "GBps": copied / dt / 1e9, "files": len(results),
                "chunk_bytes": path.chunk_bytes,
                "resumed_skipped": sum(res.skipped for res in results),
                "hop_rows": {k: {"total_bytes": report[k]["total_bytes"],
                                 "plan_wire_bytes": report[k]["plan"]["wire_bytes"]}
                             for k in path.hop_keys()},
                "hop_wire_bytes": [sum(res.hop_wire_bytes[i] for res in results)
                                   for i in range(path.n_hops)]}
            shutil.rmtree(dst_dir, ignore_errors=True)
        dist.barrier()
        mpw.Finalize()
        with open(os.path.join(out, f"facade.rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    except BaseException:
        _say_failed(rank)
        raise
    finally:
        dist.destroy_process_group()


def phase_facade(torch, out_dir: str, spec: dict = TRAINER_SPEC,
                 kernels: bool = True, src_dir: str = None) -> dict:
    """Four spawned ranks on the card, one ``MPW`` session each on a 4-pod
    mesh: ``CreateForwarder(cosmogrid, "tokyo", "espoo")``, then SendRecv,
    Cycle, Relay and Forward (both directions) of an f32 tree shaped like
    the parameters of `spec`'s model (a generator seeded by the rank),
    SendRecv and ISendRecv/Wait over a single link, DSendRecv, Barrier, and
    AllReduce with int8 against the plain sum.  Checks: every verb delivers
    exactly the tree its sender made (checksums of the bits), the int8
    AllReduce within half a quantization step per rank of the plain sum,
    quant and dequant launched by it; then on rank 0 a FileCopy of the ckpt
    phase's checkpoint along the route, first failing its CRC on hop 1
    past ``max_retries`` (ChecksumError), then resumed by the verb: every
    file's sha256 the source's, a chunk skipped on resume, per-hop Report
    rows.  Reports each verb's GB/s (the ranks share the card; the links
    are host memory and gloo on one machine)."""
    t0 = time.perf_counter()
    have_src = src_dir is not None and os.path.isdir(src_dir)
    if not have_src:   # without the ckpt phase: a checkpoint of a smaller tree
        from repro_torch.checkpoint import store
        src_dir = os.path.join(out_dir, "facade_src")
        gen = torch.Generator().manual_seed(FACADE_SEED)
        store.save({"w": torch.randn(1 << 22, generator=gen),
                    "b": torch.randn(4096, generator=gen)}, src_dir, step=0)
    watch = _MemWatch("facade")
    try:
        reps = _spawn(torch, _facade_rank, 4, out_dir, dict(spec, facade_src=src_dir),
                      "facade")
    finally:
        watch.stop()
        shutil.rmtree(os.path.dirname(src_dir) if have_src else src_dir,
                      ignore_errors=True)
    for r in reps:
        for name, v in r["verbs"].items():
            check(v["ok"], f"facade rank {r['rank']}: {name} {v}")
        la = r["launches"]
        check(not kernels or (la["quant_int8"] > 0 and la["dequant_int8"] > 0),
              f"facade rank {r['rank']}: the int8 AllReduce launched quant and "
              f"dequant {la}")
    fc = reps[0]["FileCopy"]
    check(fc["ok"] and fc["resumed_skipped"] >= 1,
          f"facade: FileCopy interrupted then resumed {fc}")
    check(all(v["total_bytes"] > 0 for v in fc["hop_rows"].values())
          and len(fc["hop_rows"]) == 2, f"facade: per-hop Report rows {fc['hop_rows']}")
    out = {"tree_bytes": reps[0]["tree_bytes"],
           "verbs_by_rank": [r["verbs"] for r in reps], "FileCopy": fc,
           "file_src": "ckpt phase checkpoint" if have_src else "small checkpoint",
           "launches_rank0": reps[0]["launches"], "phase_s": time.perf_counter() - t0}
    emit({"phase": "facade", "mesh": "4 pods x 1 (CosmoGrid)",
          "links": "host memory and gloo on one machine", **out})
    return out


# --- slice 10: chaos, elasticity and serving under faults -------------------

CHAOS_STEPS = 8
CHAOS_FAULT_AT = 4
CHAOS_TIMELINE = [["inject", 4], ["detect", 5], ["replan", 5], ["retune", 5],
                  ["recover", 7]]
CHAOS_LOSS_TOL = 1e-6        # the reference's own bound, detour against control
CHAOS_WATCHDOG_S = 600.0     # the monitor's timeout_s (see _monitor)
FAILOVER_STEPS = 6           # a segment: 6 steps, the primary removed, 6 more
FAILOVER_PARTITION_AT = 7
FAILOVER_CKPT_EVERY = 5
CHAOS_BATCHES = 16
ELASTIC_STEPS, ELASTIC_FAULT, ELASTIC_HEAL = 20, 6, 14
ELASTIC_LOCAL_STEPS = 4
ELASTIC_GOLDEN = [
    ["detect", "tokyo", 6], ["evict", "tokyo", 8],
    ["resize", "amsterdam,espoo,edinburgh", 8], ["retune", "train:ams-espoo", 8],
    ["recover", "amsterdam,espoo,edinburgh", 8], ["join", "tokyo", 15],
    ["resize", "amsterdam,tokyo,espoo,edinburgh", 15], ["catchup", "tokyo", 15],
    ["retune", "train:ams-espoo", 15], ["recover", "amsterdam,tokyo,espoo,edinburgh", 15]]
ELASTIC_BASELINE_TOL = 0.25  # the reference's bound on the final losses
RESTART_STEPS = 2


def _timeline(log) -> list:
    return [[e.kind, e.subject, e.step, dict(e.detail)] for e in log.events()]


def _monitor(topo):
    """The scenario's monitor, with a watchdog above the slowest healthy
    hop: one sync of the full-width gradients (2.78 GB of psum wire) models
    at ~214 s over the tokyo-edinburgh backup link, which the default 30 s
    watchdog would take for a dead link."""
    from repro_torch.core.chaos import ChaosDetector, ChaosMonitor
    return ChaosMonitor(topo, "amsterdam", "tokyo", timeout_s=CHAOS_WATCHDOG_S,
                        detector=ChaosDetector(window=2, min_baseline=2),
                        recover_after=2)


@contextlib.contextmanager
def expandable_segments():
    """``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` for the processes
    spawned inside (the ranks' caches share the card)."""
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old


def _free(torch, dev) -> None:
    """Release what a finished run left cached: device blocks, and the
    pinned host blocks of its host copies (PyTorch's caching host allocator
    keeps them; four ranks' int8 gathers of one run and the next, each of
    its own sizes, outgrew the 96 GiB host in the route phase)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        host = getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
        if host is None:
            host = getattr(torch._C, "_host_emptyCache", None)
        if host is not None:
            host()


def _chaos_runs(torch, dist, dev, mesh, rank: int, spec: dict) -> dict:
    """One rank's chaos runs (4 pods x 1 data rank, one pod a CosmoGrid
    site), no codec: the amsterdam -> tokyo Trainer without a fault, then
    with the light path dropped at CHAOS_FAULT_AT and a ChaosMonitor (backup
    links), one step a call; then the failover run on the plain topology,
    tokyo partitioned at FAILOVER_PARTITION_AT, checkpoints every
    FAILOVER_CKPT_EVERY steps with the replica over the route, the primary
    removed between its two segments; returns its report."""
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.chaos import get_incident_log
    from repro_torch.core.topology import cosmogrid_topology
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.train_loop import replica_checksum
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    say = print if rank == 0 else (lambda *_: None)
    home = spec["home"]
    rc = _trainer_rc(spec, 4, 2 * FAILOVER_STEPS,
                     CommConfig(mode="hierarchical", compress="none"))
    data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                    seq_len=spec["seq_len"], global_batch=4),
                         prefetch=0)
    batches = [next(data) for _ in range(CHAOS_BATCHES)]
    log = get_incident_log()
    rep = {"rank": rank, "runs": {}}
    for name in ("control", "chaos"):
        log.clear()
        tel.get_telemetry().reset()
        topo = cosmogrid_topology(backup_links=True)
        mon = None
        if name == "chaos":
            topo.connect("amsterdam", "tokyo",
                         topo.link("amsterdam", "tokyo").drop(CHAOS_FAULT_AT))
            mon = _monitor(topo)
        tr = Trainer(rc, mesh, route=topo.route("amsterdam", "tokyo"),
                     site_groups=topo.pod_groups(), chaos=mon, check_replicas=True)
        tr.init_or_restore(0)
        marks = {}
        apply0 = tr.apply_route

        def apply_route(new_route, log=print):
            marks["detect"] = time.perf_counter()
            apply0(new_route, log=log)
        tr.apply_route = apply_route
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        it, ends = iter(batches), []
        for _ in range(CHAOS_STEPS):
            tr.run(it, 1, log_every=0, log=say)
            sync()
            ends.append(time.perf_counter())
        r = _run_record(torch, tr, dev, tr.history, ops.launch_counts())
        r.update(timeline=_timeline(log), route=list(tr.route.sites),
                 key=tr.bundle.path.key, hops=_hop_rows(tr.bundle.path))
        if "detect" in marks:
            # the first step run on the detour is the one after detection
            i = next(k for k, h in enumerate(tr.history) if h["route"] != ["amsterdam", "tokyo"])
            r["detect_to_detour_step_s"] = ends[i + 1] - marks["detect"]
            r["detour_step_s"] = tr.history[i + 1]["time_s"]
        rep["runs"][name] = r
        del tr, apply0, apply_route, mon
        _free(torch, dev)

    log.clear()
    tel.get_telemetry().reset()
    topo = cosmogrid_topology()
    topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").partition(
        "tokyo", at_step=FAILOVER_PARTITION_AT))
    primary, replica = os.path.join(home, "ck"), os.path.join(home, "rep")
    tr = Trainer(rc, mesh, route=topo.route("amsterdam", "tokyo"),
                 site_groups=topo.pod_groups(), ckpt_dir=primary, replica_dir=replica,
                 ckpt_every=FAILOVER_CKPT_EVERY, keep=1, chaos=_monitor(topo),
                 check_replicas=True)
    tr.init_or_restore(0)
    saved, restored = {}, []
    save0, restore0 = tr._save, tr._restore

    def save(block):
        saved[tr.step] = replica_checksum(tr.state)
        save0(block)

    def restore():
        sync()
        t0 = time.perf_counter()
        ok = restore0()
        sync()
        restored.append({"step": tr.step, "s": time.perf_counter() - t0,
                         "checksum": replica_checksum(tr.state)})
        return ok
    tr._save, tr._restore = save, restore
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    it = iter(batches)
    t0 = time.perf_counter()
    tr.run(it, FAILOVER_STEPS, log_every=0, log=say)
    first_s = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        # the site's storage is gone, and its mirror with it: a mirror
        # pass racing the removal would prune the replica (ROADMAP §C 15)
        tr.manager.gatherer.stop()
        shutil.rmtree(primary)
    dist.barrier()
    t0 = time.perf_counter()
    tr.run(it, FAILOVER_STEPS, log_every=0, log=say)
    r = _run_record(torch, tr, dev, tr.history, ops.launch_counts())
    r.update(timeline=_timeline(log), route=None if tr.route is None else
             list(tr.route.sites), saved={str(k): v for k, v in saved.items()},
             restored=restored, final_step=tr.step,
             segment_s=[first_s, time.perf_counter() - t0],
             recovery=log.recovery_latencies())
    if rank == 0:
        r["ckpt_timings"] = tr.manager.timings
        r["ckpt_tel"] = {k: v["total_bytes"] for k, v in
                         tel.get_telemetry().report().items() if k.startswith("ckpt:")}
    rep["runs"]["failover"] = r
    tr.close()
    del tr, save0, restore0, save, restore
    _free(torch, dev)
    dist.barrier()
    return rep


def check_chaos(spec: dict, reps: list, kernels: bool = True) -> dict:
    """The chaos phase's checks on its four ranks' reports.  Full-width
    qwen1.5-0.5b as 4 pods x 1 data rank on the CosmoGrid
    topology with its backup link (four spawned ranks on the card), the
    amsterdam -> tokyo route, no codec, the topology's site groups.  A
    fault-free control run and the same run with the light path dropped at
    step 4 under ``ChaosMonitor(ChaosDetector(window=2, min_baseline=2),
    recover_after=2)``, 8 steps each.  Checks: every rank's incident
    timeline is inject 4, detect 5, replan 5, retune 5, recover 7, the same
    on every rank; the route after it amsterdam -> edinburgh -> tokyo; the
    losses within 1e-6 of the control run's; the replicas bit-identical
    after every step; the new route's per-hop plans the host planner's.
    Then the failover: the plain topology, tokyo partitioned at step 7,
    checkpoints every 5 steps (keep 1) with the replica shipped over the
    route with mpw-cp (no zlib with no codec), 6 steps, the primary
    removed, 6 more: inject, detect, failover (``outcome: restored``,
    ``resume_step`` 6), recover on every rank, the restored state's
    checksum the one saved at step 6.  The flash kernels and rmsnorm in
    every run.  Reports step ms, the time from detection to the end of the
    first step on the detour, and the restore seconds."""
    out = {"seconds_by_rank": [r["seconds"] for r in reps]}
    for name in ("control", "chaos", "failover"):
        runs = [rp["runs"][name] for rp in reps]
        r0 = runs[0]
        tag = f"chaos {name}"
        sums = [[h["checksum"] for h in r["history"]] for r in runs]
        check(all(s == sums[0] for s in sums), f"{tag}: replicas bit-identical {sums}")
        losses = [h["loss"] for h in r0["history"]]
        check(all(math.isfinite(x) for x in losses), f"{tag}: finite losses {losses}")
        for p, r in enumerate(runs):
            _kernels_ran(r["launches"], f"{tag} rank {p}", kernels)
            check(r["timeline"] == r0["timeline"],
                  f"{tag}: rank {p}'s timeline {r['timeline']} is rank 0's {r0['timeline']}")
        h = r0["history"]
        row = {"losses": losses, "steps": [x["step"] for x in h],
               "step_ms": [1e3 * x["time_s"] for x in h],
               "sync_ms": [1e3 * x["sync_s"] for x in h],
               "routes": [x["route"] for x in h], "timeline": r0["timeline"],
               "streams": r0["streams"], "chunk_bytes": r0["chunk_bytes"],
               "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in runs],
               "launches_rank0": r0["launches"]}
        if name == "chaos":
            ctl = out["control"]["losses"]
            check([[k, s] for k, _, s, _ in r0["timeline"]] == CHAOS_TIMELINE,
                  f"{tag}: timeline {r0['timeline']}")
            check(r0["route"] == ["amsterdam", "edinburgh", "tokyo"],
                  f"{tag}: final route {r0['route']}")
            gap = max(abs(a - b) for a, b in zip(losses, ctl))
            check(gap <= CHAOS_LOSS_TOL, f"{tag}: losses within {CHAOS_LOSS_TOL} of "
                  f"the control run's, {gap}")
            hops = r0["hops"]
            check([x["name"] for x in hops] == ["amsterdam->edinburgh", "edinburgh->tokyo"],
                  f"{tag}: hops {[x['name'] for x in hops]}")
            want = hop_plans(spec, hops)
            for p, r in enumerate(runs):
                check([x["plan"] for x in r["hops"]] == want,
                      f"{tag} rank {p}: hop plans {[x['plan'] for x in r['hops']]} are "
                      f"the host planner's {want}")
            row.update(max_loss_diff_to_control=gap, loss_diff_is_zero=gap == 0.0,
                       hops=[{k: x[k] for k in ("name", "streams", "chunk_bytes", "plan")}
                             for x in hops], key=r0["key"],
                       detect_to_detour_step_s_by_rank=[r["detect_to_detour_step_s"]
                                                        for r in runs],
                       detour_step_s=r0["detour_step_s"])
        if name == "failover":
            kinds = [k for k, *_ in r0["timeline"]]
            check(kinds == ["inject", "detect", "failover", "recover"],
                  f"{tag}: timeline {r0['timeline']}")
            fo = next(d for k, _, _, d in r0["timeline"] if k == "failover")
            check(fo == {"outcome": "restored", "resume_step": FAILOVER_STEPS},
                  f"{tag}: failover {fo}")
            check(r0["route"] is None, f"{tag}: no route after the failover")
            for p, r in enumerate(runs):
                rs = r["restored"]
                check(len(rs) == 1 and rs[0]["step"] == FAILOVER_STEPS
                      and rs[0]["checksum"] == r["saved"][str(FAILOVER_STEPS)],
                      f"{tag} rank {p}: restored the step-{FAILOVER_STEPS} state {rs}")
                check([x["step"] for x in r["history"]] == row["steps"],
                      f"{tag} rank {p}: steps {[x['step'] for x in r['history']]}")
            row.update(restore_s_by_rank=[r["restored"][0]["s"] for r in runs],
                       segment_s=r0["segment_s"], recovery=r0["recovery"],
                       ckpt_timings=r0["ckpt_timings"], ckpt_wire=r0["ckpt_tel"])
        out[name] = row
        emit({"phase": "chaos", "mesh": "4 pods x 1 (CosmoGrid)", "run": name, **row})
    return out


def delta_plan(spec: dict, run: dict, members: int, pods: int = 4) -> dict:
    """The ``{key}/delta`` plan of a delta sync of `spec`'s model from the
    port's planner on the host: the f32 parameters (one data rank, so whole
    leaves, chunked along dim 0), the path's knobs (`run`'s), the member
    gateways' psum, its wire averaged over the pods."""
    from repro_torch.core import streams as st
    from repro_torch.core.ring import wire_bytes_per_pod
    from repro_torch.models import build_model
    from repro_torch.runtime.step import _eff_grad_leaves
    from repro_torch.sharding import tree_fsdp_dims
    cfg = spec_config(spec)
    defs = build_model(cfg).param_defs()
    leaves, _ = _eff_grad_leaves(defs, tree_fsdp_dims(defs, 1, 1), 1)
    chunks = st.plan_chunks(leaves, st.normalize_dims(leaves, None), run["chunk_bytes"])
    wire = wire_bytes_per_pod(sum(c.nbytes for c in chunks), members, algo="psum",
                              compress="none") * members / pods
    return st.plan_summary(chunks, st.assign_streams(chunks, run["streams"]),
                           run["streams"], run["chunk_bytes"], run["pacing"],
                           algo="psum", world=members, compress="none",
                           wire_bytes=int(round(wire)))


def _params_checksum(tr) -> int:
    """The checksum of a ZeRO Trainer's whole parameters, the shards
    gathered over each pod's data group (the moments, restored by the same
    code, are left out: gathering 4.6 GB twice costs the script ~15 s)."""
    from repro_torch.core.collectives import all_gather_dim
    from repro_torch.core.tree import tree_map
    from repro_torch.runtime.train_loop import replica_checksum
    return replica_checksum(tree_map(
        lambda x, d: x if d is None else all_gather_dim(x, d, tr.mesh.data_group),
        tr.state["params"], tr.bundle.dims))


def _elastic_runs(torch, dist, dev, mesh, rank: int, spec: dict) -> dict:
    """One rank's elastic runs (4 pods x 1 data rank on the CosmoGrid star):
    local SGD every ELASTIC_LOCAL_STEPS steps with a SiteMembership
    coordinated by amsterdam, tokyo's only link down for steps
    ELASTIC_FAULT..ELASTIC_HEAL, ELASTIC_STEPS steps, each delta sync and
    the catch-up recorded; the 3-site baseline; then a 2 x 2 ZeRO Trainer
    restarted as 1 pod x 4 data ranks; returns its report."""
    from repro_torch.configs import CommConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.core.chaos import get_incident_log
    from repro_torch.core.membership import SiteMembership
    from repro_torch.core.topology import cosmogrid_topology
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import Trainer, elastic_restart
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.train_loop import replica_checksum
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    home = spec["home"]
    ds0, cu0 = train_loop.build_delta_sync, train_loop.build_catchup
    try:
        rc = _trainer_rc(spec, 4, ELASTIC_STEPS, CommConfig(
            mode="hierarchical", compress="none", local_steps=ELASTIC_LOCAL_STEPS))
        data = make_pipeline(DataConfig(vocab_size=rc.model.vocab_size,
                                        seq_len=spec["seq_len"], global_batch=4),
                             prefetch=0)
        batches = [next(data) for _ in range(ELASTIC_STEPS)]
        cur, syncs, catchups = [None], [], []

        def build_delta_sync(rc_, mesh_, bundle, **kw):
            fn = ds0(rc_, mesh_, bundle, **kw)
            if fn is None:
                return None

            def timed(params, anchor):
                full = anchor is not cur[0]._anchor
                sync()
                t0 = time.perf_counter()
                got = fn(params, anchor)
                sync()
                s = time.perf_counter() - t0
                plan = tel.get_telemetry().path(f"{bundle.path.key}/delta").plan
                syncs.append({"step": cur[0].step, "full": full, "s": s,
                              "checksum": replica_checksum(got),
                              "gateways": kw["member_gateways"],
                              "plan": dict(plan.__dict__), "streams": bundle.path.streams,
                              "chunk_bytes": bundle.path.chunk_bytes,
                              "pacing": bundle.path.comm.pacing})
                return got
            return timed

        def build_catchup(mesh_, bundle, **kw):
            fn = cu0(mesh_, bundle, **kw)

            def timed(params):
                sync()
                t0 = time.perf_counter()
                got = fn(params)
                sync()
                catchups.append({"step": cur[0].step, "s": time.perf_counter() - t0,
                                 "checksum": replica_checksum(got),
                                 # -0.0 as +0.0: what the masked sum delivers
                                 "checksum_plus_zero": replica_checksum(
                                     tree_map(lambda p: p + 0.0, got)),
                                 **{k: kw[k] for k in ("source_pod", "target_pods")}})
                return got
            return timed
        train_loop.build_delta_sync, train_loop.build_catchup = build_delta_sync, build_catchup
        log = get_incident_log()
        rep = {"rank": rank, "runs": {}}
        for name in ("elastic", "baseline"):
            log.clear()
            tel.get_telemetry().reset()
            syncs.clear()
            catchups.clear()
            topo = cosmogrid_topology()   # the star: tokyo's one link is to amsterdam
            fault, heal = (ELASTIC_FAULT, ELASTIC_HEAL) if name == "elastic" else (0, None)
            for a, b in (("amsterdam", "tokyo"), ("tokyo", "amsterdam")):
                topo.connect(a, b, topo.link(a, b).drop(fault, until=heal))
            if name == "elastic":
                mem = SiteMembership(topo, "amsterdam", lease_steps=2, rejoin_after=2)
            else:
                mem = SiteMembership(topo, "amsterdam", lease_steps=2)
                mem.evict("tokyo", 0, reason="baseline")
            tr = Trainer(rc, mesh, route=topo.route("amsterdam", "espoo"),
                         site_groups=topo.pod_groups(), membership=mem, check_replicas=True)
            cur[0] = tr
            tr.init_or_restore(0)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            tr.run(iter(batches), ELASTIC_STEPS, log_every=0,
                   log=print if rank == 0 else (lambda *_: None))
            r = _run_record(torch, tr, dev, tr.history, ops.launch_counts())
            r.update(timeline=[[e.kind, e.subject, e.step] for e in log.events()],
                     details=[dict(e.detail) for e in log.events()], epoch=mem.epoch,
                     syncs=list(syncs), catchups=list(catchups))
            rep["runs"][name] = r
            cur[0] = None
            del tr, mem
            _free(torch, dev)
    finally:
        train_loop.build_delta_sync, train_loop.build_catchup = ds0, cu0
    rc2 = _trainer_rc(spec, 4, 2 * RESTART_STEPS,
                      CommConfig(mode="hierarchical", compress="none"))
    m22 = make_local_mesh(pod=2, data=2, device=dev, timeout=mesh.timeout)
    m14 = make_local_mesh(pod=1, data=4, device=dev, timeout=mesh.timeout)
    tr = Trainer(rc2, m22, ckpt_dir=os.path.join(home, "restart_ck"),
                 check_replicas=True)
    tr.init_or_restore(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    h1 = tr.run(iter(batches), RESTART_STEPS, log_every=0)
    la1 = ops.launch_counts()
    saved = _params_checksum(tr)
    shapes = [list(x.shape) for x in tr.state["params"]["blocks"]["ffn"].values()]
    sync()
    t0 = time.perf_counter()
    t2 = elastic_restart(rc2, tr, m14, check_replicas=True)
    sync()
    restart_s = time.perf_counter() - t0
    del tr
    _free(torch, dev)
    restored, restored_step = _params_checksum(t2), t2.step
    ops.reset_launch_counts()
    h2 = t2.run(iter(batches[RESTART_STEPS:]), RESTART_STEPS, log_every=0)
    rep["restart"] = {
        "zero": t2.bundle.zero, "step": restored_step, "saved": saved,
        "restored": restored, "restart_s": restart_s,
        "losses": [h["loss"] for h in h1 + h2],
        "step_ms": [1e3 * h["time_s"] for h in h1 + h2],
        "shapes_2x2": shapes,
        "shapes_1x4": [list(x.shape) for x in t2.state["params"]["blocks"]["ffn"].values()],
        "launches_2x2": la1, "launches": ops.launch_counts(),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}
    t2.close()
    del t2
    _free(torch, dev)
    return rep


def check_elastic(spec: dict, reps: list, kernels: bool = True) -> dict:
    """The elastic phase's checks on its four ranks' reports.  Full-width
    qwen1.5-0.5b as 4 pods x 1 data rank on the CosmoGrid star (four spawned ranks on the card), the amsterdam -> espoo route, no
    codec, local SGD every 4 steps with ``SiteMembership(topo, "amsterdam",
    lease_steps=2, rejoin_after=2)``, tokyo's link dropped both ways for
    steps 6-14, 20 steps.  Checks: the incident timeline is the reference's
    golden ten rows (``tests/test_elastic.py``) on every rank; after every
    delta sync the member pods' parameters are bit-identical; after the
    catch-up tokyo's parameters are amsterdam's bit for bit (a ``-0.0``
    taken as ``+0.0``, as the masked sum gives it); every sync's
    ``{key}/delta`` plan is the host planner's for its member gateways; the
    3-site baseline (tokyo evicted at step 0) runs 20 steps and the final
    losses are within 0.25 of each other.  Then a 2 x 2 ZeRO Trainer, 2
    steps and a checkpoint, ``elastic_restart`` onto 1 pod x 4 data ranks:
    restored at step 2 with the saved parameters' checksum (shards gathered),
    2 more steps with finite losses.  The flash kernels and rmsnorm in
    every run.  Reports step, delta-sync, full-resync and catch-up ms."""
    names = ["amsterdam", "tokyo", "espoo", "edinburgh"]
    out = {"seconds_by_rank": [r["seconds"] for r in reps]}
    for name in ("elastic", "baseline"):
        runs = [rp["runs"][name] for rp in reps]
        r0 = runs[0]
        tag = f"elastic {name}"
        for p, r in enumerate(runs):
            _kernels_ran(r["launches"], f"{tag} rank {p}", kernels)
            check(all(math.isfinite(h["loss"]) for h in r["history"]),
                  f"{tag} rank {p}: finite losses")
            check(r["timeline"] == r0["timeline"] and r["details"] == r0["details"],
                  f"{tag}: rank {p}'s timeline {r['timeline']} is rank 0's")
            check(len(r["syncs"]) == len(r0["syncs"]), f"{tag}: syncs on every rank")
        for i, s in enumerate(r0["syncs"]):
            members = [p for p in range(4) if p in s["gateways"]]
            got = {runs[p]["syncs"][i]["checksum"] for p in members}
            check(len(got) == 1, f"{tag}: sync {i} at step {s['step']}: members "
                  f"{[names[p] for p in members]} bit-identical, checksums {got}")
            want = delta_plan(spec, s, len(s["gateways"]))
            for p, r in enumerate(runs):
                check(r["syncs"][i]["plan"] == want,
                      f"{tag} rank {p} sync {i}: plan {r['syncs'][i]['plan']} is the "
                      f"host planner's {want}")
        h = r0["history"]
        row = {"losses": [x["loss"] for x in h], "epoch": r0["epoch"],
               "timeline": r0["timeline"], "members": [x["members"] for x in h],
               "step_ms": [1e3 * x["time_s"] for x in h],
               "sync_ms": [1e3 * x["sync_s"] for x in h],
               "delta_syncs": [{k: s[k] for k in ("step", "full", "gateways")}
                               | {"ms": 1e3 * s["s"], "n_chunks": s["plan"]["n_chunks"],
                                  "wire_bytes": s["plan"]["wire_bytes"]}
                               for s in r0["syncs"]],
               "delta_sync_ms_by_rank": [[1e3 * s["s"] for s in r["syncs"]] for r in runs],
               "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in runs],
               "launches_rank0": r0["launches"]}
        if name == "elastic":
            check(r0["timeline"] == ELASTIC_GOLDEN, f"{tag}: timeline {r0['timeline']}")
            check(r0["epoch"] == 2, f"{tag}: epoch {r0['epoch']}")
            cus = [r["catchups"] for r in runs]
            check(all(len(c) == 1 for c in cus), f"{tag}: one catch-up on every rank {cus}")
            check(cus[1][0]["checksum"] == cus[0][0]["checksum_plus_zero"],
                  f"{tag}: tokyo's parameters after the catch-up are amsterdam's "
                  f"{cus[1][0]['checksum']} {cus[0][0]['checksum_plus_zero']}")
            row.update(catchup_ms_by_rank=[1e3 * c[0]["s"] for c in cus],
                       catchup_source_negative_zeros=(cus[0][0]["checksum"]
                                                      != cus[0][0]["checksum_plus_zero"]))
        else:
            check(r0["epoch"] == 1, f"{tag}: tokyo evicted for the whole run")
            gap = abs(row["losses"][-1] - out["elastic"]["losses"][-1])
            check(gap < ELASTIC_BASELINE_TOL, f"{tag}: final losses within "
                  f"{ELASTIC_BASELINE_TOL}, {gap}")
            row["final_loss_gap_to_elastic"] = gap
        out[name] = row
        emit({"phase": "elastic", "mesh": "4 pods x 1 (CosmoGrid star)", "run": name,
              **row})
    rs = [rp["restart"] for rp in reps]
    for p, r in enumerate(rs):
        check(r["zero"] and r["step"] == RESTART_STEPS,
              f"elastic restart rank {p}: restored at step {r['step']}")
        check(r["restored"] == r["saved"] == rs[0]["saved"],
              f"elastic restart rank {p}: the restored state is the saved one "
              f"{r['restored']} {r['saved']}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"elastic restart rank {p}: finite losses {r['losses']}")
        _kernels_ran(r["launches"], f"elastic restart 1x4 rank {p}", kernels)
        _kernels_ran(r["launches_2x2"], f"elastic restart 2x2 rank {p}", kernels)
    out["restart"] = {"losses": rs[0]["losses"], "step_ms": rs[0]["step_ms"],
                      "restart_s_by_rank": [r["restart_s"] for r in rs],
                      "shapes_2x2": rs[0]["shapes_2x2"], "shapes_1x4": rs[0]["shapes_1x4"],
                      "peak_mem_gb_per_rank": [(r["peak_mem_bytes"] or 0) / 1e9 for r in rs],
                      "launches_rank0": rs[0]["launches"]}
    emit({"phase": "elastic", "mesh": "2 x 2 ZeRO -> 1 x 4 ZeRO", "run": "restart",
          **out["restart"]})
    return out


SLICE10_RUNS = {"chaos": _chaos_runs, "elastic": _elastic_runs}


def _slice10_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One of 4 ranks (4 pods x 1 data rank on the card): the runs of the
    chaos and elastic phases named in ``spec["runs"]``, one after the other
    on one mesh (one spawn, one set of stream groups for both); writes its
    report, each phase's seconds in it."""
    import torch
    dist, dev, mesh = _rank_setup(torch, rank, 4, init, spec, pods=4)
    try:
        rep = {}
        for name in spec["runs"]:
            t0 = time.perf_counter()
            rep[name] = SLICE10_RUNS[name](torch, dist, dev, mesh, rank,
                                           dict(spec, home=os.path.join(spec["home"], name)))
            rep[name]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out, f"slice10.rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    except BaseException:
        _say_failed(rank)
        raise
    finally:
        dist.destroy_process_group()


def phase_chaos_elastic(torch, out_dir: str, names=("chaos", "elastic"),
                        spec: dict = TRAINER_SPEC, kernels: bool = True) -> dict:
    """The chaos and elastic phases (:func:`check_chaos`,
    :func:`check_elastic`) in one spawn of four ranks on the card, under a
    host-memory watch; returns each one's results and the spawn's seconds."""
    t0 = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip_smoke_slice10_", dir=out_dir)
    for name in names:
        os.makedirs(os.path.join(home, name))
    watch = _MemWatch("chaos_elastic")
    # four ranks' caches share the card: the delta syncs' f32 buffers must
    # reuse each rank's cached activation memory
    try:
        with expandable_segments():
            reps = _spawn(torch, _slice10_rank, 4, out_dir,
                          dict(spec, home=home, runs=list(names)), "slice10")
    finally:
        watch.stop()
        shutil.rmtree(home, ignore_errors=True)
    out = {"spawn_s": time.perf_counter() - t0}
    checks = {"chaos": check_chaos, "elastic": check_elastic}
    for name in names:
        out[name] = checks[name](spec, [r[name] for r in reps], kernels)
    return out


def serve_chaos_window(mono_timeline: list, n_requests: int) -> tuple:
    """The drop window [start, stop) over the engine steps at which the
    middle requests' KV ships: from one step before the decode start of the
    (n/2 - 2)-th request to start to four steps after that of the n/2-th
    (the engine ships at a request's decode start, and a ship tries the
    dead hop at its step and the next two before it reroutes), so that the
    first of them reroutes."""
    steps = sorted(s for kind, _, s in mono_timeline if kind == "decode")
    check(len(steps) == n_requests, f"serve_chaos: {len(steps)} decode starts")
    mid = n_requests // 2
    return steps[mid - 2] - 1, steps[mid] + 4


def phase_serve_chaos(torch, dev, cfg, params, ctx: dict) -> dict:
    """The engine phase's 16 requests on full-width llama3.2-3b,
    disaggregated amsterdam -> tokyo over the CosmoGrid route with its
    backup link, no codec, the light path dropped for a window over the
    middle requests' ships (``launch/serve.py --chaos-drop``'s topology,
    ``ship_timeout_s=0.5``).  Checks: every request completes with the
    engine phase's mono tokens bit for bit; at least one reship and one
    reroute; every ship's per-hop wire bytes the plan's for the hops it
    took; not degraded; the flash kernels and rmsnorm launched.  Then the
    plain topology (no detour): the engine degrades to the in-memory
    handoff and still completes every request with the mono tokens."""
    import numpy as np
    from repro_torch.configs import CommConfig
    from repro_torch.core.chaos import IncidentLog
    from repro_torch.core.kvship import plan_kv_ship
    from repro_torch.core.path import WidePath
    from repro_torch.core.telemetry import get_telemetry
    from repro_torch.core.topology import Fault, cosmogrid_topology
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServingEngine
    t_phase = time.perf_counter()
    reqs, mono = ctx["reqs"], ctx["mono_results"]
    start, stop = serve_chaos_window(ctx["mono_timeline"], len(reqs))
    out = {"drop_window": [start, stop]}
    for label, backup in (("reroute", True), ("no_detour", False)):
        topo = cosmogrid_topology(backup_links=backup)
        topo.connect("amsterdam", "tokyo", topo.link("amsterdam", "tokyo").with_fault(
            Fault("drop", start=start, stop=stop)))
        route = topo.route("amsterdam", "tokyo")
        path = WidePath(axis="pod", comm=CommConfig(streams=16), hops=route.as_hops(),
                        name="kvship")
        log = IncidentLog()
        tel = get_telemetry()
        tel.reset()
        eng = ServingEngine(ctx["rc"], mode="disagg", path=path, params=params,
                            route=route, topo=topo, log=log, ship_timeout_s=0.5,
                            prefill_site="amsterdam", decode_site="tokyo", device=dev)
        for prompt, mnew in reqs:
            check(eng.submit(prompt, mnew) is not None, "request admitted")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        tag = f"serve_chaos {label}"
        check(stats["completed"] == len(reqs), f"{tag}: every request completes {stats}")
        for rid in mono:
            check(np.array_equal(eng.results[rid], mono[rid]),
                  f"{tag}: req{rid} tokens bit-identical to the mono run's")
        check(launches["flash_attention"] > 0 and launches["rmsnorm"] > 0,
              f"{tag}: flash and rmsnorm kernels launched {launches}")
        hops_taken = {}
        for rid, res in eng.ships.items():
            prompt = reqs[rid][0]
            shape = (cfg.num_layers, len(prompt), cfg.num_kv_heads, cfg.resolved_head_dim)
            plan = plan_kv_ship({n: torch.empty(shape, dtype=torch.bfloat16, device="meta")
                                 for n in ("k", "v")}, path)
            names = [f"{a}->{b}" for a, b in zip(res.route, res.route[1:])]
            key = f"serve/req{rid}/kv"
            got = [tel.path(f"{key}/hop{i}:{n}").total_bytes for i, n in enumerate(names)]
            check(got == [plan.wire_bytes_hop] * len(names)
                  and tel.path(key).total_bytes == plan.wire_bytes_hop * len(names)
                  == res.wire_bytes_total,
                  f"{tag}: req{rid} per-hop wire bytes {got} are the plan's "
                  f"{plan.wire_bytes_hop} over {names}")
            hops_taken[rid] = names
        total_tokens = int(sum(len(t) for t in eng.results.values()))
        row = {"wall_s": wall, "tokens": total_tokens, "tokens_per_s": total_tokens / wall,
               "mean_prefill_ms": 1e3 * float(np.mean(eng.timings["prefill_s"])),
               "mean_ship_ms": 1e3 * float(np.mean(eng.timings["ship_s"])),
               "reships": stats["reships"], "reroutes": stats["reroutes"],
               "degraded": stats["degraded"], "shipped": len(eng.ships),
               "hops_taken": {str(k): v for k, v in hops_taken.items()},
               "incidents": [[r["event"], r["subject"], r["step"]] for r in log.timeline()],
               "launches": launches}
        if backup:
            check(stats["reships"] >= 1 and stats["reroutes"] >= 1,
                  f"{tag}: at least one reship and one reroute {stats}")
            check(not stats["degraded"], f"{tag}: not degraded")
            check(any(len(v) == 2 for v in hops_taken.values()),
                  f"{tag}: a ship took the detour {hops_taken}")
        else:
            check(stats["degraded"], f"{tag}: degraded with no detour")
            check(len(eng.ships) < len(reqs), f"{tag}: the ships stopped at the degrade")
        out[label] = row
        emit({"phase": "serve_chaos", "run": label, "drop_window": [start, stop], **row})
        del eng
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = out["reroute"]["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 19: the ssm, hybrid, moe, audio and vlm families served at full width
# ---------------------------------------------------------------------------

STATE_ARCHS = ("mamba2-780m", "zamba2-1.2b")
FAMILY_BATCH = 8
FAMILY_CACHE = 4096
FAMILY_PROMPT = 2048
FAMILY_NEW = 64
PARITY_ROWS, PARITY_PROMPT = 2, 64   # prefill against token-by-token decode
# one unit (a mamba block, or the shared block at a site) on the same input:
# the dense model's bounds (tests/test_torch_model.py), bf16 and f32
UNIT_TOL = 5e-2
F32_TOL = 5e-3
# the whole model at full depth in f32, decode against prefill: relative L2
# of the last position's logits.  A wrong layer's state or site's K/V moves
# them by O(1); rounding moved them by at most 7.2e-4, and one f32 ulp of
# noise in the embeddings by 1.2e-4-5.2e-4 (H100 80GB HBM3, 700 W; PERF.md
# section 6)
WHOLE_F32_TOL = 1e-2
SMOKE_PROMPT, SMOKE_NEW = 40, 8
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8               # of 32: 21.3 GB of bf16 weights; all 32 are ~83 GB
MOE_REQUESTS = 8
MOE_LAYER_TOL = 5e-3         # the MoE layer in f32, card against CPU


def _ratio(got, want, tol: float) -> float:
    """max |got - want| / (tol + tol |want|) over the elements (want moved
    to got's device): at most 1 within `tol`, absolute and relative."""
    g, w = got.float(), want.float().to(got.device)
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


def _units(model) -> list:
    """The units of a state-space model's forward, in order: ("mamba", i)
    for each layer and, in a hybrid, ("shared", site) after each site."""
    out, site = [], 0
    for i in range(model.cfg.num_layers):
        out.append(("mamba", i))
        if hasattr(model, "_is_site") and model._is_site(i):
            out.append(("shared", site))
            site += 1
    return out


def _mamba_unit(torch, cfg, lp: dict, x):
    """One mamba block on x (B, S, d): (its prefill output, its decode of the
    same input token by token from an empty state, (prefill's final state,
    decode's))."""
    from repro_torch.models import mamba2 as M
    B, S, _ = x.shape
    y, pre = M.mamba_forward(lp, x, cfg, with_state=True)
    st = {n: torch.zeros(pd.shape[1:], dtype=torch.float32, device=x.device)
          for n, pd in M.mamba_state_defs(cfg, 1, B).items()}
    ys = []
    for t in range(S):
        o, st = M.mamba_decode(lp, st, x[:, t:t + 1], cfg)
        ys.append(o)
    return y, torch.cat(ys, 1), (pre, st)


def _shared_unit(torch, model, sp: dict, x):
    """A hybrid's shared block on x (B, S, d): (its prefill output, the
    flash kernel's on the card; its decode token by token into an empty K/V
    cache)."""
    cfg = model.cfg
    B, S, _ = x.shape
    y = model._shared_apply(sp, x, torch.arange(S, device=x.device))
    k = torch.zeros((B, S, cfg.num_kv_heads, cfg.resolved_head_dim),
                    dtype=x.dtype, device=x.device)
    v = torch.zeros_like(k)
    ys = [model._shared_decode(sp, x[:, t:t + 1], k, v, t) for t in range(S)]
    return y, torch.cat(ys, 1)


def unit_parity(torch, model, params, tokens, cpu=None) -> dict:
    """Every unit of a state-space model (a mamba block, or the shared
    block at a site) on its prefill input (the previous units' prefill
    outputs on `params`' device, bf16), its token-by-token decode against
    its prefill: a mamba block in f32 (its layer's parameters and input
    cast) within F32_TOL, outputs and final state (the state relative to its
    largest entry), as the reference holds its own prefill to decode in f32;
    the shared block in bf16 (the flash kernel takes bf16) within UNIT_TOL.
    With `cpu` (the parameters on the CPU) each unit's bf16 prefill and
    decode there against this device's, within UNIT_TOL.  Returns the
    largest :func:`_ratio` of each comparison; fails above 1.

    Unit by unit because the tolerances are the tests' per-unit ones; the
    whole model is held in f32 by :func:`whole_model_f32`.  In bf16 a mamba
    block's prefill (a bf16 conv) and decode (an f32 window) round at other
    places: up to ~0.07 on outputs of ~1 at smoke size, on the CPU."""
    from repro_torch.models import mamba2 as M
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    x = params["embed"][tokens]
    worst = {"mamba_decode_vs_prefill_f32": 0.0, "state_ssm_f32": 0.0,
             "state_conv_f32": 0.0}
    if hasattr(model, "_is_site"):
        worst["shared_decode_vs_prefill"] = 0.0
    if cpu is not None:
        worst.update(cpu_prefill=0.0, cpu_decode=0.0)

    def note(key, got, want, tol):
        worst[key] = max(worst[key], _ratio(got, want, tol))

    for kind, i in _units(model):
        if kind == "mamba":
            lp = layer_params(params["blocks"], i)
            y32, yd32, (pre, dec) = _mamba_unit(
                torch, cfg, {k: v.float() for k, v in lp.items()}, x.float())
            note("mamba_decode_vs_prefill_f32", yd32, y32, F32_TOL)
            for n in ("ssm", "conv"):
                scale = float(pre[n].float().abs().max()) or 1.0
                note(f"state_{n}_f32", dec[n].float() / scale,
                     pre[n].float() / scale, F32_TOL)
            if cpu is None:
                y = M.mamba_forward(lp, x, cfg)
            else:
                y, yd, _ = _mamba_unit(torch, cfg, lp, x)
                yc, ydc, _ = _mamba_unit(torch, cfg, layer_params(cpu["blocks"], i),
                                         x.cpu())
        else:
            y, yd = _shared_unit(torch, model, params["shared"], x)
            note("shared_decode_vs_prefill", yd, y, UNIT_TOL)
            if cpu is not None:
                yc, ydc = _shared_unit(torch, model, cpu["shared"], x.cpu())
        if cpu is not None:
            note("cpu_prefill", y, yc, UNIT_TOL)
            note("cpu_decode", yd, ydc, UNIT_TOL)
        x = y
    for k, r in worst.items():
        check(r <= 1.0, f"{cfg.name}: {k} within its tolerance (ratio {r})")
    return worst


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def whole_model_f32(torch, model, params, tokens) -> dict:
    """The whole model at full depth in f32 (`params` cast): its
    token-by-token ``decode_step`` on the card from an empty cache against
    its prefill on the CPU (plain kernels; the flash kernel takes bf16
    only) and, for an attention-free model, against its prefill on the
    card: the last position's logits within WHOLE_F32_TOL relative L2.
    Beside them, how far one f32 ulp of noise in the embeddings moves the
    CPU prefill's logits: the model's own amplification of a rounding,
    which sets the tolerance's scale."""
    def cast(tree, dev):
        if isinstance(tree, dict):
            return {k: cast(v, dev) for k, v in tree.items()}
        return tree.to(device=dev, dtype=torch.float32)
    from repro_torch.models.param import tree_init
    dev = tokens.device
    B, S = tokens.shape
    p32 = cast(params, dev)
    cache = cast(tree_init(model.cache_defs(B, S), 0, device=dev), dev)
    for t in range(S):
        ld, cache = model.decode_step(p32, cache, t, tokens[:, t:t + 1])
    del cache
    pc = cast(p32, "cpu")
    lc, _ = model.prefill(pc, {"tokens": tokens.cpu()})
    noise = torch.randn(pc["embed"].shape, generator=torch.Generator().manual_seed(3))
    ln, _ = model.prefill({**pc, "embed": pc["embed"] * (1 + 2.0 ** -24 * noise.sign())},
                          {"tokens": tokens.cpu()})
    out = {"decode_card_vs_prefill_cpu": _rel_l2(ld[:, -1], lc[:, -1]),
           "one_ulp_embedding_noise_cpu": _rel_l2(ln[:, -1], lc[:, -1])}
    if model.cfg.family == "ssm":
        lg, _ = model.prefill(p32, {"tokens": tokens})
        out["decode_vs_prefill_card"] = _rel_l2(ld[:, -1], lg[:, -1])
        out["prefill_card_vs_cpu"] = _rel_l2(lg[:, -1], lc[:, -1])
    del p32, pc
    for k in ("decode_card_vs_prefill_cpu", "decode_vs_prefill_card", "prefill_card_vs_cpu"):
        if k in out:
            check(out[k] <= WHOLE_F32_TOL,
                  f"{model.cfg.name}: whole model in f32, {k} {out[k]} <= {WHOLE_F32_TOL}")
    return out


def _greedy(torch, model, params, tokens, n: int, stub=None):
    """Prefill (with the family's stub inputs `stub`), land into a cache of
    the patch prefix, the prompt and `n`, then `n` greedy decode steps:
    (prefill logits, the (B, n) tokens)."""
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import land_prefill
    S = model.cfg.vision_tokens + tokens.shape[1]
    logits, st = model.prefill(params, {"tokens": tokens, **(stub or {})})
    cache = land_prefill(tree_init(model.cache_defs(tokens.shape[0], S + n), 0,
                                   device=tokens.device), st)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = []
    for i in range(n):
        out.append(tok)
        dl, cache = model.decode_step(params, cache, S + i, tok)
        tok = torch.argmax(dl[:, -1:], dim=-1)
    return logits, torch.cat(out, 1)


def _smoke_card_vs_cpu(torch, dev, arch: str) -> dict:
    """The smoke config (seed-0 weights) on the card against the port on
    the CPU (plain kernels): every unit's prefill and decode on the same
    inputs within UNIT_TOL (:func:`unit_parity`); the whole prefill's
    logits and SMOKE_NEW greedy tokens reported beside them."""
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    model = build_model(smoke_config(get_config(arch)))
    p_cpu = tree_init(model.param_defs(), 0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    toks = np.random.default_rng(1).integers(1, model.cfg.vocab_size,
                                             size=(2, SMOKE_PROMPT))
    with torch.inference_mode():
        units = unit_parity(torch, model, p_gpu, torch.as_tensor(toks, device=dev),
                            cpu=p_cpu)
        lg, tg = _greedy(torch, model, p_gpu, torch.as_tensor(toks, device=dev), SMOKE_NEW)
        lc, tc = _greedy(torch, model, p_cpu, torch.as_tensor(toks), SMOKE_NEW)
    check(bool(torch.isfinite(lg).all()), f"{arch} smoke: finite logits on the card")
    return {"config": model.cfg.name, "unit_ratios": units,
            "prefill_logits_max_abs_err": float((lg.float().cpu() - lc.float()).abs().max()),
            "tokens_card": tg.cpu().tolist(), "tokens_cpu": tc.tolist(),
            "token_agreement": float((tg.cpu() == tc).float().mean())}


def _serve_state_model(torch, dev, smi: str, arch: str) -> dict:
    """`arch` at published width and depth, seed-0 weights: the prefill
    bundle on FAMILY_BATCH prompts of FAMILY_PROMPT tokens, its state landed
    in a FAMILY_CACHE cache, ``Server.generate`` of FAMILY_NEW greedy tokens;
    twice, the tokens the same.  Then :func:`unit_parity` on a
    PARITY_PROMPT-token prompt and the smoke config card against CPU."""
    import numpy as np
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config)
    from repro_torch.kernels import ops
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import Server, build_serve_step, land_prefill
    cfg = get_config(arch)
    rc = RunConfig(model=cfg, shape=ShapeConfig("serve", FAMILY_CACHE, FAMILY_BATCH,
                                                "decode"),
                   comm=CommConfig(), train=TrainConfig())
    pre = build_serve_step(rc, "prefill", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tree_init(pre.param_defs, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    server = Server(rc, params=params, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(FAMILY_BATCH, FAMILY_PROMPT)), device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, state = pre.fn(params, {"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            cache = land_prefill(server.init_cache(), state)
        del state
        first = torch.argmax(logits[:, -1:], dim=-1).cpu().numpy()
        t2 = time.perf_counter()
        res = server.generate(first, max_new=FAMILY_NEW, prefill_pos=FAMILY_PROMPT,
                              cache=cache)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = ops.launch_counts()
        check(bool(torch.isfinite(logits).all()), f"{arch}: finite prefill logits")
        check(res.tokens.shape == (FAMILY_BATCH, FAMILY_NEW)
              and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
              f"{arch}: {FAMILY_NEW} token ids a row")
        check(launches["rmsnorm"] > 0, f"{arch}: rmsnorm launched {launches}")
        if cfg.family == "hybrid":
            check(launches["flash_attention"] > 0, f"{arch}: flash launched {launches}")
        runs.append({"tokens": res.tokens, "launches": launches,
                     "prefill_ms": 1e3 * (t1 - t0), "land_ms": 1e3 * (t2 - t1),
                     "decode_ms_per_token": 1e3 * (t3 - t2) / FAMILY_NEW,
                     "tokens_per_s": FAMILY_BATCH * FAMILY_NEW / (t3 - t2)})
        del cache, logits
    check(np.array_equal(runs[0]["tokens"], runs[1]["tokens"]),
          f"{arch}: the same tokens on a second run")
    with torch.inference_mode():
        parity = unit_parity(torch, pre.model, params,
                             prompts[:PARITY_ROWS, :PARITY_PROMPT])
        whole = whole_model_f32(torch, pre.model, params,
                                prompts[:PARITY_ROWS, :PARITY_PROMPT])
    out = {"arch": arch, "family": cfg.family, "card": smi,
           "params": int(sum(x.numel() for x in _leaves(params))),
           "param_init_s": init_s, "batch": FAMILY_BATCH, "prompt": FAMILY_PROMPT,
           "cache": FAMILY_CACHE, "new_tokens": FAMILY_NEW,
           "runs": [{k: v for k, v in r.items() if k != "tokens"} for r in runs],
           "tokens_same_on_second_run": True,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "unit_parity": parity, "unit_tolerance": {"bf16": UNIT_TOL, "f32": F32_TOL},
           "whole_model_f32_rel_l2": whole, "whole_model_f32_tolerance": WHOLE_F32_TOL,
           "smoke_card_vs_cpu": _smoke_card_vs_cpu(torch, dev, arch)}
    del server, params, pre
    torch.cuda.empty_cache()
    return out


def moe_layer_check(torch, dev) -> dict:
    """The smoke config's MoE layer (seed-0 weights, f32) on the card
    against the CPU on the same inputs, within MOE_LAYER_TOL: router columns
    made equal in pairs (every token's logits tie exactly, on both), and
    capacity_factor 0.5 (assignments dropped at capacity); the expert ids,
    the kept slots and the drop count equal on both."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.models.param import tree_init
    cfg = smoke_config(get_config(MOE_ARCH))
    p = tree_init(build_model(cfg).param_defs(), 0, device="cpu")
    lp = {k: v[0].float() for k, v in p["blocks"]["ffn"].items()}
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator().manual_seed(5))
    tied = lp["router"].clone()
    tied[:, 2], tied[:, 3] = tied[:, 1], tied[:, 0]
    out = {}
    for case, router, mcfg in (
            ("tied_router", tied, cfg.moe),
            ("drops", lp["router"], dataclasses.replace(cfg.moe, capacity_factor=0.5))):
        res = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            lpd = {k: (router if k == "router" else v).to(d) for k, v in lp.items()}
            xd = x.to(d)
            y, aux = moe.moe_ffn(lpd, xd, mcfg)
            T = x.shape[0] * x.shape[1]
            _, _, ids = moe.route((xd.reshape(T, -1) @ lpd["router"]).float(), mcfg.top_k)
            _, keep = moe.slots(ids, mcfg.num_experts, moe.capacity(mcfg, T))
            res[where] = (y.cpu(), aux.cpu(), ids.cpu(), keep.cpu())
        (yg, ag, ig, kg), (yc, ac, ic, kc) = res["card"], res["cpu"]
        r = max(_ratio(yg, yc, MOE_LAYER_TOL), _ratio(ag, ac, MOE_LAYER_TOL))
        dropped = int((~kc).sum())
        check(r <= 1.0, f"moe {case}: card within {MOE_LAYER_TOL} of the CPU ({r})")
        check(torch.equal(ig, ic) and torch.equal(kg, kc),
              f"moe {case}: expert ids and kept slots the CPU's")
        if case == "drops":
            check(dropped > 0, "moe drops: assignments dropped at capacity 0.5")
        else:
            check(bool((ig[:, 0] < ig[:, 1]).all()), "moe tied_router: ties to the lower id")
        out[case] = {"ratio": r, "dropped": dropped, "assigned": int(kc.numel()),
                     "capacity": moe.capacity(mcfg, x.shape[0] * x.shape[1])}
    return out


# whisper-medium (encoder-decoder) and pixtral-12b (vision prefix): arch ->
# (prompt tokens, decode cache).  Whisper: 256-token prompts in its published
# 448-token decoder context, 1500 source frames; pixtral: 1024 patch
# embeddings and 1024 tokens in a 3072-token cache.
PREFIX_ARCHS = {"whisper-medium": (256, 448), "pixtral-12b": (1024, 3072)}
# the whole-model f32 check's depth where the f32 copy beside the bf16 model
# must be cut: pixtral at 16 of 40 layers is ~22.9 GB of f32 parameters
PREFIX_F32_LAYERS = {"pixtral-12b": 16}
PREFIX_TAIL = 16              # prompt tokens decoded one by one in that check


def prefix_launches(cfg) -> dict:
    """Kernel launches of one request set of :func:`_serve_prefix_model`: a
    prefill (flash for every attention: the encoder's, the decoder's and
    the cross-attention's; rmsnorm for each block's norms and the final
    ones, the rows of a call in one launch) and FAMILY_NEW decode steps
    (rmsnorm only: decode's attention is plain torch)."""
    L, E = cfg.num_layers, cfg.encoder_layers
    per_block = 3 if E else 2
    rms_step = L * per_block + 1
    return {"flash_attention": E + L * (2 if E else 1),
            "rmsnorm": (2 * E + 1 if E else 0) + rms_step * (1 + FAMILY_NEW)}


@contextlib.contextmanager
def plain_attention():
    """Attention's plain version (``impl="plain"``) on the card inside this
    block, for the whole-model checks in f32: the flash kernel takes bf16
    only.  rmsnorm's kernel has f32 entries and keeps running."""
    from repro_torch.kernels import ops
    kernel = ops.flash_attention
    ops.flash_attention = functools.partial(kernel, impl="plain")
    try:
        yield
    finally:
        ops.flash_attention = kernel


def prefix_whole_f32(torch, model, params, batch, layers=None) -> dict:
    """The whole model in f32 on the card (`params` cast; the first `layers`
    decoder layers where the f32 copy must be cut), on PARITY_ROWS rows of
    `batch`: the last logits of one prefill of the stub inputs and the
    prompt against those of a prefill of all but the last PREFIX_TAIL prompt
    tokens followed by as many ``decode_step``s, within WHOLE_F32_TOL
    relative L2.  A wrong prefix offset, sinusoidal position or
    cross-attention cache moves them by O(1).  Beside it, how far one f32
    ulp of noise in the token embeddings moves the full prefill's logits:
    the model's own amplification of a rounding."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import land_prefill
    cfg = model.cfg
    if layers is not None:
        model = build_model(dataclasses.replace(cfg, num_layers=layers))

    def cast(tree, cut):
        if isinstance(tree, dict):
            return {k: cast(v, cut or k == "blocks") for k, v in tree.items()}
        return (tree[:layers] if cut and layers is not None else tree).float()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    p32 = cast(params, False)
    rows = {k: v[:PARITY_ROWS] for k, v in batch.items()}
    toks = rows["tokens"]
    B, S = toks.shape
    n0 = model.cfg.vision_tokens
    with plain_attention(), torch.inference_mode():
        lf, _ = model.prefill(p32, rows)
        cache = {n: v.float() for n, v in tree_init(
            model.cache_defs(B, n0 + S), 0, device=toks.device).items()}
        land_prefill(cache, model.prefill(
            p32, {**rows, "tokens": toks[:, :S - PREFIX_TAIL]})[1])
        for i in range(S - PREFIX_TAIL, S):
            ld, cache = model.decode_step(p32, cache, n0 + i, toks[:, i:i + 1])
        del cache
        g = torch.Generator(device=toks.device).manual_seed(3)
        noisy = torch.randn(p32["embed"].shape, generator=g, device=toks.device)
        noisy.sign_().mul_(2.0 ** -24).add_(1.0).mul_(p32["embed"])
        ln, _ = model.prefill({**p32, "embed": noisy}, rows)
        del noisy
    out = {"layers": model.cfg.num_layers, "rows": B, "prompt": S, "prefix": n0,
           "decoded": PREFIX_TAIL,
           "decode_vs_prefill_card": _rel_l2(ld[:, -1], lf[:, -1]),
           "one_ulp_embedding_noise_card": _rel_l2(ln[:, -1], lf[:, -1]),
           "same_argmax": bool(torch.equal(ld[:, -1].argmax(-1), lf[:, -1].argmax(-1))),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del p32
    torch.cuda.empty_cache()
    check(out["decode_vs_prefill_card"] <= WHOLE_F32_TOL,
          f"{cfg.name}: whole model in f32, decode against prefill "
          f"{out['decode_vs_prefill_card']} <= {WHOLE_F32_TOL}")
    return out


def _smoke_prefix_card_vs_cpu(torch, dev, arch: str) -> dict:
    """The smoke config (seed-0 bf16 weights, seeded stub inputs) on the
    card against the port on the CPU (plain kernels): the prefill's logits
    within UNIT_TOL, absolute and relative; SMOKE_NEW greedy tokens beside
    them."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import batch_concrete, build_model
    from repro_torch.models.param import tree_init
    model = build_model(smoke_config(get_config(arch)))
    p_cpu = tree_init(model.param_defs(), 0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    batch = batch_concrete(model.cfg, "prefill", 2, SMOKE_PROMPT, seed=1, device="cpu")
    stub = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.inference_mode():
        lg, tg = _greedy(torch, model, p_gpu, batch["tokens"].to(dev), SMOKE_NEW,
                         _to(stub, dev))
        lc, tc = _greedy(torch, model, p_cpu, batch["tokens"], SMOKE_NEW, stub)
    r = _ratio(lg, lc, UNIT_TOL)
    check(bool(torch.isfinite(lg).all()), f"{arch} smoke: finite logits on the card")
    check(r <= 1.0, f"{arch} smoke: prefill logits card within {UNIT_TOL} of the CPU ({r})")
    return {"config": model.cfg.name, "prefill_logits_ratio": r,
            "prefill_logits_max_abs_err": float((lg.float().cpu() - lc.float()).abs().max()),
            "tokens_card": tg.cpu().tolist(), "tokens_cpu": tc.tolist(),
            "token_agreement": float((tg.cpu() == tc).float().mean())}


def _serve_prefix_model(torch, dev, smi: str, arch: str) -> dict:
    """`arch` at published width and depth, seed-0 weights: the prefill
    bundle on FAMILY_BATCH requests (seeded stub inputs and prompts of
    PREFIX_ARCHS' length), its cache landed in a decode cache of
    PREFIX_ARCHS' length, ``Server.generate`` of FAMILY_NEW greedy tokens
    from position n_prefix + prompt; twice, the tokens the same, the kernel
    launches :func:`prefix_launches`' each time.  Then the whole model in
    f32 (:func:`prefix_whole_f32`) and the smoke config card against CPU."""
    from repro_torch.configs import (CommConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config)
    from repro_torch.kernels import ops
    from repro_torch.models import batch_concrete
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import Server, build_serve_step, land_prefill
    import numpy as np
    cfg = get_config(arch)
    prompt, cache_len = PREFIX_ARCHS[arch]
    rc = RunConfig(model=cfg, shape=ShapeConfig("serve", cache_len, FAMILY_BATCH, "decode"),
                   comm=CommConfig(), train=TrainConfig())
    pre = build_serve_step(rc, "prefill", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tree_init(pre.param_defs, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    server = Server(rc, params=params, device=dev)
    batch = batch_concrete(cfg, "prefill", FAMILY_BATCH, prompt, seed=0, device=dev)
    pos0 = cfg.vision_tokens + prompt
    want = prefix_launches(cfg)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, state = pre.fn(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            cache = land_prefill(server.init_cache(), state)
        del state
        first = torch.argmax(logits[:, -1:], dim=-1).cpu().numpy()
        t2 = time.perf_counter()
        res = server.generate(first, max_new=FAMILY_NEW, prefill_pos=pos0, cache=cache)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = ops.launch_counts()
        check(bool(torch.isfinite(logits).all()), f"{arch}: finite prefill logits")
        check(res.tokens.shape == (FAMILY_BATCH, FAMILY_NEW)
              and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
              f"{arch}: {FAMILY_NEW} token ids a row")
        check(all(launches[k] == n for k, n in want.items()),
              f"{arch}: launches {launches}, the path's {want}")
        run = {"tokens": res.tokens, "launches": launches,
               "prefill_ms": 1e3 * (t1 - t0), "land_ms": 1e3 * (t2 - t1),
               "decode_ms_per_token": 1e3 * (t3 - t2) / FAMILY_NEW,
               "tokens_per_s": FAMILY_BATCH * FAMILY_NEW / (t3 - t2)}
        if cfg.encoder_layers:        # the encoder alone, after the counted run
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            with torch.inference_mode():
                pre.model._encode(params, batch)
            torch.cuda.synchronize()
            run["encoder_ms"] = 1e3 * (time.perf_counter() - t4)
        runs.append(run)
        del cache, logits
    check(np.array_equal(runs[0]["tokens"], runs[1]["tokens"]),
          f"{arch}: the same tokens on a second run")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del server
    whole = prefix_whole_f32(torch, pre.model, params, batch, PREFIX_F32_LAYERS.get(arch))
    out = {"arch": arch, "family": cfg.family, "card": smi,
           "params": int(sum(x.numel() for x in _leaves(params))),
           "config_param_count": cfg.param_count(), "param_init_s": init_s,
           "batch": FAMILY_BATCH, "prompt": prompt, "prefix": cfg.vision_tokens,
           "source_frames": cfg.source_len if cfg.encoder_layers else 0,
           "cache": cache_len, "new_tokens": FAMILY_NEW, "decode_from": pos0,
           "runs": [{k: v for k, v in r.items() if k != "tokens"} for r in runs],
           "tokens_same_on_second_run": True, "launches_per_request_set": want,
           "peak_mem_gb": peak,
           "whole_model_f32_rel_l2": whole, "whole_model_f32_tolerance": WHOLE_F32_TOL}
    del params, pre, batch
    torch.cuda.empty_cache()
    out["smoke_card_vs_cpu"] = _smoke_prefix_card_vs_cpu(torch, dev, arch)
    return out


def phase_families(torch, dev, smi: str) -> dict:
    """mamba2-780m and zamba2-1.2b at published width and depth
    (:func:`_serve_state_model`); phi3.5-moe-42b-a6.6b at published width, 8
    of its 32 layers, through the ServingEngine mono, disagg and
    disagg-int8 (:func:`phase_engine`'s checks on 8 requests: mono and
    disagg bit for bit, all four kernels in the int8 run; where int8 departs
    from mono, :func:`int8_departures`) and its MoE layer against the CPU
    (:func:`moe_layer_check`); whisper-medium and pixtral-12b at published
    width and depth (:func:`_serve_prefix_model`).  Kernel counts reset
    before each run."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    out = {}
    for arch in STATE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _serve_state_model(torch, dev, smi, arch)
        out[arch]["phase_s"] = time.perf_counter() - t0
        emit({"phase": "families", **out[arch]})
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    params = tree_init(build_model(cfg).param_defs(), 0, device=dev)
    eng, _ = phase_engine(torch, dev, cfg, params, n_requests=MOE_REQUESTS,
                          phase="families_engine", trace=True)
    del params
    torch.cuda.empty_cache()
    moe_row = {"arch": MOE_ARCH, "family": "moe", "card": smi, "layers": MOE_LAYERS,
               **eng, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "moe_layer_card_vs_cpu": moe_layer_check(torch, dev),
               "phase_s": time.perf_counter() - t0}
    emit({"phase": "families", **moe_row})
    out[MOE_ARCH] = moe_row
    for arch in PREFIX_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _serve_prefix_model(torch, dev, smi, arch)
        out[arch]["phase_s"] = time.perf_counter() - t0
        emit({"phase": "families", **out[arch]})
    return out


# ---------------------------------------------------------------------------
# families_train: the ssm, hybrid, moe, audio and vlm families' training step
# across 2 pods
# ---------------------------------------------------------------------------

FAMILY_TRAIN_STEPS = 3
# one run a family at published width and, where two ranks' peaks would
# outgrow ~72 GB of the card, fewer layers: (name, arch, layers, encoder
# layers, seq_len, global batch, codec); None keeps the published depth.
# The depths come from tools/train_family_memory.py (each family's peak a
# rank at two depths, extrapolated per layer; PERF.md section 4): phi3.5-moe
# takes 29.9 GB a rank at 1 layer and does not fit 2, pixtral-12b 31.8 GB at
# 1 layer and 36.8 at 2.  4096 tokens a pod for mamba2, zamba2 and
# phi3.5-moe; 8 sequences of whisper's 448-token context a pod over 1500
# frames each; one pixtral sequence a pod of 1024 patch embeddings and 3072
# tokens
FAMILY_TRAIN_RUNS = (
    ("mamba2-780m", "mamba2-780m", None, None, 4096, 2, "none"),
    ("zamba2-1.2b", "zamba2-1.2b", None, None, 4096, 2, "none"),
    ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", 1, None, 4096, 2, "none"),
    ("whisper-medium", "whisper-medium", None, None, 448, 16, "none"),
    ("whisper-medium-int8", "whisper-medium", None, None, 448, 16, "int8"),
    ("pixtral-12b", "pixtral-12b", 1, None, 3072, 2, "none"),
)
# the audio family under 2 x 2 ZeRO-3 (four ranks; the encoder's layers
# gathered one by one inside their checkpoints), at 6 + 6 of its 24 + 24
# layers: its in-pod stages make a step ~16 s at full depth
FAMILY_ZERO_RUN = ("whisper-medium-zero", "whisper-medium", 6, 6, 448, 16, "none")


def _family_run(row) -> dict:
    name, arch, layers, enc, seq, gb, codec = row
    return {"name": name, "arch": arch, "layers": layers, "encoder_layers": enc,
            "seq_len": seq, "global_batch": gb, "codec": codec,
            "steps": FAMILY_TRAIN_STEPS}


def family_train_config(run: dict):
    """The run's model config: published widths, its depth cut where the run
    says (``layers``, ``encoder_layers``)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(run["arch"])
    over = {f: run[k] for k, f in (("layers", "num_layers"),
                                   ("encoder_layers", "encoder_layers")) if run.get(k)}
    return dataclasses.replace(cfg, **over)


def family_train_launches(cfg) -> dict:
    """Kernel launches of one training step of `cfg` on one rank (one
    microbatch; every layer under its checkpoint, as the published configs
    run, so its forward runs again in the backward): each rmsnorm and
    attention of a layer twice, each attention's backward once, the final
    norms once; rmsnorm's backward is plain torch.  ssm: a norm a layer;
    hybrid: the shared block (2 norms, 1 attention) after every
    ``attn_every``-th layer, inside that layer's checkpoint; audio: 2 norms
    and 1 attention an encoder layer, 3 norms and 2 attentions (self and
    cross) a decoder layer, and the encoder's final norm; the rest 2 norms
    and 1 attention a layer."""
    L, E = cfg.num_layers, cfg.encoder_layers
    if cfg.family == "ssm":
        return {"rmsnorm": 2 * L + 1, "flash_attention": 0, "flash_attention_bwd": 0}
    if cfg.family == "hybrid":
        n = sum(1 for i in range(L) if i % cfg.attn_every == cfg.attn_every - 1)
        return {"rmsnorm": 2 * L + 4 * n + 1, "flash_attention": 2 * n,
                "flash_attention_bwd": n}
    if E:
        return {"rmsnorm": 4 * E + 1 + 6 * L + 1, "flash_attention": 2 * E + 4 * L,
                "flash_attention_bwd": E + 2 * L}
    return {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L, "flash_attention_bwd": L}


def _family_train_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One rank of 2 pods x ``spec["data"]`` data ranks.  First the launcher's
    runs ``spec["launcher"]`` (``launch.train.train_runs``, as the launcher's
    own spawn runs them, in the fresh process).  Then each run of
    ``spec["runs"]`` in turn: ``build_train_step`` at the run's config from
    seed 0, its steps on seeded global batches (``batch_concrete``, this
    rank's rows), kernel counts reset before each step; the last run's
    memory given back before the next.  Writes its report."""
    import torch
    from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core import telemetry as tel
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import batch_concrete
    from repro_torch.runtime.step import build_train_step
    from repro_torch.runtime.train_loop import replica_checksum
    world = 2 * spec["data"]
    dist, dev, mesh = _rank_setup(torch, rank, world, init, spec, pods=2,
                                  data=spec["data"])
    try:
        launcher.train_runs(spec["launcher"], rank)
        _free(torch, dev)
        row = mesh.pod_index * mesh.data + mesh.data_index
        rep = {"rank": rank, "pod_index": mesh.pod_index, "data_index": mesh.data_index,
               "runs": {}}
        report = os.path.join(out, f"{spec['label']}.rank{rank}.json")
        for run in spec["runs"]:
            cfg = family_train_config(run)
            gb, seq = run["global_batch"], run["seq_len"]
            lb = gb // world
            rc = RunConfig(model=cfg, shape=ShapeConfig("train", seq, gb, "train"),
                           comm=CommConfig(mode="hierarchical", compress=run["codec"]),
                           train=TrainConfig(lr=3e-4, total_steps=run["steps"],
                                             warmup_steps=1))
            tel.get_telemetry().reset()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            b = build_train_step(rc, mesh)
            state = b.init_state(0)
            plan = tel.get_telemetry().path(b.path.key).plan.__dict__
            init_s = time.perf_counter() - t0
            steps = []
            for i in range(run["steps"]):
                batch = batch_concrete(cfg, "train", gb, seq, seed=i, device=dev)
                batch = {k: v[row * lb:(row + 1) * lb] for k, v in batch.items()}
                ops.reset_launch_counts()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t = time.perf_counter()
                state, m = b.fn(state, batch)
                loss = float(m["loss"])
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t
                steps.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                              "aux_loss": float(m["aux_loss"]), "time_s": dt,
                              "sync_s": m["sync_s"], "n_chunks": len(m["chunks"]),
                              "wire_bytes": m["wire_bytes"], "sent_bytes": m["sent_bytes"],
                              "gather_s": m["gather_s"],
                              "reduce_scatter_s": m["reduce_scatter_s"],
                              "launches": ops.launch_counts(),
                              "checksum": replica_checksum(state["params"])})
                del batch, m
            rep["runs"][run["name"]] = {
                "steps": steps, "plan": plan, "init_s": init_s, "zero": b.zero,
                "params": cfg.param_count(), "layers": cfg.num_layers,
                "encoder_layers": cfg.encoder_layers,
                "tokens_per_rank": lb * seq,
                "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None)}
            del b, state
            _free(torch, dev)
            # after every run, so that a later run's failure keeps this one's
            with open(report, "w") as f:
                json.dump(rep, f)
        if not spec["runs"]:
            with open(report, "w") as f:
                json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def check_family_train(run: dict, reps: list, data: int) -> dict:
    """Checks of one run on every rank (``reps[r]["runs"][name]``): finite
    losses and grad norms (the MoE aux loss finite and above 0); the pods'
    parameters bit-identical after every step (under ZeRO each data index's
    shards); every step's chunks and wire bytes the plan's; each step's
    rmsnorm and flash launches :func:`family_train_launches`', quant and
    dequant with int8.  Returns the run's row: step and sync ms (median of
    steps 2-3, rank 0), tokens/s per pod, wire bytes a step, peak GB a rank,
    the depth."""
    import numpy as np
    name = run["name"]
    rs = [r["runs"][name] for r in reps]
    cfg = family_train_config(run)
    want = family_train_launches(cfg)
    plan = rs[0]["plan"]
    for r, x in enumerate(rs):
        check(x["plan"] == plan, f"{name}: rank {r}'s plan is rank 0's")
        for i, st in enumerate(x["steps"]):
            tag = f"{name} rank {r} step {i}"
            check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]),
                  f"{tag}: loss {st['loss']}, grad norm {st['grad_norm']} finite")
            check(st["loss"] == rs[0]["steps"][i]["loss"],
                  f"{tag}: the world's mean loss {st['loss']} is rank 0's")
            if cfg.moe is not None:
                check(math.isfinite(st["aux_loss"]) and st["aux_loss"] > 0,
                      f"{tag}: MoE aux loss {st['aux_loss']} finite and above 0")
            check(st["n_chunks"] == plan["n_chunks"]
                  and round(st["wire_bytes"]) == plan["wire_bytes"],
                  f"{tag}: {st['n_chunks']} chunks, {st['wire_bytes']} wire bytes "
                  f"against the plan's {plan['n_chunks']}, {plan['wire_bytes']}")
            la = st["launches"]
            check(all(la[k] == v for k, v in want.items()),
                  f"{tag}: launches {la}, the path's {want}")
            if run["codec"] == "int8":
                check(la["quant_int8"] > 0 and la["dequant_int8"] > 0,
                      f"{tag}: int8 codec launches {la}")
    for i in range(len(rs[0]["steps"])):
        sums = [x["steps"][i]["checksum"] for x in rs]
        same = [(0, 1)] if data == 1 else [(0, 2), (1, 3)]
        check(all(sums[a] == sums[b] for a, b in same),
              f"{name} step {i}: replicas' checksums {sums} (pods bit-identical)")
    later = rs[0]["steps"][1:]
    step_s = float(np.median([st["time_s"] for st in later]))
    tokens_pod = rs[0]["tokens_per_rank"] * data
    return {"name": name, "arch": run["arch"], "codec": run["codec"],
            "mesh": f"2 x {data}", "zero": rs[0]["zero"], "layers": rs[0]["layers"],
            "encoder_layers": rs[0]["encoder_layers"], "params": rs[0]["params"],
            "seq_len": run["seq_len"], "tokens_per_pod": tokens_pod,
            "step_ms_median_steps_2_3": 1e3 * step_s,
            "sync_ms_median_steps_2_3": 1e3 * float(np.median([st["sync_s"] for st in later])),
            "gather_ms_median_steps_2_3": 1e3 * float(np.median([st["gather_s"] for st in later])),
            "reduce_scatter_ms_median_steps_2_3": 1e3 * float(np.median(
                [st["reduce_scatter_s"] for st in later])),
            "tokens_per_s_per_pod": tokens_pod / step_s,
            "wire_bytes_per_step": rs[0]["steps"][-1]["wire_bytes"],
            "n_chunks": plan["n_chunks"],
            "losses": [st["loss"] for st in rs[0]["steps"]],
            "grad_norms": [st["grad_norm"] for st in rs[0]["steps"]],
            "aux_losses": [st["aux_loss"] for st in rs[0]["steps"]],
            "launches_per_step_rank0": rs[0]["steps"][-1]["launches"],
            "launches_rank0": {k: sum(st["launches"][k] for st in rs[0]["steps"])
                               for k in rs[0]["steps"][0]["launches"]},
            "peak_gb_by_rank": [None if x["peak_mem_bytes"] is None
                                else x["peak_mem_bytes"] / 1e9 for x in rs],
            "init_s_rank0": rs[0]["init_s"]}


def _spawn_family_train(torch, out_dir: str, runs: list, data: int, label: str,
                        launcher: list) -> list:
    """One spawn of 2 x `data` ranks on the card (:func:`_family_train_rank`:
    the parsed launcher runs `launcher`, then the family runs `runs`), with
    expandable segments, under a host memory watch; returns the ranks'
    reports."""
    watch = _MemWatch(label)
    try:
        with expandable_segments():
            return _spawn(torch, _family_train_rank, 2 * data, out_dir,
                          dict(FAMILY_TRAIN_SPEC, data=data, runs=runs, label=label,
                               launcher=launcher), label)
    finally:
        watch.stop()


FAMILY_TRAIN_SPEC = {"device": "cuda", "gloo_timeout_s": 900}


def phase_families_train(torch, out_dir: str, smi: str, phases) -> dict:
    """The 2-pod training spawns: 2 pods x 1 data rank, then 2 x 2 (two and
    four processes sharing the card, gloo pod groups, expandable segments,
    whichever phases are asked).  Each first runs the
    launcher's runs of the phases in `phases` that train on its mesh (2 x 1:
    train; 2 x 2: zero, buckets after it, then tp's 2 x 1 x 2 runs on a
    fresh mesh of the same four processes), which the phases then check
    (:func:`phase_train`, :func:`phase_zero`, :func:`phase_buckets`,
    :func:`phase_tp`); sharing
    the spawns saves starting each phase's ranks.  Then, with families_train
    in `phases`, the families: FAMILY_TRAIN_RUNS on 2 x 1, every family in
    turn at published width, FAMILY_TRAIN_STEPS steps each with the
    hierarchical psum (no codec; whisper-medium also int8), and
    FAMILY_ZERO_RUN on 2 x 2 ZeRO-3; :func:`check_family_train` on each.  A
    spawn with nothing to run is not started."""
    from repro_torch.launch import train as launcher
    fam = "families_train" in phases
    meshes = [
        (1, "ftrain", train_specs() if "train" in phases
         else train_specs()[:1] if "tp" in phases else [],
         [_family_run(r) for r in FAMILY_TRAIN_RUNS] if fam else []),
        (2, "fzero", (zero_specs() if "zero" in phases or "buckets" in phases else [])
         + (bucket_specs() if "buckets" in phases else [])
         + (tp_specs() if "tp" in phases else []),
         [_family_run(FAMILY_ZERO_RUN)] if fam else [])]
    out = {}
    for data, label, specs, runs in meshes:
        if not (specs or runs):
            continue
        t0 = time.perf_counter()
        parsed = launcher.parse_runs(_launcher_argv(specs, out_dir)) if specs else []
        reps = _spawn_family_train(torch, out_dir, runs, data, label, parsed)
        for run in runs:
            out[run["name"]] = dict(check_family_train(run, reps, data), card=smi)
            emit({"phase": "families_train", **out[run["name"]]})
        out[f"spawn_2x{data}_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# tp: tensor and expert parallelism on the model axis
# ---------------------------------------------------------------------------

# qwen1.5-0.5b on 2 pods x 1 data rank x 2 model ranks through the launcher
# (its --model flag), in phase_families_train's 2 x 2 spawn after the zero
# and buckets runs: 3 steps with no codec and with int8 at its 24 layers on
# the train phase's batch (one 4096-token sequence a pod), whose no-codec
# 2 x 1 step-1 loss the TP run's is held to (TP_LOSS_TOL: the first-step
# bf16 bound of tests/test_torch_train_step.py); with tp asked and train
# not, that 2 x 1 run is queued all the same
TP_CODECS = ("none", "int8")
TP_LOSS_TOL = 5e-3
TP_ARGS = TRAIN_ARGS + ["--ranks", "4", "--model", "2"]
# serving on 1 x 1 x 2 (two processes on the card): (arch, layers; None keeps
# the published depth), TP_REQUESTS prompts of TP_PROMPT tokens, TP_NEW
# greedy tokens; phi3.5-moe at the families phase's 8 of 32 layers
TP_SERVE = (("llama3.2-3b", None), ("phi3.5-moe-42b-a6.6b", MOE_LAYERS))
TP_REQUESTS, TP_PROMPT, TP_NEW = 8, 1024, 64
TP_WARM = 64
# the f32 gate: TP_F32_ROWS prompts of TP_F32_TOKENS tokens decoded token by
# token from an empty cache (decode's attention is plain f32 torch), the
# last logits against one rank's; phi3.5-moe's f32 copies at 4 layers (two
# of 8 layers would hold 42 GB at once)
TP_F32_ROWS, TP_F32_TOKENS = 2, 16
TP_F32_LAYERS = {"phi3.5-moe-42b-a6.6b": 4}
# phi3.5-moe's training step on 1 x 1 x 2: 3 of its 32 layers, the deepest
# whose two ranks fit the card (tools/train_family_memory.py --model 2: a
# rank's peak 2.84 GB + 10.40 GB a layer), one 4096-token sequence, 3 steps
TP_TRAIN = ("phi3.5-moe-42b-a6.6b", 3, 4096)
TP_TRAIN_STEPS = 3
TP_SPEC = {"device": "cuda", "gloo_timeout_s": 900}
# the model group's collectives: the median of TP_TIMING_REPS calls each (a
# prefill-sized all-reduce through the host takes ~0.1 s)
TP_TIMING_REPS = 5


def tp_specs() -> list:
    return [(c, TP_ARGS, "tp", None) for c in TP_CODECS]


def tp_config(arch: str, layers=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def replicated_bytes(cfg, tp: int) -> int:
    """f32 bytes of the leaves whole on every model rank (no TP dim): each
    model rank moves all of their chunks and its part of the others'."""
    from repro_torch.core.tree import flatten
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_tp_dims
    defs = build_model(cfg).param_defs()
    return sum(4 * math.prod(pd.shape) for pd, t in zip(
        flatten(defs)[0], flatten(tree_tp_dims(defs, tp))[0]) if t is None)


def _check_tp_run(codec: str, rep: str, smi: str) -> dict:
    """Check one 2 x 1 x 2 launcher run's four reports: the plan the same on
    every rank; every step's loss finite and equal on every rank; every
    step's chunks the plan's and the two model ranks' payload and wire bytes
    the plan's plus the replicated leaves' once more (each moves its part of
    a sharded leaf's chunk, all of a replicated one's); each model index's
    parameters bit-identical across the pods after every step; rmsnorm and
    the flash forward and backward launched as a step of the model needs
    (``family_train_launches``), quant and dequant with int8 only.  Returns
    the run's numbers."""
    import numpy as np
    reps = [json.load(open(f"{rep}.rank{r}.json")) for r in range(4)]
    r0 = reps[0]
    plan = r0["plan"]
    cfg = tp_config("qwen1.5-0.5b", r0["layers"])
    rep_bytes = replicated_bytes(cfg, 2)
    ratio = plan["wire_bytes"] / plan["payload_bytes"]
    want = {k: v * len(r0["history"]) for k, v in family_train_launches(cfg).items()}
    tag = f"tp {codec}"
    by = {(rp["pod_index"], rp["model_index"]): rp for rp in reps}
    for r, rp in enumerate(reps):
        check(rp["plan"] == plan and rp["model"] == 2, f"{tag}: rank {r}'s plan is rank 0's")
        la = rp["launches"]
        check(all(la[k] == v for k, v in want.items()),
              f"{tag} rank {r}: launches {la}, the path's {want}")
        check((la["quant_int8"] > 0 and la["dequant_int8"] > 0) == (codec == "int8"),
              f"{tag} rank {r}: codec launches {la}")
        for i, h in enumerate(rp["history"]):
            check(math.isfinite(h["loss"]) and h["loss"] == r0["history"][i]["loss"],
                  f"{tag} rank {r} step {i}: loss {h['loss']} finite, rank 0's")
            check(h["n_chunks"] == plan["n_chunks"], f"{tag} rank {r} step {i}: "
                  f"{h['n_chunks']} chunks, the plan's {plan['n_chunks']}")
    for p in range(2):
        for i in range(len(r0["history"])):
            a, b = by[(p, 0)]["history"][i], by[(p, 1)]["history"][i]
            check(a["payload_bytes"] + b["payload_bytes"] - rep_bytes == plan["payload_bytes"]
                  and round(a["wire_bytes"] + b["wire_bytes"] - rep_bytes * ratio)
                  == plan["wire_bytes"],
                  f"{tag} pod {p} step {i}: model ranks' payload {a['payload_bytes']} + "
                  f"{b['payload_bytes']}, wire {a['wire_bytes']} + {b['wire_bytes']} "
                  f"against the plan {plan} and {rep_bytes} replicated bytes")
    for m in range(2):
        sums = [[h["checksum"] for h in by[(p, m)]["history"]] for p in range(2)]
        check(sums[0] == sums[1], f"{tag}: model index {m}'s parameters bit-identical "
              f"across pods after every step {sums}")
    h = r0["history"][1:3]
    step_s = float(np.median([x["time_s"] for x in h]))
    tokens = r0["seq_len"] * r0["global_batch"] // r0["pods"]
    return {"mesh": "2x1x2", "codec": codec, "card": smi, "layers": r0["layers"],
            "losses": [x["loss"] for x in r0["history"]],
            "grad_norms": [x["grad_norm"] for x in r0["history"]],
            "step_ms_median_steps_2_3": 1e3 * step_s,
            "tokens_per_s_per_pod": tokens / step_s,
            "sync_ms_median_steps_2_3": 1e3 * float(np.median([x["sync_s"] for x in h])),
            "wire_bytes_per_step_by_rank": [rp["history"][-1]["wire_bytes"] for rp in reps],
            "sent_bytes_per_step_by_rank": [rp["history"][-1]["sent_bytes"] for rp in reps],
            "plan": plan, "replicated_bytes": rep_bytes,
            "peak_gb_by_rank": [(rp["peak_mem_bytes"] or 0) / 1e9 for rp in reps],
            "launches_rank0": r0["launches"], "run_s": r0["run_s"]}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _group_ms(torch, dev, fn, x) -> float:
    """Median host ms of `fn(x)` over TP_TIMING_REPS calls, each from a
    device sync to a device sync (every model rank calls it in step)."""
    import numpy as np
    fn(x)
    out = []
    for _ in range(TP_TIMING_REPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn(x)
        _sync(torch, dev)
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def _greedy_trace(torch, model, params, prompts, n: int, cache):
    """Prefill, land into `cache`, `n` greedy decode steps: (prefill ms,
    decode ms, the (B, n + 1) tokens, each step's top-1 minus top-2 logit
    (B, n + 1))."""
    from repro_torch.runtime import land_prefill
    dev = prompts.device
    with torch.inference_mode():
        _sync(torch, dev)
        t0 = time.perf_counter()
        logits, st = model.prefill(params, {"tokens": prompts})
        _sync(torch, dev)
        t1 = time.perf_counter()
        land_prefill(cache, st)
        del st
        toks, margins = [], []
        lg = logits
        for i in range(n + 1):
            top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            tok = torch.argmax(lg[:, -1:], dim=-1)
            toks.append(tok)
            if i < n:
                lg, cache = model.decode_step(params, cache, prompts.shape[1] + i, tok)
        _sync(torch, dev)
        t2 = time.perf_counter()
    return (1e3 * (t1 - t0), 1e3 * (t2 - t1), torch.cat(toks, 1).cpu(),
            torch.stack(margins, 1).cpu())


def _f32_decode(torch, model, params, tokens):
    """The model decoding `tokens` (B, S) token by token from an empty f32
    cache with f32 parameters: the last step's logits."""
    from repro_torch.models.param import tree_init
    B, S = tokens.shape
    cache = {k: v.float() for k, v in tree_init(model.cache_defs(B, S), 0,
                                                   device=tokens.device).items()}
    with torch.inference_mode():
        for t in range(S):
            ld, cache = model.decode_step(params, cache, t, tokens[:, t:t + 1])
    return ld[:, -1].float().cpu()


@contextlib.contextmanager
def moe_probe(slices: int = 1):
    """Inside this block the MoE layer counts its dropped (token, choice)
    pairs into the dict it yields (``dropped`` of ``assigned``, and under
    ``by_tokens`` by the token count of the call: a prefill's, a decode
    step's).  With `slices` > 1 the layer on one rank routes each of
    `slices` equal pieces of a sequence that splits on its own, with that
    piece's capacity: the semantics of ``moe_ep`` on `slices` model ranks,
    from the plain scatter path (a sequence that does not split, a decode
    step, takes the unsharded layer, as ``moe_ep``'s fallback does)."""
    import torch
    from repro_torch.models import moe
    real_slots, real_ffn = moe.slots, moe.moe_ffn
    seen = {"dropped": 0, "assigned": 0, "by_tokens": {}}

    def slots(ids, E, C):
        pos, keep = real_slots(ids, E, C)
        dropped = int((~keep).sum())
        seen["dropped"] += dropped
        seen["assigned"] += keep.numel()
        by = seen["by_tokens"].setdefault(ids.shape[0], [0, 0])
        by[0] += dropped
        by[1] += keep.numel()
        return pos, keep

    def sliced(p, x, cfg, tp=None):
        if x.shape[1] % slices:
            return real_ffn(p, x, cfg, tp)
        outs = [real_ffn(p, xs, cfg, tp) for xs in x.chunk(slices, dim=1)]
        return torch.cat([y for y, _ in outs], 1), sum(a for _, a in outs) / slices

    moe.slots = slots
    if slices > 1:
        moe.moe_ffn = sliced
    try:
        yield seen
    finally:
        moe.slots, moe.moe_ffn = real_slots, real_ffn


def _f32_prefill(torch, model, params, tokens):
    """The last logits of the model's prefill of `tokens` with f32
    parameters, attention on its plain version (the flash kernel takes bf16
    only), and the MoE layer's dropped pairs: (logits, drops)."""
    with plain_attention(), moe_probe() as drops, torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": tokens})
    return logits[:, -1].float().cpu(), drops


def _departures(same, margins) -> list:
    """The first step at which each request's tokens depart (`same`, (B, n)
    booleans), with the one-rank run's top-1 minus top-2 margin there."""
    import numpy as np
    out = []
    for b in range(same.shape[0]):
        off = np.nonzero(~same[b])[0]
        if len(off):
            out.append({"request": b, "step": int(off[0]),
                        "one_rank_margin": float(margins[b, off[0]])})
    return out


def _tp_serve(torch, dist, dev, mesh, arch: str, layers) -> dict:
    """One arch of the tp spawn's serving: the TP run (prefill bundle,
    ``land_prefill``, ``Server.generate``) with its launches and times, the
    model group's collectives at the path's shapes, then on rank 0 the same
    requests on one rank (the same seed-0 weights) for the share of equal
    greedy tokens and the margins where they depart (for the MoE family
    also against one rank with ``moe_ep``'s local capacity in the prefill,
    :func:`moe_probe`); then the f32 gates: the TP decode token by token,
    and the TP prefill of the requests at the path's shape, each against
    one rank's (the prefill against the local capacity's for the MoE
    family, with each side's dropped pairs)."""
    import numpy as np
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core.collectives import tp_all_to_all, tp_reduce
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    from repro_torch.runtime import Server, build_serve_step, land_prefill
    cfg = tp_config(arch, layers)
    rank = dist.get_rank()
    g = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (TP_REQUESTS, TP_PROMPT), generator=g,
                            device=dev)
    rc_p = RunConfig(model=cfg, shape=ShapeConfig("p", TP_PROMPT, TP_REQUESTS, "prefill"))
    rc_d = RunConfig(model=cfg, shape=ShapeConfig("d", TP_PROMPT + TP_NEW, TP_REQUESTS,
                                                  "decode"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = Server(rc_d, seed=0, mesh=mesh)
    pb = build_serve_step(rc_p, "prefill", mesh=mesh)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    # warm-up: a prefill of every prompt's first TP_WARM tokens and one
    # decode step, so that the timed run pays no first-call costs
    warm = server.init_cache()
    _, st = pb.fn(server.params, {"tokens": prompts[:, :TP_WARM]})
    land_prefill(warm, st)
    server.bundle.fn(server.params, warm, TP_WARM, prompts[:, TP_WARM:TP_WARM + 1])
    del warm, st
    cache = server.init_cache()
    ops.reset_launch_counts()
    _sync(torch, dev)
    t0 = time.perf_counter()
    logits, st = pb.fn(server.params, {"tokens": prompts})
    _sync(torch, dev)
    t1 = time.perf_counter()
    land_prefill(cache, st)
    del st
    tok0 = torch.argmax(logits[:, -1:], dim=-1)
    res = server.generate(tok0.cpu().numpy(), max_new=TP_NEW, prefill_pos=TP_PROMPT,
                          cache=cache)
    _sync(torch, dev)
    t2 = time.perf_counter()
    prefill_ms, decode_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
    launches = ops.launch_counts()
    tp_tokens = np.concatenate([tok0.cpu().numpy(), res.tokens], 1)
    del cache, logits
    serve_s = time.perf_counter() - t0
    d = cfg.d_model
    coll = {"allreduce_decode_ms": _group_ms(
                torch, dev, lambda x: tp_reduce(x, mesh.model_group),
                torch.ones(TP_REQUESTS, 1, d, dtype=torch.bfloat16, device=dev)),
            "allreduce_prefill_ms": _group_ms(
                torch, dev, lambda x: tp_reduce(x, mesh.model_group),
                torch.ones(TP_REQUESTS, TP_PROMPT, d, dtype=torch.bfloat16, device=dev))}
    if cfg.moe is not None:
        from repro_torch.models.moe import capacity
        E = cfg.moe.num_experts
        C = capacity(cfg.moe, TP_REQUESTS * TP_PROMPT // 2)
        coll["all_to_all_prefill_ms"] = _group_ms(
            torch, dev, lambda x: tp_all_to_all(x, mesh.model_group),
            torch.ones(2, E // 2, C, d, dtype=torch.bfloat16, device=dev))
        coll["all_to_all_prefill_shape"] = [2, E // 2, C, d]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    del server, pb
    _free(torch, dev)
    # the same requests on one rank, while rank 1 waits
    t0 = time.perf_counter()
    one = None
    if rank == 0:
        model = build_model(cfg)
        params = tree_init(model.param_defs(), 0, device=dev)
        cache = tree_init(model.cache_defs(TP_REQUESTS, TP_PROMPT + TP_NEW), 0, device=dev)
        _, _, toks, margins = _greedy_trace(torch, model, params, prompts, TP_NEW, cache)
        same = tp_tokens == toks.numpy()
        one = {"equal_token_share": float(same.mean()),
               "departures": _departures(same, margins.numpy())}
        if cfg.moe is not None:
            cache = tree_init(model.cache_defs(TP_REQUESTS, TP_PROMPT + TP_NEW), 0,
                              device=dev)
            with moe_probe(mesh.model) as drops:
                _, _, toks, margins = _greedy_trace(torch, model, params, prompts,
                                                    TP_NEW, cache)
            same = tp_tokens == toks.numpy()
            one["local_capacity"] = {"equal_token_share": float(same.mean()),
                                     "departures": _departures(same, margins.numpy()),
                                     "dropped_by_tokens": drops["by_tokens"]}
        del params, cache
        _free(torch, dev)
    dist.barrier()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the f32 gate: TP decode against one rank's, token by token
    cfg32 = tp_config(arch, TP_F32_LAYERS.get(arch, layers))
    toks32 = prompts[:TP_F32_ROWS, :TP_F32_TOKENS]
    b32 = build_serve_step(RunConfig(model=cfg32, shape=ShapeConfig(
        "d", TP_F32_TOKENS, TP_F32_ROWS, "decode")), "decode", mesh=mesh)
    p32 = tree_map(lambda x: x.float(), b32.init_params(0))
    tp32 = _f32_decode(torch, b32.model, p32, toks32)
    # the MoE layer's capacity follows its token count: its prefill gate
    # runs at the path's shape, a dense model's on TP_F32_ROWS prompts
    pre = prompts if cfg.moe is not None else prompts[:TP_F32_ROWS]
    tp_pre, tp_drops = _f32_prefill(torch, b32.model, p32, pre)
    del p32, b32
    _free(torch, dev)
    f32 = {"dropped_tp_rank": tp_drops}
    if rank == 0:
        model = build_model(cfg32)
        params = tree_map(lambda x: x.float(), tree_init(model.param_defs(), 0, device=dev))
        one32 = _f32_decode(torch, model, params, toks32)
        one_pre, one_drops = _f32_prefill(torch, model, params, pre)
        f32.update(layers=cfg32.num_layers, rows=TP_F32_ROWS, tokens=TP_F32_TOKENS,
                   prefill_shape=list(pre.shape),
                   decode_tp_vs_one_rank_rel_l2=_rel_l2(tp32, one32))
        if cfg.moe is not None:
            with moe_probe(mesh.model):
                local_pre, local_drops = _f32_prefill(torch, model, params, pre)
            f32.update(prefill_tp_vs_one_rank_rel_l2=_rel_l2(tp_pre, local_pre),
                       prefill_tp_vs_unsharded_rel_l2=_rel_l2(tp_pre, one_pre),
                       dropped_one_rank_local_capacity=local_drops,
                       dropped_one_rank_unsharded=one_drops)
        else:
            f32["prefill_tp_vs_one_rank_rel_l2"] = _rel_l2(tp_pre, one_pre)
        del params
        _free(torch, dev)
    dist.barrier()
    f32_s = time.perf_counter() - t0
    return {"arch": arch, "layers": cfg.num_layers, "init_s": init_s,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_ms_per_token": decode_ms / TP_NEW,
            "tokens_per_s": TP_REQUESTS * TP_NEW / (decode_ms / 1e3),
            "launches": launches, "collectives": coll,
            "seconds": {"serve": serve_s, "one_rank": one_s, "f32": f32_s},
            "peak_gb": peak, "one_rank": one, "f32": f32,
            "tokens_head": tp_tokens[:2, :8].tolist()}


def _tp_train(torch, dist, dev, mesh) -> dict:
    """phi3.5-moe's training step on 1 x 1 x 2 (TP_TRAIN): seed-0 weights,
    TP_TRAIN_STEPS steps on seeded batches, kernel counts reset before each."""
    from repro_torch.configs import CommConfig, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.models import batch_concrete
    from repro_torch.runtime.step import build_train_step
    arch, layers, seq = TP_TRAIN
    cfg = tp_config(arch, layers)
    rc = RunConfig(model=cfg, shape=ShapeConfig("train", seq, 1, "train"),
                   comm=CommConfig(mode="hierarchical"),
                   train=TrainConfig(lr=3e-4, total_steps=TP_TRAIN_STEPS, warmup_steps=1))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    b = build_train_step(rc, mesh)
    state = b.init_state(0)
    steps = []
    for i in range(TP_TRAIN_STEPS):
        batch = batch_concrete(cfg, "train", 1, seq, seed=i, device=dev)
        ops.reset_launch_counts()
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = b.fn(state, batch)
        loss = float(m["loss"])
        _sync(torch, dev)
        steps.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                      "aux_loss": float(m["aux_loss"]),
                      "time_s": time.perf_counter() - t0,
                      "launches": ops.launch_counts()})
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    del state, b
    _free(torch, dev)
    return {"arch": arch, "layers": layers, "seq_len": seq, "steps": steps,
            "params": cfg.param_count(), "peak_gb": peak}


def _tp_rank(rank: int, init: str, out: str, spec: dict) -> None:
    """One rank of the tp phase's 1 x 1 x 2 spawn: TP_SERVE's archs, then
    TP_TRAIN; writes its report."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    timeout = datetime.timedelta(seconds=spec["gloo_timeout_s"])
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=timeout)
    try:
        dev = torch.device("cpu")
        if spec["device"] != "cpu":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        mesh = make_local_mesh(model=2, device=dev, timeout=timeout)
        rep = {"rank": rank, "model_index": mesh.model_index, "serve": {}}
        report = os.path.join(out, f"tp.rank{rank}.json")
        for arch, layers in spec["serve"]:
            rep["serve"][arch] = _tp_serve(torch, dist, dev, mesh, arch, layers)
            with open(report, "w") as f:
                json.dump(rep, f)
        rep["train"] = _tp_train(torch, dist, dev, mesh)
        with open(report, "w") as f:
            json.dump(rep, f)
    except BaseException:
        _say_failed(rank)
        raise
    finally:
        dist.destroy_process_group()


def phase_tp(torch, out_dir: str, smi: str, train: dict) -> dict:
    """Tensor and expert parallelism on the card.  The qwen1.5-0.5b runs on
    2 x 1 x 2 ran in :func:`phase_families_train`'s 2 x 2 spawn; this
    checks them (:func:`_check_tp_run`) and holds the no-codec run's step-1
    loss to the train phase's no-codec 2 x 1 run on the same batch (`train`,
    or its report when the train phase was not asked) within TP_LOSS_TOL.  Then one spawn of 2 ranks (1 x 1 x 2, expandable
    segments, a host memory watch, :func:`_tp_rank`): serving llama3.2-3b
    and phi3.5-moe (TP_SERVE) with the gates: the f32 decode against one
    rank's within WHOLE_F32_TOL relative L2, the share of bf16 greedy
    tokens equal to one rank's with the margins where they depart, both
    ranks' tokens equal, flash and rmsnorm launched as the path needs; and
    phi3.5-moe's training step (TP_TRAIN): finite losses and grad norms
    equal on both ranks, the aux loss above 0, the kernels launched every
    step as ``family_train_launches`` says."""
    out = {"train": {}}
    base = train.get("none") or _checked_runs(train_specs()[:1], out_dir)[0]
    for codec in TP_CODECS:
        row = _check_tp_run(codec, os.path.join(out_dir, f"tp_{codec}"), smi)
        if codec == "none":
            gap = abs(row["losses"][0] - base["losses"][0])
            check(gap <= TP_LOSS_TOL, f"tp none: step-1 loss {row['losses'][0]} within "
                  f"{TP_LOSS_TOL} of the 2 x 1 run's {base['losses'][0]}")
            row["step1_loss_gap_to_2x1"] = gap
        out["train"][codec] = row
        emit({"phase": "tp", "run": f"qwen1.5-0.5b-{codec}", **row})
    t0 = time.perf_counter()
    watch = _MemWatch("tp")
    try:
        with expandable_segments():
            reps = _spawn(torch, _tp_rank, 2, out_dir,
                          dict(TP_SPEC, serve=list(TP_SERVE)), "tp")
    finally:
        watch.stop()
    out["spawn_s"] = time.perf_counter() - t0
    for arch, _ in TP_SERVE:
        r0, r1 = reps[0]["serve"][arch], reps[1]["serve"][arch]
        cfg = tp_config(arch, r0["layers"])
        L = cfg.num_layers
        want = {"flash_attention": L, "rmsnorm": (2 * L + 1) * (1 + TP_NEW)}
        for r, x in enumerate((r0, r1)):
            check(all(x["launches"][k] == v for k, v in want.items()),
                  f"tp {arch} rank {r}: launches {x['launches']}, the path's {want}")
        check(r0["tokens_head"] == r1["tokens_head"], f"tp {arch}: both ranks' tokens")
        for k in ("decode_tp_vs_one_rank_rel_l2", "prefill_tp_vs_one_rank_rel_l2"):
            f = r0["f32"][k]
            check(f <= WHOLE_F32_TOL, f"tp {arch}: f32 {k} {f} <= {WHOLE_F32_TOL}")
        r0["f32"]["dropped_tp"] = {
            k: r0["f32"]["dropped_tp_rank"][k] + r1["f32"]["dropped_tp_rank"][k]
            for k in ("dropped", "assigned")}
        row = {"card": smi, "mesh": "1x1x2", "requests": TP_REQUESTS, "prompt": TP_PROMPT,
               "new_tokens": TP_NEW, **{k: v for k, v in r0.items() if k != "tokens_head"},
               "peak_gb_by_rank": [r0["peak_gb"], r1["peak_gb"]]}
        out[arch] = row
        emit({"phase": "tp", "run": f"serve-{arch}", **row})
    t = [reps[r]["train"] for r in range(2)]
    cfg = tp_config(TP_TRAIN[0], TP_TRAIN[1])
    want = family_train_launches(cfg)
    for i in range(TP_TRAIN_STEPS):
        a, b = t[0]["steps"][i], t[1]["steps"][i]
        check(math.isfinite(a["loss"]) and a["loss"] == b["loss"]
              and a["grad_norm"] == b["grad_norm"] and a["aux_loss"] > 0,
              f"tp phi train step {i}: losses {a['loss']}, {b['loss']}, norms "
              f"{a['grad_norm']}, {b['grad_norm']}, aux {a['aux_loss']}")
        for r, x in enumerate((a, b)):
            check(all(x["launches"][k] == v for k, v in want.items()),
                  f"tp phi train rank {r} step {i}: launches {x['launches']}, {want}")
    import numpy as np
    step_s = float(np.median([s["time_s"] for s in t[0]["steps"][1:]]))
    out["phi_train"] = {"card": smi, "mesh": "1x1x2", **t[0],
                        "step_ms_median_steps_2_3": 1e3 * step_s,
                        "tokens_per_s": TP_TRAIN[2] / step_s,
                        "peak_gb_by_rank": [t[0]["peak_gb"], t[1]["peak_gb"]]}
    emit({"phase": "tp", "run": "train-phi3.5-moe", **out["phi_train"]})
    return out


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
    laps, last = {}, [t_start]

    def lap(name: str) -> None:
        """Seconds since the previous lap, under `name` (the phases' split)."""
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - last[0]
        last[0] = now
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
    lap("env_build")
    krows = phase_kernels(torch, dev) if "kernels" in phases else {}
    if krows:
        emit({"phase": "kernels", "card": smi, **krows})
    lap("kernels")
    if "small" in phases:
        emit({"phase": "small", **phase_small(torch, dev)})
    lap("small")
    eng, serve_chaos = {}, {}
    if any(p in phases for p in ("engine", "serve_chaos", "profile")):
        cfg, params, init_s = full_width(torch, dev)
        if "engine" in phases or "serve_chaos" in phases:
            eng, ctx = phase_engine(torch, dev, cfg, params)
            emit({"phase": "engine_summary", "param_init_s": init_s, **eng})
            lap("engine")
        if "serve_chaos" in phases:
            serve_chaos = phase_serve_chaos(torch, dev, cfg, params, ctx)
            emit({"phase": "serve_chaos_summary", "phase_s": serve_chaos["phase_s"]})
            lap("serve_chaos")
        if "profile" in phases:
            emit({"phase": "profile", "card": smi,
                  **phase_profile(torch, dev, cfg, params)})
        del params
        torch.cuda.empty_cache()
    lap("profile")
    fam = phase_families(torch, dev, smi) if "families" in phases else {}
    lap("families")
    ftrain, train, zero, bkt, ring, sites, tune, tp = {}, {}, {}, {}, {}, {}, {}, {}
    route, ckpt, facade, chaos, elastic = {}, {}, {}, {}, {}
    if any(p in phases for p in ("families_train", "train", "zero", "buckets", "tp",
                                 "ring", "sites", "autotune", "route", "ckpt",
                                 "facade", "chaos", "elastic")):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
            # the train, zero and buckets phases' launcher runs go first in the
            # 2-pod spawns, before the families
            if any(p in phases for p in ("families_train", "train", "zero", "buckets",
                                         "tp")):
                ftrain = phase_families_train(torch, d, smi, phases)
            if "train" in phases:
                train = phase_train(torch, d)
            if "zero" in phases or "buckets" in phases:
                zero = phase_zero(torch, d)
            if "buckets" in phases:
                bkt = phase_buckets(torch, d, zero)
            lap("train_spawns")
            if "tp" in phases:
                tp = phase_tp(torch, d, smi, train)
                lap("tp")
            if "ring" in phases:
                ring = phase_ring(torch, d)
                lap("ring")
            if "sites" in phases:
                sites = phase_sites(torch, d, spec=CUT_SPEC)
                lap("sites")
            if "autotune" in phases:
                tune = phase_autotune(torch, d)
                lap("autotune")
            if "route" in phases:
                route = phase_route(torch, d)
                lap("route")
            if "ckpt" in phases:
                ckpt = phase_ckpt(torch, d, spec=CUT_SPEC)
                lap("ckpt")
            if "facade" in phases:
                facade = phase_facade(torch, d, spec=CUT_SPEC,
                                      src_dir=ckpt.get("facade_src"))
                lap("facade")
            elif ckpt:
                shutil.rmtree(os.path.dirname(ckpt["facade_src"]), ignore_errors=True)
            names = [n for n in ("chaos", "elastic") if n in phases]
            if names:
                ce = phase_chaos_elastic(torch, d, names, spec=CUT_SPEC)
                chaos, elastic = ce.get("chaos", {}), ce.get("elastic", {})
                emit({"phase": "chaos_elastic", "spawn_s": ce["spawn_s"],
                      **{f"{n}_s_by_rank": ce[n]["seconds_by_rank"] for n in names}})
                lap("chaos_elastic")
    if krows and ring:
        wire = phase_kernels_ring(torch, dev, ring["ring_int8"]["top_wire_shape"])
        for name, row in wire.items():
            krows[name].append(row)
        emit({"phase": "kernels_ring_wire", "card": smi, **wire})
    lap("kernels_ring_wire")
    emit({"phase": "seconds", **laps})
    if krows:
        line = []
        # launches on the ZeRO training path (int8 run, rank 0: all five
        # kernels); the 2-pod run's and the serving path's beside them
        on_path = zero.get("int8", {}).get("launches_rank0", {})
        on_pods = train.get("int8", {}).get("launches_rank0", {})
        on_bkt = bkt.get("int8", {}).get("launches_rank0", {})
        on_ring = ring.get("ring_int8", {}).get("launches_rank0", {})
        on_sites = sites.get("ring_int8", {}).get("launches_rank0", {})
        on_tune = tune.get("launches_rank0", {})
        on_route = route.get("route_int8", {}).get("launches_rank0", {})
        on_ckpt = ckpt.get("launches_rank0", {})
        on_facade = facade.get("launches_rank0", {})
        on_chaos = chaos.get("chaos", {}).get("launches_rank0", {})
        on_failover = chaos.get("failover", {}).get("launches_rank0", {})
        on_elastic = elastic.get("elastic", {}).get("launches_rank0", {})
        on_restart = elastic.get("restart", {}).get("launches_rank0", {})
        on_serve_chaos = serve_chaos.get("launches", {})
        for name, source, replaces, tol in KERNELS:
            # the row at the training path's shape
            main_row = next(r for r in krows[name] if r.get("on_path") == "train")
            ring_row = next((r for r in krows[name] if r.get("on_path") == "ring"), None)
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": on_path.get(name, 0),
                         "launches_pods_2x1": on_pods.get(name, 0),
                         "launches_buckets_2x2": on_bkt.get(name, 0),
                         "launches_ring_3x1": on_ring.get(name, 0),
                         "launches_sites_ring_int8_gateway": on_sites.get(name, 0),
                         "launches_autotune_2x1": on_tune.get(name, 0),
                         "launches_route_int8_4x1": on_route.get(name, 0),
                         "launches_ckpt_4x1": on_ckpt.get(name, 0),
                         "launches_facade_4x1": on_facade.get(name, 0),
                         "launches_chaos_4x1": on_chaos.get(name, 0),
                         "launches_failover_4x1": on_failover.get(name, 0),
                         "launches_elastic_4x1": on_elastic.get(name, 0),
                         "launches_restart_1x4": on_restart.get(name, 0),
                         "launches_serve_chaos": on_serve_chaos.get(name, 0),
                         "launches_tp_2x1x2_int8": tp.get("train", {}).get(
                             "int8", {}).get("launches_rank0", {}).get(name, 0),
                         "launches_tp_serving": {
                             a: tp[a]["launches"].get(name, 0)
                             for a, _ in TP_SERVE if a in tp},
                         "launches_tp_phi_train": (
                             tp["phi_train"]["steps"][-1]["launches"].get(name, 0)
                             if "phi_train" in tp else 0),
                         **({"tp_rows": [r for r in krows[name]
                                         if r.get("on_path") == "tp"]}
                            if any(r.get("on_path") == "tp" for r in krows[name]) else {}),
                         "launches_serving": eng.get("launches", {}).get(name, 0),
                         "launches_families": {
                             a: (r["runs"][-1]["launches"] if "runs" in r
                                 else r["launches"]).get(name, 0)
                             for a, r in fam.items()},
                         "launches_families_train": {
                             n: r["launches_rank0"].get(name, 0)
                             for n, r in ftrain.items() if isinstance(r, dict)},
                         **({"ring_wire_block": ring_row} if ring_row else {}),
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
    try:
        sys.exit(main())
    finally:
        stop_fork_server()
