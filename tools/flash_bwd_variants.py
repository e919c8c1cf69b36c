#!/usr/bin/env python3
"""Ablations of the port's flash backward on one NVIDIA card: what holds it
back from its bound.

    python3 tools/flash_bwd_variants.py                  # every variant, qwen's shape
    python3 tools/flash_bwd_variants.py --shapes 0,2 no_exp one_block

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` with
one textual edit (``VARIANTS``), written under ``build/flash_bwd_variants/``
and built with the port's nvcc flags; all are loaded with ctypes into one
process and timed against the committed kernel turn by turn (committed,
variants, variants reversed, committed) with CUDA events, each call's device
time split by kernel with torch.profiler.  Most variants compute wrong
gradients on purpose: each removes or doubles one part of the work, so its
time says what that part costs.  Prints one JSON line per shape; exits
nonzero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

_DV_DK = """    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_tb_n<D>(&dv[0][0], pa[kk], LQ::mnmajor(o_base, kk));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_tb_n<D>(&dk[0][0], da[kk], LQ::mnmajor(q_base, kk));
    wgmma_commit();
"""
_DQ = """    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb_n<D>(&dq[0][0], da[kk], L::mnmajor(k_base, kk));
    wgmma_commit();
"""
_DP_T = """#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&dpt[0][0], LK::kmajor(v_base, ks), LQ::kmajor(o_base, ks), ks > 0);
"""

# name -> [(text of the committed source, its replacement), ...]
VARIANTS = {
    # the exponentials of P (both kernels) become a plain FMA
    "no_exp": [("fast_exp2(fmaf(", "(fmaf(")] * 2,
    # the products after P (dV and dK; dQ) are dropped; their operands are
    # folded into one accumulator so that P and dS are still computed
    "no_rs_products": [
        (_DV_DK, """#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[0][0] += __uint_as_float(pa[kk][e] ^ da[kk][e]);
"""),
        (_DQ, """#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[0][0] += __uint_as_float(da[kk][e]);
""")],
    # dV and dK issued twice (twice their tensor-core work)
    "rs_products_twice": [(_DV_DK, _DV_DK.replace("    wgmma_commit();\n", "") + _DV_DK[
        len("    wgmma_fence();\n"):])],
    # S^T and dP^T issued twice in the dK/dV kernel
    "ss_products_twice": [(_DP_T, _DP_T + _DP_T.replace("ks > 0", "1")
                           + _DP_T.replace("ks > 0", "1").replace("dpt[0][0], LK::kmajor(v_base",
                                                                  "dpt[0][0], LK::kmajor(k_base")
                           .replace("LQ::kmajor(o_base", "LQ::kmajor(q_base"))],
    # only the first streamed tile is loaded; later ones reuse stale tiles
    "no_stream_loads": [
        ("    if (it + 1 < n_items) load_item(it + 1, stage ^ 1);",
         "    if (it == 0 && 1 < n_items) load_item(it + 1, stage ^ 1);"),
        ("    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);",
         "    if (it == 0 && 1 < n_tiles) load_kv(it + 1, stage ^ 1);")],
    # 120 KB more shared memory per block: one block of each kernel per SM
    "one_block": [("constexpr int dkdv_smem() {\n  return 1024 +",
                   "constexpr int dkdv_smem() {\n  return 120000 +"),
                  ("constexpr int dq_smem() {\n  return 1024 +",
                   "constexpr int dq_smem() {\n  return 120000 +")],
}

# (B, S, H, KH, D, window): chip_smoke.py's backward shapes
SHAPES = [(1, 4096, 16, 16, 64, None), (1, 4096, 16, 16, 64, 1024),
          (1, 1024, 24, 8, 128, None), (1, 1024, 24, 8, 128, 256),
          (1, 1024, 32, 8, 120, None), (1, 1024, 32, 8, 120, 256)]


def write_variants(names: list[str], out_dir: str, src: str) -> dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: the committed source no longer holds "
                                 f"{old[:60]!r}; update VARIANTS")
            text = text.replace(old, new, 1)
        paths[name] = os.path.join(out_dir, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def build_variants(build, paths: dict[str, str]) -> dict:
    procs = {}
    for name, path in paths.items():
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        f = ctypes.CDLL(paths[name][:-3] + ".so").flash_bwd_bf16
        f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def call(torch, build, f, q, k, v, o, lse, do, window):
    """The wrapper's launch, on a variant's library."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    st = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    build.check(f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), B, H, KH, Sq, Sk, D, ctypes.cast(st, ctypes.c_void_p),
                  float(D ** -0.5), 1, -1 if window is None else int(window),
                  build.stream_handle(q)), "variant")
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help=f"subset of {list(VARIANTS)}")
    ap.add_argument("--shapes", default="0", help=f"indices into {SHAPES}")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    fns = build_variants(build, write_variants(
        args.variants, os.path.join(ROOT, "build", "flash_bwd_variants"), src))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    print(cs.nvidia_smi(), flush=True)
    for i in (int(x) for x in args.shapes.split(",")):
        B, S, H, KH, D, w = SHAPES[i]
        nbytes = 2 * 4 * (B * S * H * D + B * S * KH * D) + 4 * B * H * S
        n_sets = cs.sets_for(nbytes)
        sets = []
        for _ in range(n_sets):
            q, k, v, do = rnd(B, S, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D), rnd(B, S, H, D)
            o, lse = fa.flash_attention_bshd(q, k, v, causal=True, window=w, return_lse=True)
            sets.append((q, k, v, o, lse, do))
        runs = {"committed": lambda j: fa.flash_attention_bwd_bshd(*sets[j], causal=True,
                                                                   window=w)}
        for name, f in fns.items():
            runs[name] = (lambda f: lambda j: call(torch, build, f, *sets[j], w))(f)
        times = {n: [] for n in runs}
        for n in list(runs) + list(runs)[::-1]:
            times[n].append(cs.cuda_ms(torch, runs[n], n_sets, 20))
        cs.emit({"shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D, "window": w},
                 "ms": {n: sum(t) / len(t) for n, t in times.items()},
                 "ms_turns": times,
                 "parts_ms": {n: cs.bwd_parts_ms(torch, fn, n_sets, 10)
                              for n, fn in runs.items()}})
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
