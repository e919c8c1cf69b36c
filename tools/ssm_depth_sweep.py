#!/usr/bin/env python3
"""How far the port's state-space models carry a rounding to their logits,
by depth, on the CPU at smoke width in f32.

    python3 tools/ssm_depth_sweep.py                         # both archs
    python3 tools/ssm_depth_sweep.py --arch mamba2-780m --layers 8,48

For each depth, the smoke config (``smoke_config``: d_model 128, seed-0
weights cast to f32) cut or grown to that many layers, two rows of a
40-token seeded prompt: the relative L2 distance of the last position's
logits between the model's prefill and its token-by-token ``decode_step``
(the same sums in another order), and between the prefill and the prefill
with one f32 ulp of noise (random signs) on every embedding entry.  Where
the two grow together, the prefill/decode gap is the model amplifying a
rounding, not a fault of either path.  Prints one JSON line per depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEPTHS = {"mamba2-780m": (1, 2, 4, 8, 16, 32, 48), "zamba2-1.2b": (2, 4, 8, 16, 38)}


def _f32(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def sweep(arch: str, layers: int, prompt: int = 40) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_init
    cfg = dataclasses.replace(smoke_config(get_config(arch)), num_layers=layers)
    model = build_model(cfg)
    params = _f32(tree_init(model.param_defs(), 0, device="cpu"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=(2, prompt)))
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(3)).sign()
    with torch.inference_mode():
        pre, _ = model.prefill(params, {"tokens": tokens})
        moved, _ = model.prefill({**params, "embed": params["embed"] * (1 + 2.0 ** -24 * noise)},
                                 {"tokens": tokens})
        cache = _f32(tree_init(model.cache_defs(2, prompt), 0, device="cpu"))
        for t in range(prompt):
            dec, cache = model.decode_step(params, cache, t, tokens[:, t:t + 1])
    return {"arch": arch, "layers": layers, "d_model": cfg.d_model,
            "decode_vs_prefill_rel_l2": _rel_l2(dec[:, -1], pre[:, -1]),
            "one_ulp_embedding_noise_rel_l2": _rel_l2(moved[:, -1], pre[:, -1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(DEPTHS), action="append")
    ap.add_argument("--layers", help="comma-separated depths (default: the arch's)")
    args = ap.parse_args()
    for arch in args.arch or sorted(DEPTHS):
        depths = ([int(x) for x in args.layers.split(",")] if args.layers
                  else DEPTHS[arch])
        for n in depths:
            print(json.dumps(sweep(arch, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
