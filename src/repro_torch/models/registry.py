"""Model registry: build a model object for a registered arch, and a seeded
concrete batch of the inputs its family takes."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba2 import MambaLM
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, tp=None):
    """The model of `cfg`; with `tp` (a ``layers.TensorParallel``) over a
    model axis, which only the dense and moe families take (the others
    raise, naming their ROADMAP item)."""
    if tp is not None and cfg.family not in ("dense", "moe"):
        from repro_torch.core.collectives import TP_ITEM, queued
        raise queued(f"the {cfg.family} family over {tp.size} model ranks",
                     TP_ITEM)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    return Transformer(cfg, tp)


def batch_concrete(cfg: ModelConfig, shape_kind: str, batch_size: int,
                   seq_len: int, seed: int = 0, *, device="cuda") -> dict:
    """A concrete batch on `device`, drawn from one `torch.Generator` seeded
    with `seed` there: ``tokens`` (B, S) int64 (S + 1 for "train"), and off
    "decode" the family's stub inputs in bf16, ``patch_embeds`` (B,
    vision_tokens, d) for the vlm family and ``source_frames`` (B,
    source_len, d) for the audio family.  The draws differ from the JAX
    package's ``batch_concrete``; tests hand both packages the same arrays."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    S = seq_len + 1 if shape_kind == "train" else seq_len
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, S),
                                     generator=gen, device=device)}
    if cfg.vision_tokens and shape_kind != "decode":
        batch["patch_embeds"] = torch.randn(
            (batch_size, cfg.vision_tokens, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)
    if cfg.encoder_layers and shape_kind != "decode":
        batch["source_frames"] = torch.randn(
            (batch_size, cfg.source_len, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)
    return batch
