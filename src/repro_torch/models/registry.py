"""Model registry: build a model object for a registered arch."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba2 import MambaLM
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig):
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    return Transformer(cfg)
