"""Model registry: build a model object for a registered arch."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import QUEUED, Transformer


def build_model(cfg: ModelConfig) -> Transformer:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name!r}) is not ported to PyTorch "
            f"yet ({QUEUED})")
    return Transformer(cfg)
