"""Architecture config registry.

``load_all()`` imports every per-arch module exactly once; each module calls
``base.register(...)`` at import time with the exact published dimensions.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    CommConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    cell_applicable,
    get_config,
    list_archs,
    smoke_config,
)

_ARCH_MODULES = [
    "pixtral_12b",
    "h2o_danube3_4b",
    "llama3_2_3b",
    "qwen1_5_0_5b",
    "qwen2_5_14b",
    "dbrx_132b",
    "phi3_5_moe",
    "zamba2_1_2b",
    "mamba2_780m",
    "whisper_medium",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
