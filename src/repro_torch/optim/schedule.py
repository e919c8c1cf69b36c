"""Learning-rate schedules (warmup + cosine decay), in f32 as the JAX
package computes them."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_at(step, tc: TrainConfig, device=None) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-d tensor): a 0-d f32
    tensor."""
    s = torch.as_tensor(step, device=device).to(torch.float32)
    warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
    total = max(tc.total_steps - tc.warmup_steps, 1)
    frac = torch.clamp((s - tc.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    floor = tc.min_lr_ratio
    return tc.lr * warm * (floor + (1.0 - floor) * cos)
