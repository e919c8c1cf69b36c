"""The analytic parts of the JAX package's ``launch/roofline.py`` that the
train step reads: model FLOPs and the modeled compute window.

The peak is the **NVIDIA H100's dense bf16 tensor-core rate, 989e12 FLOP/s
(NVIDIA's data sheet)**, where the JAX package uses its TPU's
``PEAK_FLOPS = 197e12``.  So the port's modeled window, and the autotuner's
warm start that reads it, differ from the reference's by design; tests that
compare the two pass the reference's peak through `peak_flops`.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12    # H100 SXM, dense bf16 (NVIDIA data sheet)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference); N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch * 1  # decode: one token


def modeled_compute_window(cfg, shape, *, n_chips: int, microbatches: int = 1,
                           peak_flops: float = PEAK_FLOPS) -> float:
    """Seconds of compute one *microbatch* offers for hiding WAN transfers:
    the FLOPs-roofline term of one microbatch (6·N·B·S / m) over the fleet's
    peak, the window ``autotune_path(compute_window=)`` minimizes exposure
    against."""
    flops = model_flops_for(cfg, shape)
    return flops / max(1, int(microbatches)) / (max(1, int(n_chips)) * peak_flops)
