"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
SWA makes decode sub-quadratic => this arch runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
))
