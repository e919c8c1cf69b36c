"""qwen1.5-0.5b — MHA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (kv=16, i.e. MHA) head_dim=64 d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
