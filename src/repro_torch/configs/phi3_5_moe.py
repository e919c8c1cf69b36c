"""phi3.5-moe-42b-a6.6b — 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=6400 vocab=32064,
MoE 16 experts top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, top_k=2),
))
