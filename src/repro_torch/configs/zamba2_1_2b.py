"""zamba2-1.2b — Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]
38L d_model=2048 32H (MHA kv=32) head_dim=64 d_ff=8192 vocab=32000,
ssm_state=64.  One shared (weight-tied) attention+MLP block is interleaved
every 6 mamba blocks (Zamba-style shared block).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    attn_every=6,
))
