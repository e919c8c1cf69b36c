"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=10752 vocab=100352,
MoE 16 experts top-4.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4),
))
