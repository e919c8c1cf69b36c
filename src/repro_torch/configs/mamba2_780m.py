"""mamba2-780m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1536 (attn-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64 => 48 SSD heads per block.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
))
