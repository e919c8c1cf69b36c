"""pixtral-12b — Pixtral-ViT frontend (stub) + Mistral-Nemo-style backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072.
The vision frontend is a STUB per assignment: ``input_specs()`` provides
precomputed patch embeddings (1024 patch tokens) prepended to the text stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    vision_tokens=1024,
))
