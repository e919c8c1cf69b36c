"""whisper-medium — encoder-decoder with conv frontend (stub).

[arXiv:2212.04356; unverified]
24L (decoder) + 24L (encoder) d_model=1024 16H (MHA kv=16) head_dim=64
d_ff=4096 vocab=51865.  The conv1d+log-mel frontend is a STUB per assignment:
``input_specs()`` provides precomputed frame embeddings (1500 frames).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    encoder_layers=24,
    source_len=1500,
    rope_theta=0.0,        # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
))
