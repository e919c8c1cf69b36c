"""PyTorch/CUDA port of WideJAX (the MPWide reproduction in ``repro``).

Laid out path for path like ``repro``: ``repro_torch/X.py`` is the port of
``repro/X.py``.  Imports torch, numpy and the standard library only — never
jax, and nothing of ``repro``.
"""
