"""Hand-written CUDA kernels for the H100 (``csrc/``), their wrappers, their
plain PyTorch versions (``ref.py``) and the dispatch (``ops.py``)."""
