from repro_torch.models.registry import batch_concrete, build_model  # noqa: F401
