from repro_torch.data.pipeline import (BinaryTokens, DataConfig, Prefetcher,  # noqa: F401
                                       SyntheticLM, make_pipeline)
