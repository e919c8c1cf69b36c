from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.replicate import DataGather, sync_once  # noqa: F401
from repro_torch.checkpoint.store import load_manifest, restore, save  # noqa: F401
