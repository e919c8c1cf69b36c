from repro_torch.optim.adamw import adamw_update, global_norm, init_opt_state  # noqa: F401
from repro_torch.optim.schedule import lr_at  # noqa: F401
