from repro_torch.runtime.serve_loop import (Server, ServeResult,  # noqa: F401
                                            land_prefill)
from repro_torch.runtime.serving import ServingEngine  # noqa: F401
from repro_torch.runtime.step import (StepBundle, build_serve_step,  # noqa: F401
                                      build_train_step)
from repro_torch.runtime.train_loop import (InjectedFault,  # noqa: F401
                                            StragglerDetector, Trainer,
                                            elastic_restart)
