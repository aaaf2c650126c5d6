from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, apply_updates, global_norm, momentum, sgd,
)
from repro_torch.optim.schedules import constant  # noqa: F401
