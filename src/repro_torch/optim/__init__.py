from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, apply_updates, clip_by_global_norm, global_norm,
    momentum, sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, paper_nonconvex_lr, paper_strongly_convex_lr,
    warmup_cosine,
)
