"""See the package docstring of repro_torch."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    check_checkpoint, checkpoint_leaves, latest_step, load_checkpoint,
    save_checkpoint,
)
