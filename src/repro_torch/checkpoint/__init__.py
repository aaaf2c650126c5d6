"""See the package docstring of repro_torch."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    check_checkpoint, latest_step, leaf_digests, load_checkpoint,
    save_checkpoint,
)
