from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step, load_checkpoint, save_checkpoint,
)
