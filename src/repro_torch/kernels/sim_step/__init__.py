from repro_torch.kernels.sim_step.ops import (  # noqa: F401
    FUSED_KINDS, fused_delivery_step, fused_sync_step, supports_fused)
