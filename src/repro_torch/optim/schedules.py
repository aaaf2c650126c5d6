"""Learning-rate schedules (counterpart of ``repro.optim.schedules``)."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    """Constant schedule; the rate is rounded to float32 once, as the
    reference materializes it as an f32 array."""
    value = float(np.float32(lr))
    return lambda step: value
