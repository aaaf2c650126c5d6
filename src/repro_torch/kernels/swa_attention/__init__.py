from repro_torch.kernels.swa_attention.kernel import (  # noqa: F401
    swa_decode_attention)
from repro_torch.kernels.swa_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.swa_attention.ref import swa_decode_plain  # noqa: F401
