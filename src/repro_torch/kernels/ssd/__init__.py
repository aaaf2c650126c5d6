from repro_torch.kernels.ssd.kernel import ssd_chunked  # noqa: F401
from repro_torch.kernels.ssd.ops import ssd  # noqa: F401
from repro_torch.kernels.ssd.ref import ssd_plain  # noqa: F401
