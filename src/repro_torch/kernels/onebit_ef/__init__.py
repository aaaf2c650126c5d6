from repro_torch.kernels.onebit_ef.kernel import onebit_ef  # noqa: F401
from repro_torch.kernels.onebit_ef.ops import compress_rows  # noqa: F401
from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain, unpack  # noqa: F401
