from repro_torch.kernels.topk_ef.kernel import topk_ef  # noqa: F401
from repro_torch.kernels.topk_ef.ops import compress_rows, topk_k  # noqa: F401
from repro_torch.kernels.topk_ef.ref import q_dense, topk_ef_plain  # noqa: F401
