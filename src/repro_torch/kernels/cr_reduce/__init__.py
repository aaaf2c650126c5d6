from repro_torch.kernels.cr_reduce.kernel import (  # noqa: F401
    onebit_cr_deposit, onebit_cr_reduce, topk_cr_deposit, topk_cr_reduce)
from repro_torch.kernels.cr_reduce.ops import (  # noqa: F401
    onebit_compress_rows, onebit_deposit, onebit_reduce, topk_compress_rows,
    topk_deposit, topk_reduce)
from repro_torch.kernels.cr_reduce.ref import (  # noqa: F401
    onebit_cr_deposit_plain, onebit_cr_reduce_plain, topk_cr_deposit_plain,
    topk_cr_reduce_plain)
