"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``topk_ef`` (K1, CUDA C++), ``cr_reduce`` deposits (K2 CUDA C++,
K3 Triton).  :func:`main_path_kernels` lists their wrappers."""


def main_path_kernels():
    """The kernel wrappers of the training main path, in launch order."""
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,
                                                      topk_cr_deposit)
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, topk_cr_deposit, onebit_cr_deposit]
