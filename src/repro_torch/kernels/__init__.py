"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``topk_ef`` (K1, CUDA C++), the ``cr_reduce`` deposits (K2 CUDA
C++, K3 Triton), ``sim_step`` (K6 ``delivery_step`` and K7 ``sync_step``,
CUDA C++) and ``onebit_ef`` (K8, Triton).  :func:`main_path_kernels` lists
the training path's wrappers, :func:`sim_kernels` the simulator's and
:func:`all_kernels` every one."""


def main_path_kernels():
    """The kernel wrappers of the training main path, in launch order."""
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,
                                                      topk_cr_deposit)
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, topk_cr_deposit, onebit_cr_deposit]


def sim_kernels():
    """The kernel wrappers the simulator launches: K1 for top-k EF rows,
    K6 and K7 for the fused step, K8 for one-bit EF rows."""
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.sim_step.kernel import delivery_step, sync_step
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, delivery_step, sync_step, onebit_ef]


def all_kernels():
    """Every kernel wrapper of the port, each once."""
    out = []
    for k in main_path_kernels() + sim_kernels():
        if k not in out:
            out.append(k)
    return out
