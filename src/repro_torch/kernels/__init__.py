"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``topk_ef`` (K1, CUDA C++), the ``cr_reduce`` reduces (K4 CUDA
C++, K5 Triton) and deposits (K2 CUDA C++, K3 Triton), ``sim_step`` (K6 ``delivery_step`` and K7 ``sync_step``,
CUDA C++), ``onebit_ef`` (K8, CUDA C++), ``swa_attention`` (K9
``swa_decode_attention``, CUDA C++) and ``ssd`` (K10 ``ssd_chunked``, CUDA
C++).  :func:`main_path_kernels` lists the bounded-staleness training path's
wrappers, :func:`sync_kernels` the synchronous compressed sync's,
:func:`sim_kernels` the simulator's, :func:`serve_kernels` the paged
serving path's, :func:`hybrid_kernels` the Mamba2 serving path's and
:func:`all_kernels` every one."""


def main_path_kernels():
    """The kernel wrappers of the training main path, in launch order."""
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,
                                                      topk_cr_deposit)
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, topk_cr_deposit, onebit_cr_deposit]


def sync_kernels():
    """The kernel wrappers of the synchronous compressed gradient sync
    (``--sync topk_ef|onebit_ef``), in launch order: K1 compresses each
    worker's leaf, K4 or K5 reduces the gathered payloads."""
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_reduce,
                                                      topk_cr_reduce)
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, topk_cr_reduce, onebit_cr_reduce]


def sim_kernels():
    """The kernel wrappers the simulator launches: K1 for top-k EF rows,
    K6 and K7 for the fused step, K8 for one-bit EF rows."""
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.sim_step.kernel import delivery_step, sync_step
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    return [topk_ef, delivery_step, sync_step, onebit_ef]


def serve_kernels():
    """The kernel wrappers the paged serving decode launches: K9 on every
    windowed attention layer."""
    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    return [swa_decode_attention]


def hybrid_kernels():
    """The kernel wrappers the Mamba2 (zamba2) serving path launches: K10
    on every Mamba2 layer of the prefill."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    return [ssd_chunked]


def all_kernels():
    """Every kernel wrapper of the port, each once."""
    out = []
    for k in (main_path_kernels() + sync_kernels() + sim_kernels()
              + serve_kernels() + hybrid_kernels()):
        if k not in out:
            out.append(k)
    return out
