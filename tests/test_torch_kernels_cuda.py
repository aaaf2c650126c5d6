"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on the card.  This file imports no JAX, so it runs on the machine with the
card:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Every test is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode; the plain versions are held against the JAX
reference in ``test_torch_kernels.py``).  Kernels and plain versions must
agree bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,  # noqa: E402
                                                  topk_cr_deposit)
from repro_torch.kernels.cr_reduce.ref import (  # noqa: E402
    onebit_cr_deposit_plain, topk_cr_deposit_plain)
from repro_torch.kernels.topk_ef.kernel import topk_ef  # noqa: E402
from repro_torch.kernels.topk_ef.ref import q_dense, topk_ef_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA/Triton kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _rows(shape, seed, ties):
    rng = np.random.default_rng(seed)
    if ties:
        g = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=shape)
        e = rng.choice([0.0, 0.5, -0.5], size=shape)
    else:
        g = rng.standard_normal(shape)
        e = 0.1 * rng.standard_normal(shape)
    g, e = g.astype(np.float32), e.astype(np.float32)
    g[-1] = 0.0
    e[-1] = 0.0                      # an all-zero row: k ties at zero
    return g, e


@pytest.mark.parametrize("shape,k,ties", [
    ((8, 256), 32, False), ((8, 1000), 125, True), ((1, 4096), 256, False),
    ((8, 4096), 256, True), ((3, 100), 100, False), ((2, 70000), 1, True),
    ((1, 300000), 18750, False)])
def test_topk_ef_kernel_matches_plain(cuda, shape, k, ties):
    g, e = _rows(shape, seed=shape[1], ties=ties)
    tg, te = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    kv, ki, ke = topk_ef(tg, te, k)
    pv, pi, pe = topk_ef_plain(tg, te, k)
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)
    assert torch.equal(q_dense(kv, ki, shape[1]).view(torch.int32),
                       q_dense(pv, pi, shape[1]).view(torch.int32))
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))


def test_topk_ef_kernel_residual_in_place_and_no_residual(cuda):
    g, e = _rows((1, 50000), seed=1, ties=False)
    tg, te = torch.from_numpy(g).to(cuda), torch.from_numpy(e).to(cuda)
    want = topk_ef_plain(tg, te, 3000)
    err = te.clone()
    got = topk_ef(tg, err, 3000, out_err=err)
    assert got[2].data_ptr() == err.data_ptr()
    assert torch.equal(err, want[2])
    nv, ni, ne = topk_ef(tg, None, 3000)
    pv, pi, pe = topk_ef_plain(tg, None, 3000)
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(ni, 1).values, torch.sort(pi, 1).values)
    assert torch.equal(ne, pe)


def _deposit_inputs(cuda, m, r, k, seed=0):
    """Three messages into a 3-slot ring; a large row is included, as a
    cross-warp race in the one-bit kernel once showed at large sizes only."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((3, m, r)).astype(np.float32)
    vals = rng.standard_normal((3, m, k)).astype(np.float32)
    idx = np.stack([np.stack([rng.permutation(r)[:k] for _ in range(m)])
                    for _ in range(3)]).astype(np.int32)
    pos = rng.random((3, m, r)) < 0.5
    means = rng.standard_normal((3, m, 2)).astype(np.float32)
    slots = np.array([1, 1, 2], np.int32)        # two messages share slot 1
    weights = np.array([1.0, 0.5, 0.0], np.float32)  # the last is DROPPED
    return [torch.from_numpy(x).to(cuda)
            for x in (acc, vals, idx, pos, means, slots, weights)]


@pytest.mark.parametrize("m,r,k", [(1, 4096, 256), (8, 1000, 50),
                                   (1, 1 << 24, 1 << 20)])
def test_deposit_kernels_match_plain_bitwise(cuda, m, r, k):
    acc, vals, idx, pos, means, slots, w = _deposit_inputs(cuda, m, r, k)
    a_k, a_p = acc.clone(), acc.clone()
    topk_cr_deposit(a_k, vals, idx, slots, w)
    topk_cr_deposit_plain(a_p, vals, idx, slots, w)
    torch.cuda.synchronize()
    assert torch.equal(a_k.view(torch.int32), a_p.view(torch.int32))
    onebit_cr_deposit(a_k, pos, means, slots, w)
    onebit_cr_deposit_plain(a_p, pos, means, slots, w)
    torch.cuda.synchronize()
    assert torch.equal(a_k.view(torch.int32), a_p.view(torch.int32))


def test_kernels_count_launches(cuda):
    acc, vals, idx, pos, means, slots, w = _deposit_inputs(cuda, 1, 64, 4)
    before = (topk_ef.launches, topk_cr_deposit.launches,
              onebit_cr_deposit.launches)
    topk_ef(acc[0], None, 4)
    topk_cr_deposit(acc, vals, idx, slots, w)
    onebit_cr_deposit(acc, pos, means, slots, w)
    after = (topk_ef.launches, topk_cr_deposit.launches,
             onebit_cr_deposit.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
