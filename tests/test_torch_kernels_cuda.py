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


# ---------------------------------------------------------------------------
# the simulator's kernels: delivery_step (K6), sync_step (K7), onebit_ef (K8)
# ---------------------------------------------------------------------------

def _sim_inputs(cuda, b, p, d, defer, groups=None, seed=0):
    """Inputs at the simulator's scales: a symmetric A with entries of
    order 1/sqrt(d) (a Quadratic's A has eigenvalues 1..cond), views and x*
    of order 1, noise, and a 0/1 delivery tensor scaled by alpha/p."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=gen, device=cuda)
    g = groups
    r = n(g, d, d) if g else n(d, d)
    a = (r + r.transpose(-1, -2)) / (2 * d ** 0.5)
    xs = n(g, d) if g else n(d)
    m = 1 + 2 * p if defer else 1 + p
    u = (torch.rand((b, m, p), generator=gen, device=cuda) < 0.8).float()
    u *= 0.02 / p
    dfr = 1e-3 * n(b, p, d) if defer else None
    return (n(b, p, d), n(b, d), a.contiguous(), xs, 0.1 * n(b, p, d), u,
            dfr)


SIM_SHAPES = [(1, 8, 32, None), (1, 16, 512, None), (1, 32, 4096, None),
              (1, 8, 100, None), (16, 16, 256, None), (16, 16, 256, 16),
              (16, 16, 256, 4), (2, 64, 70, 2)]


@pytest.mark.parametrize("b,p,d,groups", SIM_SHAPES)
@pytest.mark.parametrize("defer", [False, True])
def test_delivery_step_kernel_matches_plain(cuda, b, p, d, groups, defer):
    from repro_torch.kernels.sim_step.kernel import delivery_step
    from repro_torch.kernels.sim_step.ref import delivery_step_plain
    args = _sim_inputs(cuda, b, p, d, defer, groups)
    got = delivery_step(*args)
    want = delivery_step_plain(*args)
    again = delivery_step(*args)
    torch.cuda.synchronize()
    for gk, gp, g2 in zip(got, want, again):
        if gp is None:
            assert gk is None and g2 is None
            continue
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-4)
        assert torch.equal(gk.view(torch.int32), g2.view(torch.int32))


@pytest.mark.parametrize("b,p,d,groups", SIM_SHAPES)
def test_sync_step_kernel_matches_plain(cuda, b, p, d, groups):
    from repro_torch.kernels.sim_step.kernel import sync_step
    from repro_torch.kernels.sim_step.ref import sync_step_plain
    v, x, a, xs, noise, _, _ = _sim_inputs(cuda, b, p, d, False, groups)
    nsum = noise.sum(1)
    c = torch.full((b,), 0.02, device=cuda) + 0.01 * torch.arange(
        b, device=cuda)
    got = sync_step(x, a, xs, nsum, c)
    want = sync_step_plain(x, a, xs, nsum, c)
    again = sync_step(x, a, xs, nsum, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_sim_step_kernels_raise_on_what_they_do_not_take(cuda):
    from repro_torch.kernels.sim_step.kernel import delivery_step, sync_step
    v, x, a, xs, noise, u, _ = _sim_inputs(cuda, 1, 8, 32, False)
    with pytest.raises(ValueError):
        delivery_step(v.cpu(), x, a, xs, noise, u)
    with pytest.raises(ValueError):
        delivery_step(v.double(), x, a, xs, noise, u)
    with pytest.raises(ValueError):
        delivery_step(v, x, a, xs, noise, u[:, :-1])
    big = torch.zeros((1, 65, 32), device=cuda)
    with pytest.raises(ValueError):
        delivery_step(big, x, a, xs, big, torch.zeros((1, 66, 65),
                                                      device=cuda))
    with pytest.raises(ValueError):
        sync_step(x, a, xs, x, torch.zeros(2, device=cuda))


@pytest.mark.parametrize("m,r", [(8, 32), (16, 512), (32, 4096), (8, 100),
                                 (3, 1), (1, 70001), (64, 7)])
def test_onebit_ef_kernel_matches_plain(cuda, m, r):
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    gen = torch.Generator(device=cuda).manual_seed(r)
    g = torch.randn((m, r), generator=gen, device=cuda)
    e = 0.1 * torch.randn((m, r), generator=gen, device=cuda)
    g[-1] = 0.0                      # a row of zeros: all in the + class
    e[-1] = 0.0
    got = onebit_ef(g, e)
    want = onebit_ef_plain(g, e)
    again = onebit_ef(g, e)
    torch.cuda.synchronize()
    assert got[0].shape == (m, (r + 7) // 8)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6)
    for x1, x2 in zip(got, again):
        assert torch.equal(x1, x2)


def test_onebit_ef_kernel_residual_in_place(cuda):
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((8, 1000), generator=gen, device=cuda)
    e = torch.randn((8, 1000), generator=gen, device=cuda)
    want = onebit_ef_plain(g, e)
    err = e.clone()
    got = onebit_ef(g, err, out_err=err)
    torch.cuda.synchronize()
    assert got[2].data_ptr() == err.data_ptr()
    torch.testing.assert_close(err, want[2], rtol=1e-6, atol=1e-6)


def test_fused_sweep_bitwise_equal_to_single_runs(cuda):
    """One batched delivery_step launch per step for every seed gives each
    seed's run bit for bit: each case is one block row of the grid, summed
    in one fixed order."""
    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import Relaxation, simulate, simulate_sweep
    prob = Quadratic(dim=256, cond=8.0, sigma=1.0, seed=0, device=cuda)
    x0 = np.ones(256, np.float32)
    for relax in (Relaxation("elastic_variance", drop_prob=0.3),
                  Relaxation("crash_subst", f=3), Relaxation("sync")):
        batch = simulate_sweep(prob, relax, 16, 0.02, 50, [0, 5, 9], x0=x0,
                               fused=True)
        for s, res in zip([0, 5, 9], batch):
            one = simulate(prob, relax, 16, 0.02, 50, seed=s, x0=x0,
                           fused=True)
            assert np.array_equal(res.x_final.view(np.int32),
                                  one.x_final.view(np.int32))
            assert np.array_equal(res.gap2_over_alpha2,
                                  one.gap2_over_alpha2)


def test_simulator_kernels_count_launches(cuda):
    from repro_torch.core import compression as C
    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import Relaxation, simulate
    from repro_torch.kernels import sim_kernels
    kernels = sim_kernels()
    prob = Quadratic(dim=32, cond=8.0, sigma=1.0, seed=0, device=cuda)
    runs = [(Relaxation("crash", f=2), True, "delivery_step"),
            (Relaxation("sync"), True, "sync_step"),
            (Relaxation("ef_comp", compressor=C.topk_compressor(0.25)),
             False, "topk_ef"),
            (Relaxation("ef_comp", compressor=C.onebit_compressor()), False,
             "onebit_ef")]
    for relax, fused, name in runs:
        before = {k.name: k.launches for k in kernels}
        res = simulate(prob, relax, 8, 0.02, 12, seed=1, fused=fused)
        after = {k.name: k.launches for k in kernels}
        assert np.isfinite(res.losses).all()
        assert {k: after[k] - before[k] for k in after} == {
            k: (12 if k == name else 0) for k in after}
