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
from repro_torch.kernels.topk_ef.ref import (documented_order,  # noqa: E402
                                             q_dense, topk_ef_plain)

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


def _topk_in_documented_order(cuda, g, e, k):
    """K1 against its plain version with the picks in the documented order
    (above the threshold, then the ties, each in index order): vals, idx
    and the residual bitwise, and bitwise from run to run."""
    tg = torch.from_numpy(g).to(cuda)
    te = None if e is None else torch.from_numpy(e).to(cuda)
    kv, ki, ke = topk_ef(tg, te, k)
    again = topk_ef(tg, te, k)
    pv, pi, pe = topk_ef_plain(tg, te, k)
    torch.cuda.synchronize()
    dv, di = documented_order(pv, pi)
    assert torch.equal(ki, di)
    assert torch.equal(kv.view(torch.int32), dv.view(torch.int32))
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
    for a, b in zip((kv, ki, ke), again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("r", [2048, 3584, 57344])
def test_topk_ef_kernel_small_leaves(cuda, r):
    """The path's small leaves (the final norm, q_norm / k_norm, the
    stacked norms) at ratio 1/16."""
    g, e = _rows((2, r), seed=r, ties=False)      # row 1 is all zero
    _topk_in_documented_order(cuda, g[:1].copy(), e[:1].copy(), r // 16)


@pytest.mark.parametrize("kind", ["zeros", "ties"])
def test_topk_ef_kernel_overflow_route(cuda, kind):
    """Rows whose threshold bin holds more keys than the candidate list
    (``candidate_cap``: R / 16 here) take the second route on the device:
    an all-zero row with -0.0 beside 0.0, and few distinct magnitudes."""
    from repro_torch.kernels.topk_ef.kernel import candidate_cap
    r = 1 << 22
    if kind == "zeros":
        g = np.zeros((1, r), np.float32)
        g[0, ::3] = -0.0
        e = None
    else:
        g, e = _rows((2, r), seed=7, ties=True)   # row 1 is all zero
        g, e = g[:1].copy(), e[:1].copy()
    w = g if e is None else e + g
    keys = w.view(np.uint32) & 0x7fffffff
    k = r // 16
    t = np.sort(keys[0])[::-1][k - 1]
    assert ((keys[0] >> 20) == (t >> 20)).sum() > candidate_cap(r)
    _topk_in_documented_order(cuda, g, e, k)


@pytest.mark.parametrize("m,r,k", [(8, 257, 16), (8, 1001, 100),
                                   (3, 3, 2)])
def test_topk_ef_kernel_unaligned_rows(cuda, m, r, k):
    """M = 8 with R % 4 != 0: rows start off 16 bytes (the scalar route)."""
    g, e = _rows((m, r), seed=r, ties=True)
    _topk_in_documented_order(cuda, g, e, k)


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


def _k1_payloads(cuda, s, m, r, k, ties, seed):
    """S messages as the paths make them: ``topk_ef``'s picks of seeded
    rows, in K1's documented order (at most two ascending runs a row)."""
    vals, idx = [], []
    for i in range(s):
        g, _ = _rows((m, r), seed=seed + i, ties=ties)
        v, j, _ = topk_ef(torch.from_numpy(g).to(cuda), None, k)
        vals.append(v)
        idx.append(j)
    return torch.stack(vals), torch.stack(idx)


def _permuted(cuda, m, r, k, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(r)[:k]
                                      for _ in range(m)]).astype(
        np.int32)).to(cuda)


# (M, R, k, ties): the path's shape cut down, rows off 16 bytes, a row of
# one pick, ties (a long second run after the picks above the threshold)
K1_PAYLOADS = [(1, 1 << 20, 1 << 16, False), (8, 1001, 50, True),
               (24, 257, 16, False), (2, 70000, 4375, True), (3, 3, 1, True)]


@pytest.mark.parametrize("m,r,k,ties", K1_PAYLOADS)
@pytest.mark.parametrize("mixed", [False, True])
def test_topk_deposit_k1_payloads_bitwise(cuda, m, r, k, ties, mixed):
    """Payloads as the path makes them (mixed: the last message permuted);
    two messages share a slot; bitwise the plain version, twice in a
    row."""
    vals, idx = _k1_payloads(cuda, 3, m, r, k, ties, seed=r)
    if mixed:
        idx[2] = _permuted(cuda, m, r, k, seed=r)
    acc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, m, r)).astype(np.float32)).to(cuda)
    slots = torch.tensor([1, 1, 2], dtype=torch.int32, device=cuda)
    w = torch.tensor([1.0, 0.5, 0.25], device=cuda)
    want = topk_cr_deposit_plain(acc.clone(), vals, idx, slots, w)
    for _ in range(2):
        got = topk_cr_deposit(acc.clone(), vals, idx, slots, w)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_topk_kernels_at_the_longest_leaf(cuda):
    """K1, K2 and K4 at R = 369,098,752, moonshot-v1-16b-a3b's ``w_gate``
    at 2 layers (64 x 2048 x 1408 a layer), the longest row any path
    gives them (qwen3's was 352,321,536), k = R / 16: K1's picks in the
    documented order, K2's ring (2 slots) and K4's sum of 2 payloads, each
    bitwise the plain version."""
    from repro_torch.kernels.cr_reduce.kernel import topk_cr_reduce
    from repro_torch.kernels.cr_reduce.ref import topk_cr_reduce_plain
    r = 2 * 64 * 2048 * 1408
    k = r // 16
    gen = torch.Generator(device=cuda).manual_seed(r)
    g = torch.randn((1, r), generator=gen, device=cuda)
    e = 0.1 * torch.randn((1, r), generator=gen, device=cuda)
    kv, ki, ke = topk_ef(g, e, k)
    pv, pi, pe = topk_ef_plain(g, e, k)
    torch.cuda.synchronize()
    dv, di = documented_order(pv, pi)
    assert torch.equal(ki, di)
    assert torch.equal(kv.view(torch.int32), dv.view(torch.int32))
    assert torch.equal(ke.view(torch.int32), pe.view(torch.int32))
    del e, ke, pe, pv, pi, dv, di
    v2, i2, _ = topk_ef(g.neg_(), None, k, out_err=g)
    vals, idx = torch.stack([kv, v2]), torch.stack([ki, i2])
    del g, kv, ki, v2, i2
    torch.cuda.empty_cache()
    w = torch.tensor([1.0, 0.5], device=cuda)
    want = topk_cr_reduce_plain(vals, idx, w, r)
    got = topk_cr_reduce(vals, idx, w, r)
    torch.cuda.synchronize()
    assert topk_cr_reduce.last_route() == "segment"
    assert _bits_equal(got, want)
    del got, want
    torch.cuda.empty_cache()
    acc = 0.01 * torch.randn((2, 1, r), generator=gen, device=cuda)
    slots = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    want = topk_cr_deposit_plain(acc.clone(), vals, idx, slots, w)
    got = topk_cr_deposit(acc, vals, idx, slots, w)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
# the synchronous sync's reduces: topk_cr_reduce (K4), onebit_cr_reduce (K5)
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    """Bitwise equal, with NaN (of any payload) at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def _reduce_inputs(cuda, s, m, r, k, shared=False, seed=0):
    """S messages: top-k payloads with unique indices per row (shared: the
    same indices in every message), sign maps, means and weights."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((s, m, k)).astype(np.float32)
    rows = lambda: np.stack([rng.permutation(r)[:k] for _ in range(m)])
    idx = np.stack([rows()] * s if shared else [rows() for _ in range(s)])
    pos = rng.random((s, m, r)) < 0.5
    means = rng.standard_normal((s, m, 2)).astype(np.float32)
    weights = rng.uniform(0.0, 1.5, (s,)).astype(np.float32)
    return [torch.from_numpy(x).to(cuda) for x in
            (vals, idx.astype(np.int32), pos, means, weights)]


@pytest.mark.parametrize("s,m,r,k,shared", [
    (2, 1, 4096, 256, False), (3, 16, 100, 7, False), (5, 24, 257, 1, False),
    (2, 8, 64, 64, False), (4, 1, 1 << 20, 1 << 16, True),
    (2, 1, 1 << 24, 1 << 20, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_kernels_match_plain_bitwise(cuda, s, m, r, k, shared, dtype):
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_reduce,
                                                      topk_cr_reduce)
    from repro_torch.kernels.cr_reduce.ref import (onebit_cr_reduce_plain,
                                                   topk_cr_reduce_plain)
    vals, idx, pos, means, w = _reduce_inputs(cuda, s, m, r, k, shared)
    vals = vals.to(getattr(torch, dtype))
    got = topk_cr_reduce(vals, idx, w, r)
    again = topk_cr_reduce(vals, idx, w, r)
    want = topk_cr_reduce_plain(vals, idx, w, r)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, r)
    assert _bits_equal(got, want) and _bits_equal(got, again)
    got = onebit_cr_reduce(pos, means, w)
    again = onebit_cr_reduce(pos, means, w)
    want = onebit_cr_reduce_plain(pos, means, w)
    torch.cuda.synchronize()
    assert _bits_equal(got, want) and _bits_equal(got, again)


@pytest.mark.parametrize("m,r,k,ties", K1_PAYLOADS)
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_reduce_k1_payloads_bitwise(cuda, m, r, k, ties, mixed, dtype):
    """As the deposit's case: the segment route for K1-ordered payloads,
    the atomic route when one message is permuted; a zero weight; bitwise
    the plain version, twice in a row."""
    from repro_torch.kernels.cr_reduce.kernel import topk_cr_reduce
    from repro_torch.kernels.cr_reduce.ref import topk_cr_reduce_plain
    vals, idx = _k1_payloads(cuda, 3, m, r, k, ties, seed=r + 1)
    if mixed:
        idx[1] = _permuted(cuda, m, r, k, seed=r)
    vals = vals.to(getattr(torch, dtype))
    w = torch.tensor([1.0, 0.0, 0.5], device=cuda)
    want = topk_cr_reduce_plain(vals, idx, w, r)
    for _ in range(2):
        got = topk_cr_reduce(vals, idx, w, r)
        torch.cuda.synchronize()
        assert topk_cr_reduce.last_route() == ("atomic" if mixed and k > 1
                                               else "segment")
        assert _bits_equal(got, want)


def test_topk_reduce_sparse_second_run(cuda):
    """A second run of a few picks far apart (ties spread over the row):
    each gap crosses hundreds of segment boundaries, which a warp writes
    out together; bitwise the plain version, on the segment route."""
    from repro_torch.kernels.cr_reduce.kernel import topk_cr_reduce
    from repro_torch.kernels.cr_reduce.ref import topk_cr_reduce_plain
    rng = np.random.default_rng(3)
    r = 1 << 23
    rows = []
    for _ in range(2):
        ties = np.sort(rng.choice(r, size=6, replace=False))
        rest = np.setdiff1d(rng.choice(r, size=40000, replace=False), ties)
        rows.append(np.concatenate([np.sort(rest)[:39990], ties]))
    idx = torch.from_numpy(np.stack(rows)[:, None].astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.standard_normal(idx.shape).astype(
        np.float32)).to(cuda)
    w = torch.tensor([1.0, 0.5], device=cuda)
    want = topk_cr_reduce_plain(vals, idx, w, r)
    for _ in range(2):
        got = topk_cr_reduce(vals, idx, w, r)
        torch.cuda.synchronize()
        assert topk_cr_reduce.last_route() == "segment"
        assert _bits_equal(got, want)


def test_reduce_kernels_zero_weight_inf_and_empty(cuda):
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_reduce,
                                                      topk_cr_reduce)
    from repro_torch.kernels.cr_reduce.ref import (onebit_cr_reduce_plain,
                                                   topk_cr_reduce_plain)
    vals, idx, pos, means, w = _reduce_inputs(cuda, 3, 24, 257, 1, seed=1)
    w[1] = 0.0
    vals[2, 5, 0] = float("inf")
    means[2, 5, 0] = float("inf")
    w[2] = 0.0
    got = topk_cr_reduce(vals, idx, w, 257)
    assert _bits_equal(got, topk_cr_reduce_plain(vals, idx, w, 257))
    assert int(torch.isnan(got).sum()) == 1
    got = onebit_cr_reduce(pos, means, w)
    assert _bits_equal(got, onebit_cr_reduce_plain(pos, means, w))
    assert int(torch.isnan(got).sum()) == int(pos[2, 5].sum())
    for s, k in ((0, 4), (2, 0)):                   # the zero fill alone
        out = topk_cr_reduce(torch.zeros((s, 3, k), device=cuda),
                             torch.zeros((s, 3, k), dtype=torch.int32,
                                         device=cuda),
                             torch.ones((s,), device=cuda), 50)
        assert tuple(out.shape) == (3, 50) and not out.any()
    out = onebit_cr_reduce(torch.zeros((0, 3, 50), dtype=torch.bool,
                                       device=cuda),
                           torch.zeros((0, 3, 2), device=cuda),
                           torch.ones((0,), device=cuda))
    assert tuple(out.shape) == (3, 50) and not out.any()


def test_reduce_kernels_check_and_count(cuda):
    from repro_torch.kernels import sync_kernels
    from repro_torch.kernels.cr_reduce import ops as CR
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_reduce,
                                                      topk_cr_reduce)
    vals, idx, pos, means, w = _reduce_inputs(cuda, 2, 4, 64, 8)
    for bad in ((vals.half(), idx, w, 64), (vals, idx.long(), w, 64),
                (vals, idx, w.double(), 64), (vals.cpu(), idx, w, 64),
                (vals.transpose(1, 2), idx, w, 64), (vals, idx, w, 4)):
        with pytest.raises(ValueError):
            topk_cr_reduce(*bad)
    for bad in ((pos.float(), means, w), (pos, means.double(), w),
                (pos, means[:, :, :1].contiguous(), w), (pos, means, w[:1])):
        with pytest.raises(ValueError):
            onebit_cr_reduce(*bad)
    before = [k.launches for k in sync_kernels()]
    out = CR.topk_reduce(vals, idx, w, 64)            # CUDA: the kernels
    out2 = CR.onebit_reduce(pos, means, w)
    after = [k.launches for k in sync_kernels()]
    assert out.is_cuda and out2.is_cuda
    assert [b - a for a, b in zip(before, after)] == [0, 1, 1]


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


@pytest.mark.parametrize("d", [32, 1000, 4096])
def test_sync_step_kernel_batch_is_bitwise_its_single_cases(cuda, d):
    """Each case of a B = 3 launch (A shared, and one A per case) is bit
    for bit its own B = 1 launch: a case's summation order depends on d
    alone; and within the plain version's tolerance."""
    from repro_torch.kernels.sim_step.kernel import sync_step
    from repro_torch.kernels.sim_step.ref import sync_step_plain
    for groups in (None, 3):
        v, x, a, xs, noise, _, _ = _sim_inputs(cuda, 3, 4, d, False, groups,
                                               seed=d)
        nsum = noise.sum(1)
        c = 0.02 + 0.01 * torch.arange(3, device=cuda, dtype=torch.float32)
        got = sync_step(x, a, xs, nsum, c)
        want = sync_step_plain(x, a, xs, nsum, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        for i in range(3):
            ai, xsi = (a, xs) if groups is None else (
                a[i].contiguous(), xs[i].contiguous())
            one = sync_step(x[i:i + 1].contiguous(), ai, xsi,
                            nsum[i:i + 1].contiguous(), c[i:i + 1].contiguous())
            assert torch.equal(one[0].view(torch.int32),
                               got[i].view(torch.int32))


@pytest.mark.parametrize("d", [32, 256, 1000, 1030, 4096])
def test_delivery_step_kernel_batch_is_bitwise_its_single_cases(cuda, d):
    """Each case of a B = 3 launch (A shared, and one A per case) is bit
    for bit its own B = 1 launch and within the plain version's
    tolerance: the walk (d <= 512) or the split (above; d = 1030 with rows
    off 16 bytes), chosen by d alone."""
    from repro_torch.kernels.sim_step.kernel import delivery_step
    from repro_torch.kernels.sim_step.ref import delivery_step_plain
    for groups in (None, 3):
        args = _sim_inputs(cuda, 3, 16, d, True, groups, seed=d)
        got = delivery_step(*args)
        want = delivery_step_plain(*args)
        torch.cuda.synchronize()
        for gk, gp in zip(got, want):
            torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-4)
        v, x, a, xs, noise, u, dfr = args
        for i in range(3):
            ai, xsi = (a, xs) if groups is None else (
                a[i].contiguous(), xs[i].contiguous())
            one = delivery_step(v[i:i + 1].contiguous(),
                                x[i:i + 1].contiguous(), ai, xsi,
                                noise[i:i + 1].contiguous(),
                                u[i:i + 1].contiguous(),
                                dfr[i:i + 1].contiguous())
            torch.cuda.synchronize()
            for o, g in zip(one, got):
                assert torch.equal(o[0].view(torch.int32),
                                   g[i].view(torch.int32))


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
                                 (3, 1), (1, 70001), (64, 7), (256, 256),
                                 (8, 2048), (8, 2049), (1, 131072),
                                 (1, 131073), (1, 1 << 20), (200, 50000)])
def test_onebit_ef_kernel_matches_plain(cuda, m, r):
    """Both routes and their edges (the warp route up to WARP_ROW_MAX = 2048
    entries, a cluster's registers up to 131,072, passes beyond; one CTA a
    row at (32, 4096) and, looping, at (200, 50000)).  Row 0
    holds -0.0 entries (the + class) when M >= 2, row 1 a NaN (the - class)
    when M >= 3, the last row is all zero."""
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    gen = torch.Generator(device=cuda).manual_seed(r)
    g = torch.randn((m, r), generator=gen, device=cuda)
    e = 0.1 * torch.randn((m, r), generator=gen, device=cuda)
    if m >= 2:
        g[0, ::3] = -0.0
        e[0, ::3] = -0.0
    if m >= 3:
        g[1, r // 2] = float("nan")
    g[-1] = 0.0                      # a row of zeros: all in the + class
    e[-1] = 0.0
    got = onebit_ef(g, e)
    want = onebit_ef_plain(g, e)
    again = onebit_ef(g, e)
    torch.cuda.synchronize()
    assert got[0].shape == (m, (r + 7) // 8)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    for x1, x2 in zip(got, again):
        assert torch.equal(x1.view(torch.uint8), x2.view(torch.uint8))


@pytest.mark.parametrize("m,r", [(8, 1000), (32, 4096), (8, 4096),
                                 (2, 200001)])
def test_onebit_ef_kernel_residual_in_place(cuda, m, r):
    """out_err = err on each route: the warp rows, one CTA a row, a cluster
    of 8 holding its row in registers and a row that loops over passes
    (read again after the cluster's exchange)."""
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef, plan
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((m, r), generator=gen, device=cuda)
    e = torch.randn((m, r), generator=gen, device=cuda)
    want = onebit_ef_plain(g, e)
    apart = onebit_ef(g, e)
    err = e.clone()
    got = onebit_ef(g, err, out_err=err)
    torch.cuda.synchronize()
    assert got[2].data_ptr() == err.data_ptr()
    torch.testing.assert_close(err, want[2], rtol=1e-6, atol=1e-6)
    for x1, x2 in zip(got, apart):
        assert torch.equal(x1, x2)
    assert plan(m, r)[0] == ("warp" if r <= 2048 else "cluster")


def test_onebit_ef_kernel_raises_on_what_it_does_not_take(cuda):
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    g = torch.randn((8, 64), device=cuda)
    e = torch.zeros_like(g)
    before = onebit_ef.launches
    for bad_g, bad_e in ((g.t().contiguous().t(), e.t().contiguous().t()),
                         (g[:, ::2], e[:, ::2]), (g.half(), e),
                         (g.cpu(), e)):
        with pytest.raises(ValueError):
            onebit_ef(bad_g, bad_e)
    with pytest.raises(ValueError):
        onebit_ef(g, e, out_err=torch.empty((64, 8), device=cuda).t())
    assert onebit_ef.launches == before


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


# ---------------------------------------------------------------------------
# serving: swa_decode_attention (K9)
# ---------------------------------------------------------------------------

def _swa_inputs(cuda, b, kv, g, d, t, dtype, seed=0):
    """Rows as the paged decode makes them, and harder ones: row 0 keys
    from position 0 with the query at the end; row 1 a window that slid
    (base > 0, pos - base > window); row 2 most keys beyond pos; the last
    row no live key (all its keys beyond pos)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda).to(dtype)
               for s in ((b, kv, g, d), (b, t, kv, d), (b, t, kv, d)))
    base = np.array([0, 150, 3, 500][:b], np.int32)
    pos = np.array([t - 1, 150 + t - 1, 40, 100][:b], np.int32)
    return q, k, v, torch.from_numpy(pos).to(cuda), \
        torch.from_numpy(base).to(cuda)


@pytest.mark.parametrize("t", [4112, 1000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swa_decode_kernel_matches_plain(cuda, t, dtype):
    """The serving path's shape (B 4, KV 8, G 4, D 128, T 4112 = 257 pages
    of 16, window 4096) and a ragged T, and bitwise from run to run.  bf16
    element by element within one bf16 rounding step of the plain version
    (1e-5 + 2^-7 |plain|): the outputs are near sqrt(e / T), so a fixed
    2e-2 would be as large as the values; f32 within 3e-6 (the bound of
    tests/test_kernels.py)."""
    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    from repro_torch.kernels.swa_attention.ref import swa_decode_plain
    dt = getattr(torch, dtype)
    q, k, v, pos, base = _swa_inputs(cuda, 4, 8, 4, 128, t, dt, seed=t)
    got = swa_decode_attention(q, k, v, pos, base, window=4096)
    again = swa_decode_attention(q, k, v, pos, base, window=4096)
    want = swa_decode_plain(q, k, v, pos, base, window=4096)
    torch.cuda.synchronize()
    assert got.dtype == dt and torch.isfinite(got).all()
    atol, rtol = (1e-5, 2.0 ** -7) if dtype == "bfloat16" else (3e-6, 0.0)

    def within(a, b):
        return bool(((a.float() - b.float()).abs()
                     <= atol + rtol * b.float().abs()).all())

    assert within(got, want)
    assert torch.equal(got, again)
    # the row with no live key: the mean of its values
    assert within(got[3], v[3].float().mean(0)[:, None].expand(8, 4, 128))


def _swa_within(got, want, dtype):
    atol, rtol = (1e-5, 2.0 ** -7) if dtype == "bfloat16" else (3e-6, 0.0)
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("shape,window", [
    ((4, 8, 1, 128, 4112), 4096), ((4, 8, 8, 128, 4112), 4096),
    ((4, 2, 16, 128, 1000), 4096), ((4, 8, 4, 64, 4112), 4096),
    ((4, 4, 4, 256, 2000), 4096), ((4, 8, 4, 128, 1000), 12),
    ((4, 2, 3, 50, 300), 64), ((4, 2, 5, 72, 300), 0)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swa_decode_kernel_heads_widths_and_windows(cuda, shape, window,
                                                    dtype):
    """G in {1, 8, 16}, D in {64, 256}, a window shorter than one split
    (12 keys), and D = 50 (rows not a multiple of 16 bytes: element loads)
    and 72 (nine 16-byte chunks a bf16 row), on the rows of ``_swa_inputs``:
    within the limits of
    ``test_swa_decode_kernel_matches_plain``, the row with no live key the
    mean of its values, bitwise from run to run."""
    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    from repro_torch.kernels.swa_attention.ref import swa_decode_plain
    b, kv, g, d, t = shape
    dt = getattr(torch, dtype)
    q, k, v, pos, base = _swa_inputs(cuda, b, kv, g, d, t, dt, seed=g + d)
    got = swa_decode_attention(q, k, v, pos, base, window=window)
    again = swa_decode_attention(q, k, v, pos, base, window=window)
    want = swa_decode_plain(q, k, v, pos, base, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and torch.isfinite(got).all()
    assert _swa_within(got, want, dtype)
    assert torch.equal(got, again)
    assert _swa_within(got[3], v[3].float().mean(0)[:, None].expand(kv, g, d),
                       dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swa_decode_kernel_serving_step_rows(cuda, dtype):
    """The rows of the profiled serving decode step: 4 rows of about 503
    live keys of T = 4112 (257 pages of 16), base 0, window 4096."""
    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    from repro_torch.kernels.swa_attention.ref import swa_decode_plain
    dt = getattr(torch, dtype)
    q, k, v, _, _ = _swa_inputs(cuda, 4, 8, 4, 128, 4112, dt, seed=503)
    pos = torch.tensor([502, 503, 501, 500], dtype=torch.int32, device=cuda)
    base = torch.zeros(4, dtype=torch.int32, device=cuda)
    got = swa_decode_attention(q, k, v, pos, base, window=4096)
    again = swa_decode_attention(q, k, v, pos, base, window=4096)
    want = swa_decode_plain(q, k, v, pos, base, window=4096)
    torch.cuda.synchronize()
    assert _swa_within(got, want, dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swa_decode_kernel_many_splits(cuda, dtype):
    """More splits than the merge stages at once (a long row without a
    window: 128 splits of 2 rows): the merge that reads the partials one
    output at a time; bitwise from run to run."""
    from repro_torch.kernels.swa_attention.kernel import (num_splits,
                                                          swa_decode_attention)
    from repro_torch.kernels.swa_attention.ref import swa_decode_plain
    dt = getattr(torch, dtype)
    q, k, v, pos, base = _swa_inputs(cuda, 2, 1, 2, 64, 20000, dt, seed=7)
    assert num_splits(2, 1, 2, 20000, 0) > 64
    got = swa_decode_attention(q, k, v, pos, base, window=0)
    again = swa_decode_attention(q, k, v, pos, base, window=0)
    want = swa_decode_plain(q, k, v, pos, base, window=0)
    torch.cuda.synchronize()
    assert _swa_within(got, want, dtype)
    assert torch.equal(got, again)


def test_swa_decode_kernel_checks_and_counts(cuda):
    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    q, k, v, pos, base = _swa_inputs(cuda, 2, 2, 2, 32, 64, torch.float32)
    before = swa_decode_attention.launches
    swa_decode_attention(q, k, v, pos, base, window=0)
    assert swa_decode_attention.launches == before + 1
    with pytest.raises(ValueError):
        swa_decode_attention(q, k.to(torch.bfloat16), v, pos, base)
    with pytest.raises(ValueError):
        swa_decode_attention(q, k.transpose(1, 2), v, pos, base)
    with pytest.raises(ValueError):
        swa_decode_attention(q.cpu(), k, v, pos, base)


# ---------------------------------------------------------------------------
# the hybrid serving path: ssd_chunked (K10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((4, 4096, 64, 112, 64), "bfloat16"), ((2, 256, 8, 112, 64), "float32"),
    ((1, 8, 4, 16, 16), "float32"), ((2, 256, 8, 128, 128), "bfloat16")])
def test_ssd_chunked_kernel_matches_plain(cuda, shape, dtype):
    """The hybrid serving path's shape and smaller ones, bitwise from run
    to run.  y and the state within 4e-6 of the plain version's largest
    magnitude (f32 sums in other orders); bf16 y also within one bf16
    rounding step, 2^-7 |plain| (see chip_smoke.py's SSD_REL)."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain
    b, t, h, hd, n = shape
    rng = np.random.default_rng(t + hd)
    dt = getattr(torch, dtype)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(cuda)

    x, bm, cm = arr(b, t, h, hd).to(dt), arr(b, t, n).to(dt), \
        arr(b, t, n).to(dt)
    a = -0.1 * torch.from_numpy(rng.uniform(size=(b, t, h)).astype(
        np.float32)).to(cuda)
    before = ssd_chunked.launches
    y, s = ssd_chunked(x, a, bm, cm)
    y2, s2 = ssd_chunked(x, a, bm, cm)
    py, ps = ssd_plain(x, a, bm, cm)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 2
    assert y.dtype == dt and s.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(s, s2)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    limit = 4e-6 * py.float().abs().max() + rtol * py.float().abs()
    assert bool(((y.float() - py.float()).abs() <= limit).all())
    assert float((s - ps).abs().max()) <= 4e-6 * float(ps.abs().max())


@pytest.mark.parametrize("shape,dtype,decay", [
    ((1, 4096, 64, 112, 64), "bfloat16", "u"),    # phase 19's batch 1
    ((2, 384, 8, 40, 24), "bfloat16", "u"),       # hd, N off the 16 tiles
    ((2, 8, 4, 16, 16), "float32", "u"),          # T = 8: one short chunk
    ((1, 100, 3, 20, 5), "float32", "u"),         # rows off 16 bytes, H % 4
    ((2, 512, 8, 112, 64), "bfloat16", "zero"),   # no decay
    ((2, 512, 8, 112, 64), "bfloat16", "-20")])   # exp underflows
def test_ssd_chunked_kernel_cases(cuda, shape, dtype, decay):
    """The three passes at the batch-1 path shape, ragged tiles (rows that
    are not 16-byte multiples are staged element by element), a short
    chunk and extreme decays: within the limits of the test above, bitwise
    from run to run, one launch counted per call."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain
    b, t, h, hd, n = shape
    rng = np.random.default_rng(t + hd + n)
    dt = getattr(torch, dtype)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(cuda)

    x, bm, cm = arr(b, t, h, hd).to(dt), arr(b, t, n).to(dt), \
        arr(b, t, n).to(dt)
    u = rng.uniform(size=(b, t, h)).astype(np.float32)
    a = torch.from_numpy({"u": -0.1 * u, "zero": 0.0 * u,
                          "-20": -20.0 - u}[decay]).to(cuda)
    before = ssd_chunked.launches
    y, s = ssd_chunked(x, a, bm, cm)
    assert ssd_chunked.launches == before + 1
    y2, s2 = ssd_chunked(x, a, bm, cm)
    py, ps = ssd_plain(x, a, bm, cm)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    limit = 4e-6 * py.float().abs().max() + rtol * py.float().abs()
    assert bool(((y.float() - py.float()).abs() <= limit).all())
    assert float((s - ps).abs().max()) <= 4e-6 * float(ps.abs().max())


def test_ssd_chunked_kernel_raises_on_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd import ops as SSD
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    x = torch.randn((1, 256, 2, 16), device=cuda)
    a = -torch.rand((1, 256, 2), device=cuda)
    bm = torch.randn((1, 256, 8), device=cuda)
    for bad in ((x.to(torch.bfloat16), a, bm, bm),          # mixed dtypes
                (x, a.to(torch.bfloat16), bm, bm),          # a not f32
                (x.transpose(1, 2), a, bm, bm),             # not contiguous
                (x[:, :200].contiguous(), a[:, :200].contiguous(),
                 bm[:, :200].contiguous(), bm[:, :200].contiguous()),
                (torch.randn((1, 256, 2, 200), device=cuda), a, bm, bm)):
        with pytest.raises(ValueError):
            ssd_chunked(*bad)
    y, _ = SSD.ssd(x, a, bm, bm)                   # CUDA: the kernel
    assert y.is_cuda


@pytest.mark.parametrize("shape", [(2, 256, 64, 112, 64),
                                   (1, 100, 3, 20, 5)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_chunked_kernel_backward(cuda, shape, dtype):
    """K10 under autograd, at zamba2 training's shape (one worker's batch
    of 2 x 256, 64 heads of 112, N 64) and a ragged one: the forward is
    bitwise the no-grad launch and counted once; the backward launches
    nothing and, fed the same incoming gradients (a loss linear in y and
    the state), gives ``ssd_plain``'s autograd gradients: within 1e-6 of
    each gradient's largest magnitude (both run ``ssd_plain``'s backward on
    the same inputs), in the inputs' dtypes, contiguous."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain
    b, t, h, hd, n = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(t + hd)
    x = torch.randn((b, t, h, hd), generator=gen, device=cuda).to(dt)
    a = -torch.rand((b, t, h), generator=gen, device=cuda)
    bm = torch.randn((b, t, n), generator=gen, device=cuda).to(dt)
    cm = torch.randn((b, t, n), generator=gen, device=cuda).to(dt)
    wy = torch.randn((b, t, h, hd), generator=gen, device=cuda)
    ws = torch.randn((b, h, hd, n), generator=gen, device=cuda)
    y0, s0 = ssd_chunked(x, a, bm, cm)
    grads = []
    for fn in (ssd_chunked, ssd_plain):
        ins = [v.clone().requires_grad_() for v in (x, a, bm, cm)]
        before = ssd_chunked.launches
        y, s = fn(*ins)
        if fn is ssd_chunked:
            assert ssd_chunked.launches == before + 1
            assert torch.equal(y, y0) and torch.equal(s, s0)
        ((y.float() * wy).sum() + (s * ws).sum()).backward()
        if fn is ssd_chunked:
            assert ssd_chunked.launches == before + 1
        grads.append([v.grad for v in ins])
    torch.cuda.synchronize()
    for got, want, v in zip(*grads, (x, a, bm, cm)):
        assert got.dtype == v.dtype and got.is_contiguous()
        assert bool(torch.isfinite(got.float()).all())
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            1e-6 * scale
