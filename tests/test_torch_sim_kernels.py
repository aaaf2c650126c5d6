"""The simulator's kernel modules against the JAX reference, on the CPU.

Each wrapper takes its plain PyTorch version for a CPU tensor; those are
held against the reference's ``ref.py`` oracles and its Pallas kernels in
interpret mode, on the same numpy inputs:

* ``delivery_step`` (K6) and ``sync_step`` (K7): ``rtol=1e-5, atol=1e-4``,
  the tolerance of ``tests/test_sim_step_kernel.py`` (the products sum in
  another order in each framework).  A is symmetric with entries of order
  1/sqrt(d), the scale of the simulator's quadratic (eigenvalues 1..cond).
* ``onebit_ef`` (K8): the packed signs bitwise; the means and the residual
  at ``rtol=1e-6, atol=1e-6`` (the row sums run in another order).
* ``compression``: the dense operators and ``ef_compress_rows`` (top-k
  through K1's plain version, one-bit through K8's, any d).

``tests/test_torch_kernels_cuda.py`` holds the CUDA and Triton kernels
against these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.kernels.onebit_ef.kernel import onebit_ef as jax_onebit_ef  # noqa: E402
from repro.kernels.onebit_ef.ref import onebit_ef_ref  # noqa: E402
from repro.kernels.sim_step import kernel as JK  # noqa: E402
from repro.kernels.sim_step import ref as JR  # noqa: E402

from repro_torch.core import compression as C  # noqa: E402
from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain, unpack  # noqa: E402
from repro_torch.kernels.sim_step import ops as SS  # noqa: E402
from repro_torch.kernels.sim_step.ref import (delivery_step_plain,  # noqa: E402
                                              sync_step_plain)

TOL = dict(rtol=1e-5, atol=1e-4)


def _step_inputs(p, d, defer, seed=0, b=None):
    """v, x, a, x*, noise, u, defer as numpy f32 (leading case axis b when
    given)."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r = n(*lead, d, d)
    a = ((r + np.swapaxes(r, -1, -2)) / (2 * np.sqrt(d))).astype(np.float32)
    m = 1 + 2 * p if defer else 1 + p
    u = n(*lead, m, p) * np.float32(0.05)
    dfr = n(*lead, p, d) * np.float32(0.01) if defer else None
    return (n(*lead, p, d), n(*lead, 1, d), a, n(*lead, 1, d),
            n(*lead, p, d) * np.float32(0.1), u, dfr)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _plain_delivery(v, x, a, xs, noise, u, dfr):
    """The port's plain step on one case (B = 1)."""
    out = delivery_step_plain(_t(v)[None], _t(x[0])[None], _t(a),
                              _t(xs[0]), _t(noise)[None], _t(u)[None],
                              None if dfr is None else _t(dfr)[None])
    return out


@pytest.mark.parametrize("defer", [False, True], ids=["plain", "defer"])
@pytest.mark.parametrize("oracle,d,block_d", [
    ("ref", 32, None), ("ref", 100, None), ("ref", 512, None),
    ("pallas", 32, 128), ("pallas", 32, 256), ("pallas", 512, 128),
    ("pallas", 512, 256)])
def test_delivery_step_plain_matches_reference(oracle, d, block_d, defer):
    p = 8
    v, x, a, xs, noise, u, dfr = _step_inputs(p, d, defer, seed=d)
    if oracle == "ref":
        want = JR.delivery_step_ref(_j(v), _j(x), _j(a), _j(xs), _j(noise),
                                    _j(u), _j(dfr))
    else:
        want = JK.delivery_step(_j(v), _j(x), _j(a), _j(xs), _j(noise),
                                _j(u), _j(dfr), block_d=block_d,
                                has_defer=defer, interpret=True)
    want = [np.asarray(w) for w in want]
    x_new, v_new, d_new, sq = _plain_delivery(v, x, a, xs, noise, u, dfr)
    np.testing.assert_allclose(x_new.numpy(), want[0], **TOL)
    np.testing.assert_allclose(v_new[0].numpy(), want[1], **TOL)
    if defer:
        np.testing.assert_allclose(d_new[0].numpy(), want[2], **TOL)
    else:
        assert d_new is None
    # the fused gap: each view's squared distance to x'
    np.testing.assert_allclose(
        sq[0].numpy(), ((want[0] - want[1]) ** 2).sum(1), rtol=1e-5)


@pytest.mark.parametrize("groups", [1, 3], ids=["shared-A", "stacked-A"])
@pytest.mark.parametrize("defer", [False, True], ids=["plain", "defer"])
def test_batched_delivery_step_matches_reference_per_case(groups, defer):
    """B = 3 cases in one call equal three reference calls; A and x* are
    shared (G = 1) or one per case (G = B)."""
    b, p, d = 3, 8, 64
    v, x, a, xs, noise, u, dfr = _step_inputs(p, d, defer, seed=7, b=b)
    a_g, xs_g = a[:groups], xs[:groups, 0]
    got = SS.fused_delivery_step(
        _t(v), _t(x[:, 0]), _t(a_g[0] if groups == 1 else a_g),
        _t(xs_g[0] if groups == 1 else xs_g), _t(noise), _t(u), _t(dfr))
    for i in range(b):
        gi = 0 if groups == 1 else i
        want = JR.delivery_step_ref(
            _j(v[i]), _j(x[i]), _j(a[gi]), _j(xs[gi]), _j(noise[i]), _j(u[i]),
            None if dfr is None else _j(dfr[i]))
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0])[0],
                                   **TOL)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   **TOL)
        if defer:
            np.testing.assert_allclose(got[2][i].numpy(),
                                       np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("oracle,d,block_d", [
    ("ref", 32, None), ("ref", 100, None), ("ref", 512, None),
    ("pallas", 32, 128), ("pallas", 512, 128), ("pallas", 512, 256)])
def test_sync_step_plain_matches_reference(oracle, d, block_d):
    _, x, a, xs, noise, _, _ = _step_inputs(4, d, False, seed=d + 1)
    nsum = noise[:1]
    c = np.float32(0.03)
    if oracle == "ref":
        want = JR.sync_step_ref(_j(x), _j(a), _j(xs), _j(nsum), c)
    else:
        want = JK.sync_step(_j(x), _j(a), _j(xs), _j(nsum),
                            jnp.full((1, 1), c, jnp.float32),
                            block_d=block_d, interpret=True)
    got = SS.fused_sync_step(_t(x), _t(a), _t(xs[0]), _t(nsum),
                             torch.tensor([c]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_sync_step_stacked_groups():
    """Four cases on two problems (cases 0-1 on A[0], 2-3 on A[1])."""
    _, x, a, xs, noise, _, _ = _step_inputs(4, 48, False, seed=5, b=4)
    c = np.array([0.01, 0.02, 0.03, 0.04], np.float32)
    got = sync_step_plain(_t(x[:, 0]), _t(a[:2]), _t(xs[:2, 0]),
                          _t(noise[:, 0]), _t(c))
    for i in range(4):
        want = JR.sync_step_ref(_j(x[i]), _j(a[i // 2]), _j(xs[i // 2]),
                                _j(noise[i, :1]), c[i])
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want)[0],
                                   **TOL)


def _ef_rows(m, r, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, r)).astype(np.float32)
    e = (0.1 * rng.standard_normal((m, r))).astype(np.float32)
    g[-1] = 0.0
    e[-1] = 0.0                      # an all-zero row: every entry is "+"
    return g, e


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("m,r", [(8, 32), (16, 512), (8, 1024)])
def test_onebit_ef_plain_matches_reference(m, r, oracle):
    g, e = _ef_rows(m, r, seed=r)
    fn = onebit_ef_ref if oracle == "ref" else \
        (lambda a, b: jax_onebit_ef(a, b, interpret=True))
    jp, jm, je = map(np.asarray, fn(jnp.asarray(g), jnp.asarray(e)))
    tp, tm, te = onebit_ef_plain(_t(g), _t(e))
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (m, r // 8)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [1, 7, 100, 1001])
def test_onebit_ef_plain_any_row_length(r):
    """R % 8 != 0, which the reference kernel does not take: each row
    against the reference's own wire format (``onebit_compress`` pads the
    sign map with zero bits) and its dense ``onebit_q``."""
    g, e = _ef_rows(3, r, seed=r)
    tp, tm, te = onebit_ef_plain(_t(g), _t(e))
    assert tuple(tp.shape) == (3, (r + 7) // 8)
    w = e + g
    for i in range(3):
        packed, mp, mn = JC.onebit_compress(jnp.asarray(w[i]))
        np.testing.assert_array_equal(tp[i].numpy(), np.asarray(packed))
        np.testing.assert_allclose(tm[i].numpy(), [float(mp), float(mn)],
                                   rtol=1e-6, atol=1e-6)
        q = np.asarray(JC.onebit_q(jnp.asarray(w[i])))
        np.testing.assert_allclose(te[i].numpy(), w[i] - q, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(unpack(tp, tm, r).numpy(), w - te.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,d", [("topk", 32), ("topk", 100),
                                    ("onebit", 32), ("onebit", 100)])
def test_ef_compress_rows_matches_reference(kind, d):
    """One EF round per worker row: top-k through K1's plain version,
    one-bit through K8's (d = 100 is the reference's ``vmap(onebit_q)``
    branch)."""
    rng = np.random.default_rng(d)
    upd = rng.standard_normal((8, d)).astype(np.float32)
    err = (0.1 * rng.standard_normal((8, d))).astype(np.float32)
    jcomp = JC.topk_compressor(0.25) if kind == "topk" else \
        JC.onebit_compressor()
    tcomp = C.topk_compressor(0.25) if kind == "topk" else \
        C.onebit_compressor()
    jpay, jerr = JC.ef_compress_rows(jcomp, jnp.asarray(upd),
                                     jnp.asarray(err))
    tpay, terr = C.ef_compress_rows(tcomp, _t(upd), _t(err))
    tol = dict(rtol=0, atol=0) if kind == "topk" else \
        dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tpay.numpy(), np.asarray(jpay), **tol)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), **tol)
    # the dense per-worker round gives the same payloads
    for i in range(8):
        pay, e2 = C.ef_compress(tcomp, _t(upd[i]), _t(err[i]))
        np.testing.assert_allclose(pay.numpy(), tpay[i].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_dense_compressors_match_reference():
    rng = np.random.default_rng(0)
    w = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=37).astype(np.float32)
    for k in (1, 5, 37):
        np.testing.assert_array_equal(C.topk_q(_t(w), k).numpy(),
                                      np.asarray(JC.topk_q(jnp.asarray(w),
                                                           k)))
    np.testing.assert_allclose(C.onebit_q(_t(w)).numpy(),
                               np.asarray(JC.onebit_q(jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    packed, mp, mn = C.onebit_compress(_t(w))
    jpacked, jmp, jmn = JC.onebit_compress(jnp.asarray(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(
        C.onebit_decompress(packed, mp, mn, 37).numpy(),
        np.asarray(JC.onebit_decompress(jpacked, jmp, jmn, 37)))
    for n in (8, 100):
        assert C.topk_gamma(n, 3) == JC.topk_gamma(n, 3)
        assert C.onebit_gamma(n) == JC.onebit_gamma(n)
        assert C.topk_compressor(0.25).gamma(n) == \
            JC.topk_compressor(0.25).gamma(n)
    # QSGD: unbiased with the port's own generator (its draws cannot be
    # the reference's), and on the reference's level grid
    gen = torch.Generator().manual_seed(0)
    x = _t(rng.standard_normal(16).astype(np.float32))
    mean = torch.stack([C.qsgd_q(x, gen) for _ in range(4000)]).mean(0)
    np.testing.assert_allclose(mean.numpy(), x.numpy(), atol=0.1)
    q = C.qsgd_q(x, gen) / torch.linalg.vector_norm(x) * 4
    np.testing.assert_allclose(q.numpy(), np.round(q.numpy()), atol=1e-4)
    jq = JC.qsgd_q(jnp.asarray(x.numpy()), jax.random.PRNGKey(0))
    assert np.asarray(jq).shape == tuple(q.shape)
