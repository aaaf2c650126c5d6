"""The port's kernel modules against the JAX reference.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the reference's ``ref.py`` oracles and its Pallas kernels in
interpret mode, on the same numpy inputs:

* topk_ef: the densified Q and the residual bitwise, the index sets equal
  (the order of the picks inside a row is free);
* the deposits: ``rtol=1e-6`` — the order in which JAX adds messages that
  share an element is unspecified, the port's is message order.

``tests/test_torch_kernels_cuda.py`` holds the CUDA/Triton kernels
against these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import scheduler as JS  # noqa: E402
from repro.kernels.cr_reduce import kernel as JCRK  # noqa: E402
from repro.kernels.cr_reduce import ops as JCR  # noqa: E402
from repro.kernels.cr_reduce import ref as JCRR  # noqa: E402
from repro.kernels.topk_ef.kernel import topk_ef as jax_topk_ef  # noqa: E402
from repro.kernels.topk_ef.ref import topk_ef_ref  # noqa: E402

from repro_torch.core import scheduler as S  # noqa: E402
from repro_torch.kernels.cr_reduce import ops as CR  # noqa: E402
from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,  # noqa: E402
                                                  topk_cr_deposit)
from repro_torch.kernels.cr_reduce.ref import (  # noqa: E402
    onebit_cr_deposit_plain, topk_cr_deposit_plain)
from repro_torch.kernels.topk_ef import ops as TK  # noqa: E402
from repro_torch.kernels.topk_ef.kernel import topk_ef  # noqa: E402
from repro_torch.kernels.topk_ef.ref import q_dense, topk_ef_plain  # noqa: E402


def _rows(shape, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct magnitudes, both signs and zeros: many ties at the
        # threshold, which the lowest index must win
        g = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=shape)
        e = rng.choice([0.0, 0.5, -0.5], size=shape)
        return g.astype(np.float32), e.astype(np.float32)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.1 * rng.standard_normal(shape)).astype(np.float32))


def _q_np(vals, idx, r):
    q = np.zeros((vals.shape[0], r), np.float32)
    np.add.at(q, (np.arange(vals.shape[0])[:, None], idx), vals)
    return q


TOPK_CASES = [((8, 256), 32, False), ((8, 1000), 125, True),
              ((1, 4096), 256, False)]


@pytest.mark.parametrize("shape,k,ties", TOPK_CASES)
@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_topk_ef_plain_matches_reference(shape, k, ties, oracle):
    g, e = _rows(shape, seed=shape[1], ties=ties)
    if oracle == "ref":
        jv, ji, je = topk_ef_ref(jnp.asarray(g), jnp.asarray(e), k=k)
    else:
        jv, ji, je = jax_topk_ef(jnp.asarray(g), jnp.asarray(e), k=k,
                                 interpret=True)
    jv, ji, je = map(np.asarray, (jv, ji, je))
    tv, ti, te = topk_ef_plain(torch.from_numpy(g), torch.from_numpy(e), k)
    assert ti.dtype == torch.int32 and tuple(tv.shape) == (shape[0], k)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(ji, 1))
    np.testing.assert_array_equal(
        q_dense(tv, ti, shape[1]).numpy().view(np.uint32),
        _q_np(jv, ji, shape[1]).view(np.uint32))
    np.testing.assert_array_equal(te.numpy().view(np.uint32),
                                  je.view(np.uint32))


def test_topk_ef_plain_ties_lowest_index_wins():
    g = torch.tensor([[1.0, -3.0, 3.0, 2.0, -3.0, 3.0]])
    vals, idx, new_err = topk_ef_plain(g, None, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[-3.0, 3.0, -3.0]]
    assert new_err.tolist() == [[1.0, 0.0, 0.0, 2.0, 0.0, 3.0]]


def test_topk_compress_rows_in_place_residual():
    g, e = _rows((1, 512), seed=3)
    err = torch.from_numpy(e.copy())
    v0, i0, e0 = TK.compress_rows(torch.from_numpy(g), err.clone(), 1 / 8)
    v1, i1, e1 = TK.compress_rows(torch.from_numpy(g), err, 1 / 8,
                                  out_err=err)
    assert e1.data_ptr() == err.data_ptr()
    assert torch.equal(e0, err) and torch.equal(v0, v1) and torch.equal(i0, i1)


def _deposit_inputs(m=8, r=64, k=8, seed=0):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((3, m, r)).astype(np.float32)
    vals = rng.standard_normal((3, m, k)).astype(np.float32)
    # unique per-row indices, as top-k produces
    idx = np.stack([np.stack([rng.permutation(r)[:k] for _ in range(m)])
                    for _ in range(3)]).astype(np.int32)
    pos = rng.random((3, m, r)) < 0.5
    means = rng.standard_normal((3, m, 2)).astype(np.float32)
    slots = np.array([1, 1, 2], np.int32)        # two messages share slot 1
    weights = np.array([1.0, 0.5, 0.0], np.float32)  # the last is DROPPED
    return acc, vals, idx, pos, means, slots, weights


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_topk_deposit_plain_matches_reference(oracle):
    acc, vals, idx, _, _, slots, w = _deposit_inputs()
    args = tuple(map(jnp.asarray, (acc, vals, idx, slots, w)))
    if oracle == "ref":
        want = JCRR.topk_cr_deposit_ref(*args)
    else:
        want = JCRK.topk_cr_deposit(*args, interpret=True)
    got = topk_cr_deposit_plain(*map(torch.from_numpy,
                                     (acc.copy(), vals, idx, slots, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_onebit_deposit_plain_matches_reference(oracle):
    acc, _, _, pos, means, slots, w = _deposit_inputs()
    args = tuple(map(jnp.asarray, (acc, pos, means, slots, w)))
    if oracle == "ref":
        want = JCRR.onebit_cr_deposit_ref(*args)
    else:
        want = JCRK.onebit_cr_deposit(*args, interpret=True)
    got = onebit_cr_deposit_plain(*map(torch.from_numpy,
                                       (acc.copy(), pos, means, slots, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_deposit_dispatch_is_in_place_on_cpu():
    acc, vals, idx, pos, means, slots, w = _deposit_inputs(m=1, r=40, k=4)
    t_acc = torch.from_numpy(acc.copy())
    out = CR.topk_deposit(t_acc, *map(torch.from_numpy,
                                      (vals, idx, slots, w)))
    assert out is t_acc
    out = CR.onebit_deposit(t_acc, *map(torch.from_numpy,
                                        (pos, means, slots, w)))
    assert out is t_acc


def test_onebit_compress_rows_matches_reference():
    g, e = _rows((4, 300), seed=5)
    jp, jm, je = JCR.onebit_compress_rows(jnp.asarray(g), jnp.asarray(e))
    tp, tm, te = CR.onebit_compress_rows(torch.from_numpy(g),
                                         torch.from_numpy(e))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    # the means are sums in another order (1 ulp apart), and w - mean
    # cancels: compare the residual at the means' absolute rounding
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)


LEAF_SPECS = [((3, 16, 40), (None, None, None)),
              ((2, 8, 12), (None, "model", None))]


@pytest.mark.parametrize("shape,spec", LEAF_SPECS)
@pytest.mark.parametrize("method", ["topk", "onebit"])
def test_compact_densified_equals_dense_compress_bitwise(shape, spec,
                                                         method):
    """Inside the port: the compact wire payload, densified, and its
    residual are ef_compress_leaf's bit for bit (what makes the fused and
    densified engines agree)."""
    g, e = _rows(shape, seed=7)
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    dense_q, dense_err = S.ef_compress_leaf(tg, te.clone(), spec, method,
                                            1 / 8)
    err = te.clone()
    payload, new_err = S.ef_compress_leaf_compact(tg, err, spec, method,
                                                  1 / 8)
    m, r, perm, tshape = S.leaf_rows_geometry(shape, spec)
    if method == "topk":
        q_rows = q_dense(payload["vals"], payload["idx"], r)
    else:
        q_rows = torch.where(payload["pos"], payload["means"][:, 0:1],
                             payload["means"][:, 1:2])
    q = S._from_rows(q_rows, perm, tshape)
    assert torch.equal(q, dense_q) and torch.equal(new_err, dense_err)
    assert new_err is err  # the residual is written into the given err


@pytest.mark.parametrize("shape,spec", LEAF_SPECS)
def test_rows_geometry_matches_reference(shape, spec):
    from jax.sharding import PartitionSpec as P
    assert S.leaf_rows_geometry(shape, spec)[:2] == \
        JS.leaf_rows_geometry(shape, P(*spec))[:2]
    g, _ = _rows(shape, seed=1)
    rows, perm, tshape = S._to_rows(torch.from_numpy(g), spec)
    jrows, jperm, jtshape = JS._to_rows(jnp.asarray(g), P(*spec))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert list(perm) == list(jperm) and tuple(tshape) == tuple(jtshape)
    back = S._from_rows(rows, perm, tshape)
    assert torch.equal(back, torch.from_numpy(g))


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros((1, 8))
    with pytest.raises(ValueError):
        topk_ef(z, None, 2)
    acc = torch.zeros((2, 1, 8))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        topk_cr_deposit(acc, torch.zeros((1, 1, 2)),
                        torch.zeros((1, 1, 2), dtype=torch.int32), one,
                        torch.ones(1))
    with pytest.raises(ValueError):
        onebit_cr_deposit(acc, torch.zeros((1, 1, 8), dtype=torch.bool),
                          torch.zeros((1, 1, 2)), one, torch.ones(1))
