"""Parity of the port's plain reduce versions (K4 ``topk_cr_reduce_plain``,
K5 ``onebit_cr_reduce_plain``) with the JAX reference.

Each is held to the reference's jnp oracle (``topk_cr_reduce_ref`` /
``onebit_cr_reduce_ref``) and to its Pallas kernel in interpret mode
(``CR.topk_reduce(..., impl="kernel")``), on the reference's own test
shapes, in f32 and bf16.  Where both sides add the same products in the
same order (unique indices within a message, messages in order) they must
agree bit for bit; otherwise within 1e-6.  The dispatchers
(``ops.topk_reduce`` / ``ops.onebit_reduce``) take the plain version for
a CPU tensor.  Also: duplicates across messages, zero weights (``inf * 0``
is NaN in both), the empty cases, and the property the synchronous
strategies rest on — the reduce of n workers' compact payloads with
weights 1/n equals the mean of the densified payloads.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.scheduler import ef_compress_leaf_compact as jax_compact  # noqa: E402
from repro.kernels.cr_reduce import ops as JCR  # noqa: E402
from repro.kernels.cr_reduce.ref import (onebit_cr_reduce_ref,  # noqa: E402
                                         topk_cr_reduce_ref)

from repro_torch.core.scheduler import ef_compress_leaf_compact  # noqa: E402
from repro_torch.kernels.cr_reduce import ops as CR  # noqa: E402
from repro_torch.kernels.cr_reduce.ref import (onebit_cr_reduce_plain,  # noqa: E402
                                               topk_cr_reduce_plain)

TOL = 1e-6


def _topk_panel(rng, s, m, r, k, dtype, shared=False):
    """vals (S, M, k), idx unique within each row of a message (shared:
    every message carries the same indices), weights in [0, 1.5)."""
    vals = rng.standard_normal((s, m, k)).astype(np.float32)
    rows = np.stack([rng.choice(r, size=k, replace=False).astype(np.int32)
                     for _ in range(m)])
    idx = (np.broadcast_to(rows, (s, m, k)).copy() if shared else np.stack([
        np.stack([rng.choice(r, size=k, replace=False).astype(np.int32)
                  for _ in range(m)]) for _ in range(s)]))
    w = rng.uniform(0.0, 1.5, size=(s,)).astype(np.float32)
    if dtype == "bfloat16":
        vals = np.array(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    return vals, idx, w


def _to_torch(vals, idx, w, dtype):
    return (torch.from_numpy(vals).to(getattr(torch, dtype)),
            torch.from_numpy(idx), torch.from_numpy(w))


def _to_jax(vals, idx, w, dtype):
    return (jnp.asarray(vals).astype(getattr(jnp, dtype)), jnp.asarray(idx),
            jnp.asarray(w))


# the reference's shapes (tests/test_cr_reduce.py): aligned; ragged R with
# k not a divisor; prime R with k = 1; k == R
TOPK_SHAPES = [(1, 8, 128, 16), (3, 16, 100, 7), (5, 8, 257, 1),
               (2, 24, 64, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,m,r,k", TOPK_SHAPES)
def test_topk_plain_matches_reference(s, m, r, k, dtype):
    rng = np.random.default_rng(s * 1000 + r)
    vals, idx, w = _topk_panel(rng, s, m, r, k, dtype)
    got = topk_cr_reduce_plain(*_to_torch(vals, idx, w, dtype), r).numpy()
    jv = _to_jax(vals, idx, w, dtype)
    want = np.asarray(topk_cr_reduce_ref(*jv, r))
    kern = np.asarray(JCR.topk_reduce(*jv, r, impl="kernel"))
    assert got.dtype == np.float32 and got.shape == (m, r)
    # same products, added in message order: bit for bit
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, kern, rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        CR.topk_reduce(*_to_torch(vals, idx, w, dtype), r).numpy(), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_plain_duplicates_across_messages(dtype):
    """Every message carries the same indices: the S adds of a word
    accumulate in message order, as in the reference's scatter."""
    rng = np.random.default_rng(7)
    vals, idx, w = _topk_panel(rng, 4, 8, 96, 24, dtype, shared=True)
    got = topk_cr_reduce_plain(*_to_torch(vals, idx, w, dtype), 96).numpy()
    jv = _to_jax(vals, idx, w, dtype)
    np.testing.assert_array_equal(got, np.asarray(topk_cr_reduce_ref(*jv,
                                                                     96)))
    np.testing.assert_allclose(
        got, np.asarray(JCR.topk_reduce(*jv, 96, impl="kernel")), rtol=0,
        atol=TOL)


def test_topk_plain_duplicates_within_a_message():
    """Duplicate indices inside one message also accumulate (the sum's
    order is then free on the card, so 1e-6 here)."""
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((2, 8, 12)).astype(np.float32)
    idx = rng.integers(0, 5, (2, 8, 12)).astype(np.int32)
    w = np.array([0.5, 1.25], np.float32)
    got = topk_cr_reduce_plain(*_to_torch(vals, idx, w, "float32"), 5)
    want = np.asarray(topk_cr_reduce_ref(*_to_jax(vals, idx, w, "float32"),
                                         5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_topk_plain_zero_weight_is_not_skipped():
    """A zero weight adds zeros; a message holding inf with weight 0 adds
    NaN there, as the reference does."""
    rng = np.random.default_rng(9)
    vals, idx, w = _topk_panel(rng, 3, 8, 64, 8, "float32")
    w[1] = 0.0
    vals[2, 3, 5] = np.inf
    w[2] = 0.0
    got = topk_cr_reduce_plain(*_to_torch(vals, idx, w, "float32"),
                               64).numpy()
    jv = _to_jax(vals, idx, w, "float32")
    want = np.asarray(topk_cr_reduce_ref(*jv, 64))
    np.testing.assert_array_equal(got, want)      # NaN where NaN
    assert np.isnan(got[3, idx[2, 3, 5]]) and np.isnan(got).sum() == 1
    no_msgs = topk_cr_reduce_plain(*_to_torch(vals[:1], idx[:1], w[:1],
                                              "float32"), 64).numpy()
    finite = ~np.isnan(got)
    np.testing.assert_array_equal(got[finite], no_msgs[finite])


@pytest.mark.parametrize("s,m,r,k", [(0, 4, 16, 3), (2, 0, 16, 3),
                                     (2, 4, 0, 0), (2, 4, 16, 0)])
def test_topk_plain_empty_cases_give_zeros(s, m, r, k):
    vals = torch.zeros((s, m, k), dtype=torch.bfloat16)
    idx = torch.zeros((s, m, k), dtype=torch.int32)
    w = torch.ones((s,))
    got = topk_cr_reduce_plain(vals, idx, w, r)
    want = np.asarray(topk_cr_reduce_ref(jnp.zeros((s, m, k)),
                                         jnp.zeros((s, m, k), jnp.int32),
                                         jnp.ones((s,)), r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, r)
    np.testing.assert_array_equal(got.numpy(), want)


ONEBIT_SHAPES = [(1, 8, 128), (3, 16, 100), (4, 8, 257), (2, 32, 33)]


def _onebit_panel(rng, s, m, r):
    pos = rng.random((s, m, r)) > 0.5
    means = rng.standard_normal((s, m, 2)).astype(np.float32)
    w = rng.uniform(0.0, 1.5, size=(s,)).astype(np.float32)
    return pos, means, w


@pytest.mark.parametrize("s,m,r", ONEBIT_SHAPES)
def test_onebit_plain_matches_reference(s, m, r):
    rng = np.random.default_rng(s * 7 + r)
    pos, means, w = _onebit_panel(rng, s, m, r)
    tpos, tmeans, tw = (torch.from_numpy(x) for x in (pos, means, w))
    got = onebit_cr_reduce_plain(tpos, tmeans, tw).numpy()
    jargs = (jnp.asarray(pos), jnp.asarray(means), jnp.asarray(w))
    want = np.asarray(onebit_cr_reduce_ref(*jargs, r))
    kern = np.asarray(JCR.onebit_reduce(*jargs, impl="kernel"))
    assert got.dtype == np.float32 and got.shape == (m, r)
    # XLA may contract the reference's q * w + acc into one FMA: 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, kern, rtol=0, atol=TOL)
    np.testing.assert_array_equal(CR.onebit_reduce(tpos, tmeans, tw).numpy(),
                                  got)


def test_onebit_plain_zero_weight_and_inf():
    rng = np.random.default_rng(11)
    pos, means, w = _onebit_panel(rng, 3, 8, 40)
    w[0] = 0.0
    means[2, 5, 0] = np.inf
    w[2] = 0.0
    got = onebit_cr_reduce_plain(*(torch.from_numpy(x)
                                   for x in (pos, means, w))).numpy()
    want = np.asarray(onebit_cr_reduce_ref(jnp.asarray(pos),
                                           jnp.asarray(means),
                                           jnp.asarray(w), 40))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)   # NaN == NaN
    assert np.isnan(got[5][pos[2, 5]]).all()
    assert np.isnan(got).sum() == pos[2, 5].sum()


@pytest.mark.parametrize("s,m,r", [(0, 4, 16), (2, 0, 16), (2, 4, 0)])
def test_onebit_plain_empty_cases_give_zeros(s, m, r):
    got = onebit_cr_reduce_plain(torch.zeros((s, m, r), dtype=torch.bool),
                                 torch.zeros((s, m, 2)), torch.ones((s,)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, r)
    assert not got.any()


def _densify_topk(vals, idx, r):
    m = vals.shape[0]
    out = np.zeros((m, r), np.float32)
    np.add.at(out, (np.arange(m)[:, None], idx), vals)
    return out


@pytest.mark.parametrize("method", ["topk", "onebit"])
@pytest.mark.parametrize("n,m,r,seed", [(1, 3, 17, 0), (3, 4, 40, 1),
                                        (5, 6, 33, 2)])
def test_reduce_with_weights_1_over_n_is_the_mean(method, n, m, r, seed):
    """n workers' rows compressed to the compact wire form (as the
    reference's property test does), reduced with weights 1/n: the mean
    of the densified payloads; and the same as the reference's reduce of
    its own payloads."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, m, r)).astype(np.float32)
    spec = P("model", None)
    payloads = [ef_compress_leaf_compact(torch.from_numpy(rows[i]), None,
                                         spec, method, 1 / 4)[0]
                for i in range(n)]
    jpay = [jax_compact(jnp.asarray(rows[i]), jnp.zeros((m, r)), spec,
                        method, 1 / 4)[0] for i in range(n)]
    w = torch.full((n,), 1.0 / n)
    jw = jnp.full((n,), 1.0 / n)
    if method == "topk":
        fused = CR.topk_reduce(torch.stack([p["vals"] for p in payloads]),
                               torch.stack([p["idx"] for p in payloads]),
                               w, r)
        dense = np.mean([_densify_topk(p["vals"].numpy(), p["idx"].numpy(),
                                       r) for p in payloads], axis=0)
        ref = JCR.topk_reduce(jnp.stack([p["vals"] for p in jpay]),
                              jnp.stack([p["idx"] for p in jpay]), jw, r)
    else:
        fused = CR.onebit_reduce(torch.stack([p["pos"] for p in payloads]),
                                 torch.stack([p["means"] for p in payloads]),
                                 w)
        dense = np.mean([np.where(p["pos"].numpy(),
                                  p["means"].numpy()[:, 0:1],
                                  p["means"].numpy()[:, 1:2])
                         for p in payloads], axis=0)
        ref = JCR.onebit_reduce(jnp.stack([p["pos"] for p in jpay]),
                                jnp.stack([p["means"] for p in jpay]), jw)
    np.testing.assert_allclose(fused.numpy(), dense, rtol=1e-6, atol=TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=TOL)
