"""The arithmetic of K9's split kernel (``csrc/swa_decode.cu``) on the CPU.

The CUDA kernel reads only each row's live keys: an interval [lo, hi) of
its T keys (``ref.py::live_span``), cut into ``nsplit`` pieces of
``ref.py::split_len`` keys.  Each piece leaves (m, l, acc): the max score,
the sum of exp(s - m) and the sum of exp(s - m) v.  A piece with no key
leaves (-1e30, 0, 0); a row with no live key spreads all T keys over the
pieces and leaves (-1e30, n, sum v), so that the merge gives the mean of
its values.  The merge adds the pieces in order, each weighted by
exp(m - max m).

``_split_merge`` below mirrors that arithmetic in f32 torch.  It is held to
the port's plain version and to the JAX package's ``swa_decode_ref``,
atol 3e-6 (the bound of ``tests/test_kernels.py``: the two sum in other
orders), and ``live_span`` to the plain version's mask under
``hypothesis``.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention.ref import swa_decode_ref  # noqa: E402

from repro_torch.kernels.swa_attention.kernel import (  # noqa: E402
    SC_FLOATS, TARGET_BLOCKS, num_splits)
from repro_torch.kernels.swa_attention.ref import (  # noqa: E402
    NEG_INF, live_span, split_len, swa_decode_plain)

F32_TOL = 3e-6

jax_swa_ref = jax.jit(swa_decode_ref, static_argnames=("window",))


def _pieces(pos, base, t, window, nsplit):
    """-> (live, [(t0, t1), ...]): the kernel's keys of each split."""
    lo, hi = live_span(pos, base, t, window)
    live = hi > lo
    start, n = (lo, hi - lo) if live else (0, t)
    slen = split_len(n, nsplit)
    out = []
    for sp in range(nsplit):
        t0 = start + sp * slen
        out.append((t0, max(t0, min(start + n, t0 + slen))))
    return live, out


def _split_merge(q, k, v, pos, base, window, nsplit):
    """The kernel's split / skip / merge arithmetic, in f32."""
    b, nkv, g, d = q.shape
    t = k.shape[1]
    scale = d ** -0.5
    out = torch.empty((b, nkv, g, d), dtype=torch.float32)
    for row in range(b):
        live, pieces = _pieces(int(pos[row]), int(base[row]), t, window,
                               nsplit)
        for h in range(nkv):
            parts = []
            for t0, t1 in pieces:
                kk = k[row, t0:t1, h].float()
                vv = v[row, t0:t1, h].float()
                if t1 == t0:
                    m = torch.full((g,), NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros((g, d))
                elif live:
                    s = (q[row, h].float() @ kk.T) * scale
                    m = s.max(1).values
                    p = torch.exp(s - m[:, None])
                    l = p.sum(1)
                    acc = p @ vv
                else:
                    m = torch.full((g,), NEG_INF)
                    l = torch.full((g,), float(t1 - t0))
                    acc = vv.sum(0)[None].expand(g, d)
                parts.append((m, l, acc))
            mm = torch.stack([p[0] for p in parts]).max(0).values
            big_l = torch.zeros(g)
            big_a = torch.zeros((g, d))
            for m, l, acc in parts:
                w = torch.exp(m - mm)
                big_l = big_l + l * w
                big_a = big_a + acc * w[:, None]
            out[row, h] = big_a / torch.clamp(big_l, min=1e-30)[:, None]
    return out


def _inputs(b, kv, g, d, t, pos, base, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    return q, k, v, np.array(pos, np.int32), np.array(base, np.int32)


SPLIT_CASES = [  # (B, KV, G, D, T, window, nsplit, pos, base)
    # the path's rows, narrow: a full window that slid, most keys beyond
    # the query, no live key
    (4, 2, 4, 32, 300, 256, 16, [299, 449, 40, 100], [0, 150, 3, 500]),
    # phase 15's rows: about 503 live keys of 4112
    (4, 1, 2, 16, 4112, 4096, 16, [502, 503, 501, 500], [0, 0, 0, 0]),
    # a window shorter than one split (16 keys)
    (2, 2, 8, 16, 200, 5, 4, [150, 3], [0, 0]),
    # T not a multiple of the tile; window 0; more splits than keys
    (3, 1, 16, 8, 77, 0, 40, [76, 10, 0], [0, 5, 0]),
    (2, 1, 1, 64, 1000, 0, 1, [999, 300], [0, 0]),
    # pos beyond T, pos below base
    (2, 2, 2, 16, 130, 64, 8, [5000, 2], [0, 9]),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_merge_matches_plain_and_reference(case):
    b, kv, g, d, t, window, nsplit, pos, base = case
    q, k, v, pos, base = _inputs(b, kv, g, d, t, pos, base, seed=t + g)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _split_merge(tq, tk, tv, pos, base, window, nsplit)
    plain = swa_decode_plain(tq, tk, tv, torch.from_numpy(pos),
                             torch.from_numpy(base), window=window)
    ref = np.asarray(jax_swa_ref(q, k, v, pos, base, window=window))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    for row in range(b):
        lo, hi = live_span(int(pos[row]), int(base[row]), t, window)
        if hi == lo:                 # no live key: the mean of the values
            mean = tv[row].mean(0)[:, None].expand(kv, g, d)
            np.testing.assert_allclose(got[row].numpy(), mean.numpy(),
                                       rtol=0, atol=F32_TOL)


def test_split_merge_bf16_inputs_match_reference():
    """bf16 caches and query, upcast as the kernel does: within one bf16
    rounding step of the reference's bf16 output."""
    b, kv, g, d, t = 4, 2, 4, 32, 300
    q, k, v, pos, base = _inputs(b, kv, g, d, t, [299, 449, 40, 100],
                                 [0, 150, 3, 500], seed=7)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32)))
             .to(torch.bfloat16) for a in jargs]
    got = _split_merge(*targs, pos, base, 256, 16).to(torch.bfloat16)
    want = np.asarray(jax_swa_ref(*jargs, pos, base, window=256)
                      .astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert (err <= 1e-5 + 2.0 ** -7 * np.abs(want)).all()


@settings(max_examples=300, deadline=None)
@given(pos=st.integers(-40, 400), base=st.integers(-40, 400),
       t=st.integers(1, 300),
       window=st.one_of(st.just(0), st.integers(1, 20),
                        st.integers(1, 500)))
def test_live_span_is_the_plain_mask(pos, base, t, window):
    """pos below base, pos beyond T, window 0, windows shorter than a
    split (16 keys) and T not a multiple of the tile (32 keys).  The mask
    is read off the plain version itself: with q = 0 every live score is
    0, and with V the identity its output is the softmax row, 1/n on the n
    live keys and 0 elsewhere (1/T everywhere when none is live)."""
    lo, hi = live_span(pos, base, t, window)
    assert 0 <= lo <= hi <= t
    eye = torch.eye(t)[None, :, None, :]
    row = swa_decode_plain(torch.zeros((1, 1, 1, t)), torch.zeros_like(eye),
                           eye, pos, base, window=window)[0, 0, 0].numpy()
    idx = np.arange(t)
    live = (idx >= lo) & (idx < hi)
    want = live / (hi - lo) if hi > lo else np.full(t, 1.0 / t)
    np.testing.assert_allclose(row, want, rtol=1e-6, atol=0)


@settings(max_examples=300, deadline=None)
@given(pos=st.integers(-40, 5000), base=st.integers(-40, 400),
       t=st.integers(1, 5000), window=st.integers(0, 5000),
       nsplit=st.integers(1, 600))
def test_pieces_cover_the_live_keys_once(pos, base, t, window, nsplit):
    """The splits' pieces are disjoint, in order, at most one split's
    length each, and together the live keys (all T keys for a row with no
    live key)."""
    live, pieces = _pieces(pos, base, t, window, nsplit)
    lo, hi = live_span(pos, base, t, window)
    want = range(lo, hi) if live else range(t)
    got = [i for t0, t1 in pieces for i in range(t0, t1)]
    assert got == list(want)
    slen = split_len(len(want), nsplit)
    assert all(t1 - t0 <= slen and slen % 16 == 0 for t0, t1 in pieces)


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 4, 4112, 4096), 8),       # the serving path: 256 blocks
    ((4, 8, 4, 128, 4096), 4),        # short rows: 32 keys a split
    ((1, 1, 16, 100000, 0), 256),     # a long row: scores fit
    ((2, 2, 2, 64, 0), 2),
])
def test_num_splits(shape, want):
    b, kv, g, t, window = shape
    n = num_splits(b, kv, g, t, window)
    assert n == want
    assert 1 <= n <= t
    live_max = min(t, window) if window > 0 else t
    assert split_len(live_max, n) * g <= SC_FLOATS
    assert b * kv * n <= max(TARGET_BLOCKS, b * kv)
