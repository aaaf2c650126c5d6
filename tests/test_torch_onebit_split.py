"""The layout of the CUDA K8 kernel (``onebit_ef``) on the CPU.

``csrc/onebit_ef.cu`` reads each row once.  A thread owns units of 8
consecutive entries (one byte of the sign map each), sums each unit's +
and - entries as a tree and adds the trees in unit order into per-thread
sums and a count; a warp adds its lanes by a fixed ``__shfl_xor_sync``
butterfly (offsets 16, 8, 4, 2, 1).  On the warp route (R up to
``WARP_ROW_MAX``) lane l of a row's warp holds units l, l + 32, ...; on
the cluster route a cluster of C CTAs holds a row, unit ``k C T U + c T U
+ j T + t`` going to thread t of CTA c in pass k, slot j, each CTA adds
its warps in warp order and every CTA adds the C partials in rank order.
``plan`` (the wrapper's) picks the route, C, T, U and the passes from the
shape.

The torch mirror below repeats that order and is held against the JAX
package's ``onebit_ef_ref`` and its Pallas kernel in interpret mode, the
reference's ``onebit_compress`` / ``onebit_q`` at R % 8 != 0, and the
port's ``onebit_ef_plain`` at each route's edge: the sign map bit for bit,
the means and the residual within ``TOL`` (1e-6, the limit
``tests/test_torch_sim_kernels.py`` states: the row sums run in another
order in each).  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.kernels.onebit_ef.kernel import onebit_ef as jax_onebit_ef  # noqa: E402
from repro.kernels.onebit_ef.ref import onebit_ef_ref  # noqa: E402

from repro_torch.kernels.onebit_ef import kernel as K  # noqa: E402
from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SOURCE = Path(K.__file__).resolve().parent / "csrc" / "onebit_ef.cu"


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def _layout(m, r):
    """-> (units (threads, steps) in each thread's order, CTAs a row, warps
    a CTA) for the kernel's plan of an (m, r) call."""
    route, c, t_, u, passes = K.plan(m, r)
    if route == "warp":
        lane = torch.arange(32)
        return torch.arange(u)[None, :] * 32 + lane[:, None], 1, 1
    k = torch.arange(passes)[:, None]
    j = torch.arange(u)[None, :]
    step = (k * c * t_ * u + j * t_).reshape(-1)           # (k, j) order
    thread = (torch.arange(c)[:, None] * t_ * u
              + torch.arange(t_)[None, :]).reshape(-1)    # CTA-major
    return thread[:, None] + step[None, :], c, t_ // 32


def _in_order(x):
    """x (..., n) -> x[..., 0] + x[..., 1] + ... added left to right."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def mirror(g, e):
    """g, e (M, R) f32 -> (packed, means, new_err) in the kernel's order."""
    m, r = g.shape
    nb = -(-r // 8)
    w = e + g
    wu = torch.nn.functional.pad(w, (0, nb * 8 - r)).reshape(m, nb, 8)
    live = (torch.arange(nb * 8) < r).reshape(nb, 8)
    units, ctas, warps = _layout(m, r)
    held = units < nb
    units = units.clamp(max=nb - 1)
    # each unit's + and - entries as a tree, ((0 + 1) + (2 + 3)) + ((4 + 5)
    # + (6 + 7)), with 0 for an entry of the other class or past R
    pos = (wu >= 0.0) & live
    neg = ~(wu >= 0.0) & live
    zero = torch.zeros(())
    tree = lambda v: ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])) + \
        ((v[..., 4] + v[..., 5]) + (v[..., 6] + v[..., 7]))
    t_pos = tree(torch.where(pos, wu, zero))            # (M, nb)
    t_neg = tree(torch.where(neg, wu, zero))
    t_n = pos.sum(-1)
    threads = units.shape[0]
    s_pos = torch.zeros((m, threads))
    s_neg = torch.zeros((m, threads))
    n = torch.zeros((m, threads), dtype=torch.int64)
    for step in range(units.shape[1]):                  # in unit order
        u, ok = units[:, step], held[:, step]
        s_pos = torch.where(ok, s_pos + t_pos[:, u], s_pos)
        s_neg = torch.where(ok, s_neg + t_neg[:, u], s_neg)
        n = n + torch.where(ok, t_n[:, u], 0)
    sums = []
    for s in (s_pos, s_neg, n):
        s = s.reshape(m, ctas, warps, 32)
        for o in (16, 8, 4, 2, 1):
            s = s + s[..., torch.arange(32) ^ o]          # the butterfly
        sums.append(_in_order(_in_order(s[..., 0])))      # warps, then CTAs
    tp, tn, cnt = sums
    mp = tp / torch.clamp(cnt, min=1).float()
    mn = tn / torch.clamp(r - cnt, min=1).float()
    weights = 2 ** torch.arange(8)
    packed = (pos.long() * weights).sum(-1).to(torch.uint8)
    q = torch.where(w >= 0.0, mp[:, None], mn[:, None])
    return packed, torch.stack([mp, mn], dim=1), w - q


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _rows(m, r, seed, special=False):
    """g, err (m, r) f32: Gaussian rows; the last row all zero; with
    ``special`` also a row of -0.0 entries beside +0.0 and Gaussian ones
    (-0.0 is in the + class) and a row with one NaN (in the - class)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, r)).astype(np.float32)
    e = (0.1 * rng.standard_normal((m, r))).astype(np.float32)
    if special:
        g[0, ::3] = -0.0
        e[0, ::3] = -0.0
        g[0, 1::3] = 0.0
        e[0, 1::3] = -0.0
        g[1, r // 2] = np.nan
    g[-1] = 0.0
    e[-1] = 0.0
    return g, e


def _check(got, want_packed, want_means, want_err):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_packed))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_means), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want_err), **TOL)


# ---------------------------------------------------------------------------
# the mirror against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("m,r", [(8, 32), (16, 512), (8, 1024)])
def test_mirror_matches_jax_reference(m, r, oracle):
    g, e = _rows(m, r, seed=r)
    fn = onebit_ef_ref if oracle == "ref" else \
        (lambda a, b: jax_onebit_ef(a, b, interpret=True))
    want = fn(jnp.asarray(g), jnp.asarray(e))
    _check(mirror(torch.from_numpy(g), torch.from_numpy(e)), *want)


@pytest.mark.parametrize("r", [32, 1024])
def test_mirror_special_rows_match_jax_reference(r):
    """All-zero, -0.0 and NaN rows against ``onebit_ef_ref``: the NaN
    row's - mean and its - entries' residuals are NaN in both."""
    g, e = _rows(4, r, seed=r + 1, special=True)
    want = onebit_ef_ref(jnp.asarray(g), jnp.asarray(e))
    got = mirror(torch.from_numpy(g), torch.from_numpy(e))
    _check(got, *want)
    assert bool(torch.isnan(got[1][1, 1])) and not bool(
        torch.isnan(got[1][1, 0]))


@pytest.mark.parametrize("r", [1, 7, 100, 1001])
def test_mirror_any_row_length_matches_reference(r):
    """R % 8 != 0, which the Pallas kernel does not take: each row against
    the reference's wire format (``onebit_compress``, zero pad bits) and
    its dense ``onebit_q``."""
    g, e = _rows(3, r, seed=r)
    got = mirror(torch.from_numpy(g), torch.from_numpy(e))
    assert tuple(got[0].shape) == (3, (r + 7) // 8)
    w = e + g
    for i in range(3):
        packed, mp, mn = JC.onebit_compress(jnp.asarray(w[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(packed))
        np.testing.assert_allclose(got[1][i].numpy(), [float(mp), float(mn)],
                                   **TOL)
        q = np.asarray(JC.onebit_q(jnp.asarray(w[i])))
        np.testing.assert_allclose(got[2][i].numpy(), w[i] - q, **TOL)


EDGES = [(4, K.WARP_ROW_MAX, ("warp", 0, 32, 8, 1)),
         (4, K.WARP_ROW_MAX + 1, ("cluster", 8, 64, 1, 1)),
         (4, K.CLUSTER_CAPACITY, ("cluster", 8, 256, 8, 1)),
         (4, K.CLUSTER_CAPACITY + 1, ("cluster", 8, 256, 8, 2))]


@pytest.mark.parametrize("m,r,want_plan", EDGES)
def test_mirror_matches_plain_at_route_edges(m, r, want_plan):
    """Each route's last and first row length: the warp route's longest
    row, the first cluster row, the longest a cluster holds in registers
    and the first that loops over passes; with all-zero, -0.0 and NaN
    rows."""
    assert K.plan(m, r) == want_plan
    g, e = _rows(m, r, seed=r, special=True)
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    got = mirror(tg, te)
    want = onebit_ef_plain(tg, te)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], equal_nan=True, **TOL)
    torch.testing.assert_close(got[2], want[2], equal_nan=True, **TOL)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,r,want", [
    (8, 32, ("warp", 0, 32, 1, 1)), (16, 512, ("warp", 0, 32, 2, 1)),
    (256, 256, ("warp", 0, 32, 1, 1)), (8, 100, ("warp", 0, 32, 1, 1)),
    (1024, 256, ("warp", 0, 128, 1, 1)),
    (32, 4096, ("cluster", 1, 256, 2, 1)),
    (8, 4096, ("cluster", 8, 64, 1, 1)),
    (1, 65536, ("cluster", 8, 256, 4, 1)),
    (32, 1 << 20, ("cluster", 4, 256, 8, 16)),
    (1, 1 << 20, ("cluster", 8, 256, 8, 8)),
    (200, 50000, ("cluster", 1, 256, 8, 4))])
def test_plan_at_the_paths_shapes(m, r, want):
    assert K.plan(m, r) == want


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 4096), r=st.integers(1, 1 << 24))
def test_plan_covers_every_row(m, r):
    """The units a row's threads hold cover it; a cluster grows only while
    its CTAs fit one an SM and either the rows are few or its threads would
    hold more than two units each; a row loops only when a thread already
    holds the most units."""
    route, c, t, u, passes = K.plan(m, r)
    nb = -(-r // 8)
    assert u in (1, 2, 4, 8)
    if route == "warp":
        assert r <= K.WARP_ROW_MAX and c == 0 and passes == 1
        assert u * 32 >= nb and (u == 1 or u * 16 < nb)
        assert t in (32, 64, 128, 256) and (t == 32 or -(-m // t) * 32 >= 132)
        return
    assert r > K.WARP_ROW_MAX and c in (1, 2, 4, 8) and t in (64, 128, 256)
    # the library's instantiations: one CTA a row has the most threads, a
    # CTA of fewer holds one unit a thread
    assert (t == K.CLUSTER_THREADS_MAX) or (c > 1 and u == 1)
    assert c * m <= K.SMS or c == 1
    held = c * t * u
    assert held * passes >= nb > held * (passes - 1)
    assert passes == 1 or (u == K.CLUSTER_UNITS_MAX
                           and t == K.CLUSTER_THREADS_MAX)
    if c < K.CLUSTER_MAX and 2 * c * m <= K.SMS:
        assert 8 * m > K.SMS and nb <= 2 * c * K.CLUSTER_THREADS_MAX


def test_source_constants_match_the_wrapper():
    """The wrapper's copy of the layout constants is the source's (the
    library checks it again when it loads, on the card)."""
    text = SOURCE.read_text()
    got = {name: int(v) for name, v in
           re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert got["WARP_ROW_MAX"] == K.WARP_ROW_MAX
    assert got["ROWS_PER_BLOCK_MAX"] == K.ROWS_PER_BLOCK_MAX
    assert got["CL_T_MIN"] == K.CLUSTER_THREADS_MIN
    assert got["CL_T_MAX"] == K.CLUSTER_THREADS_MAX
    assert got["CL_UNITS_MAX"] == K.CLUSTER_UNITS_MAX
    assert got["CL_MAX"] == K.CLUSTER_MAX
