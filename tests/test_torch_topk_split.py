"""The algorithm of K1's four-launch kernel (``csrc/topk_ef.cu``) on the CPU.

The CUDA kernel finds the k-th largest key of each row (the bit pattern of
``|w|``, sign bit cleared) by a radix select over three digits, bits
30..20, 19..9 and 8..0, in four passes:

1. hist: w = err + g, a histogram of digit 0; bin b0 holds the k-th largest
   key.  Whether bin b0 holds more keys than the candidate list takes
   (``candidate_cap``) is known here, exactly;
2. cand: a histogram of digit 1 of the keys in bin b0, and those keys
   compacted into the candidate list (unless they overflow it);
3. digit: a histogram of digit 2 of the candidates sharing the first two
   digits, or of the whole row when bin b0 overflowed the list; this fixes
   T and need, the ties at T to take;
4. place: per chunk of the row, the counts of keys > T and == T; each
   chunk's offsets are the sums over earlier chunks, which the kernel gets
   by a decoupled look-back; the chunk writes every key > T and the first
   ``need`` ties in index order, and zeroes w there.

``_four_passes`` mirrors that in numpy, the chunk size and the list's
capacity being parameters, and ``_look_back`` mirrors the look-back's walk
over 32 earlier chunks at a time.  Both are held bit for bit against the
port's plain version ``topk_ef_plain`` (pick set, Q, residual) and the
documented output order (``documented_order``), and against the JAX
package's ``topk_ef_ref`` and its Pallas kernel in interpret mode.  The
kernel runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topk_ef.kernel import topk_ef as jax_topk_ef  # noqa: E402
from repro.kernels.topk_ef.ref import topk_ef_ref  # noqa: E402

from repro_torch.kernels.topk_ef.kernel import candidate_cap  # noqa: E402
from repro_torch.kernels.topk_ef.ref import (documented_order,  # noqa: E402
                                             q_dense, topk_ef_plain)

CHUNK = 4096                     # place's chunk: 4 float4 x 256 threads
FLAG_AGG, FLAG_SUM = 1, 2


def _select(hist, need):
    """The bin b with S[b] >= need > S[b + 1] (S[b]: keys in bins >= b),
    S[b + 1] and the keys in b."""
    suffix = np.cumsum(hist[::-1])[::-1]
    above = np.append(suffix[1:], 0)
    b = int(np.nonzero((suffix >= need) & (above < need))[0][0])
    return b, int(above[b]), int(hist[b])


def _four_passes(g, e, k, cap, chunk=CHUNK):
    """numpy mirror of the kernel: -> (vals, idx, new_err, routes), routes
    per row "list" or "overflow"."""
    w = (np.zeros_like(g) if e is None else e) + g
    keys = w.view(np.uint32) & np.uint32(0x7fffffff)
    m, r = w.shape
    vals = np.zeros((m, k), np.float32)
    idx = np.zeros((m, k), np.int32)
    new_err = w.copy()
    routes = []
    for row in range(m):
        key = keys[row]
        # hist
        b0, above, in_bin = _select(np.bincount(key >> 20, minlength=2048), k)
        need = k - above
        over = in_bin > cap
        # cand: the list holds bin b0's keys (in any order: only counts
        # are taken from it)
        bin0 = key[(key >> 20) == b0]
        b1, above, _ = _select(
            np.bincount((bin0 >> 9) & 2047, minlength=2048), need)
        need -= above
        prefix = (b0 << 20) | (b1 << 9)
        # digit: over the list, or over the row when the list overflowed
        src = key if over else np.random.default_rng(row).permutation(bin0)
        same = src[(src >> 9) == (prefix >> 9)]
        b2, above, _ = _select(np.bincount(same & 511, minlength=512), need)
        need -= above
        t = prefix | b2
        routes.append("overflow" if over else "list")
        # place: a chunk's picks above T go to one run at the picks above T
        # of all earlier chunks, its ties taken to one run after every pick
        # above T of the row
        n_gt = k - need
        gt, eq = key > t, key == t
        nb = -(-r // chunk)
        counts = np.array([[gt[c * chunk:(c + 1) * chunk].sum(),
                            eq[c * chunk:(c + 1) * chunk].sum()]
                           for c in range(nb)], np.int64)
        before = np.concatenate([[[0, 0]], np.cumsum(counts, 0)[:-1]])
        for c in range(nb):
            lo = c * chunk
            pg, pe = before[c]
            for i in range(lo, min(lo + chunk, r)):
                if gt[i]:
                    vals[row, pg], idx[row, pg] = w[row, i], i
                    new_err[row, i] = 0.0
                    pg += 1
                elif eq[i]:
                    if pe < need:
                        vals[row, n_gt + pe], idx[row, n_gt + pe] = w[row, i], i
                        new_err[row, i] = 0.0
                    pe += 1
    return vals, idx, new_err, routes


def _look_back(flags, payload, cid):
    """The kernel's look-back of chunk ``cid`` over published words: 32
    earlier chunks at a time, lane j reading chunk cid - 1 - j, summing up
    to the nearest lane with a running total (FLAG_SUM) or all 32."""
    before = 0
    j = cid - 1
    while True:
        q = j - np.arange(32)
        f = np.where(q >= 0, flags[np.maximum(q, 0)], FLAG_SUM)
        v = np.where(q >= 0, payload[np.maximum(q, 0)], 0)
        assert (f != 0).all(), "a chunk looked back at an unpublished one"
        sums = np.nonzero(f == FLAG_SUM)[0]
        upto = sums[0] if sums.size else 31
        before += int(v[:upto + 1].sum())
        if sums.size:
            return before
        j -= 32


def _plain(g, e, k):
    tv, ti, te = topk_ef_plain(torch.from_numpy(g),
                               None if e is None else torch.from_numpy(e), k)
    return tv, ti, te


def _assert_matches_plain(g, e, k, got):
    vals, idx, new_err = got[:3]
    r = g.shape[1]
    tv, ti, te = _plain(g, e, k)
    np.testing.assert_array_equal(np.sort(idx, 1), np.sort(ti.numpy(), 1))
    np.testing.assert_array_equal(
        q_dense(torch.from_numpy(vals), torch.from_numpy(idx), r).numpy()
        .view(np.uint32),
        q_dense(tv, ti, r).numpy().view(np.uint32))
    np.testing.assert_array_equal(new_err.view(np.uint32),
                                  te.numpy().view(np.uint32))
    dv, di = documented_order(tv, ti)
    np.testing.assert_array_equal(idx, di.numpy())
    np.testing.assert_array_equal(vals.view(np.uint32),
                                  dv.numpy().view(np.uint32))


def _rows(shape, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        g = rng.standard_normal(shape)
        e = 0.1 * rng.standard_normal(shape)
    else:                        # few magnitudes: many ties at T
        g = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=shape)
        e = rng.choice([0.0, 0.5, -0.5], size=shape)
    return g.astype(np.float32), e.astype(np.float32)


@pytest.mark.parametrize("shape,k,kind,chunk", [
    ((1, 20000), 1250, "gauss", CHUNK), ((1, 20000), 1250, "gauss", 64),
    ((8, 257), 16, "ties", 8), ((8, 32), 8, "ties", CHUNK),
    ((3, 100), 100, "gauss", 16), ((2, 5000), 1, "ties", 256)])
def test_four_passes_match_plain_and_documented_order(shape, k, kind, chunk):
    """The mirror at the kernel's cap and at several chunk sizes: the
    offsets are exact sums, so the chunking never changes the output."""
    g, e = _rows(shape, seed=shape[1] + k, kind=kind)
    got = _four_passes(g, e, k, candidate_cap(shape[1]), chunk)
    _assert_matches_plain(g, e, k, got)


def test_overflow_route_matches_the_list_route():
    """A row whose threshold bin overflows the list (ties) takes the
    second route, one whose bin fits takes the list; same answers."""
    g, e = _rows((2, 3000), seed=3, kind="ties")
    routes = {}
    for cap in (4, candidate_cap(3000)):
        got = _four_passes(g, e, 200, cap, chunk=512)
        _assert_matches_plain(g, e, 200, got)
        routes[cap] = got[3]
    assert routes[4] == ["overflow", "overflow"]
    assert routes[candidate_cap(3000)] == ["list", "list"]


def test_gaussian_threshold_bin_fits_the_list():
    """At the path's ratio 1/16 a Gaussian-like row's threshold bin holds
    about 1.8% of the row (computed: density 2 phi(1.86) times a bin 1/8
    of the threshold wide), well inside ``candidate_cap`` (R / 16)."""
    r = 1 << 21
    g, e = _rows((1, r), seed=5, kind="gauss")
    w = e + g
    key = w.view(np.uint32) & np.uint32(0x7fffffff)
    b0, _, in_bin = _select(np.bincount(key[0] >> 20, minlength=2048),
                            r // 16)
    assert 0.01 < in_bin / r < 0.03
    assert in_bin < candidate_cap(r) == r // 16


@pytest.mark.parametrize("r,want", [(1, 4), (3, 4), (32, 32), (257, 260),
                                    (65536, 65536), (70000, 65536),
                                    (352321536, 22020096)])
def test_candidate_cap(r, want):
    assert candidate_cap(r) == want
    assert candidate_cap(r) % 4 == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_look_back_gives_every_chunk_its_exclusive_sums(seed):
    """Chunks publish their counts in a random order and look back in
    another: each walk ends with the sum over all earlier chunks, whether
    it meets totals (FLAG_SUM) or only counts (FLAG_AGG) on the way."""
    rng = np.random.default_rng(seed)
    nb = 300
    counts = rng.integers(0, 50, nb)
    flags = np.full(nb, FLAG_AGG, np.int64)   # every chunk has counted
    payload = counts.astype(np.int64)
    flags[0] = FLAG_SUM                      # chunk 0 publishes its total
    for cid in rng.permutation(np.arange(1, nb)):
        before = _look_back(flags, payload, int(cid))
        assert before == counts[:cid].sum()
        flags[cid], payload[cid] = FLAG_SUM, before + counts[cid]
    assert (flags == FLAG_SUM).all()


def test_four_passes_match_jax_reference_and_pallas_interpret():
    """One small case against the JAX package's oracle and its Pallas
    kernel in interpret mode (pick sets, Q and the residual bitwise)."""
    g, e = _rows((4, 512), seed=11, kind="ties")
    k = 40
    vals, idx, new_err, _ = _four_passes(g, e, k, candidate_cap(512), 128)
    for jv, ji, je in (topk_ef_ref(jnp.asarray(g), jnp.asarray(e), k=k),
                       jax_topk_ef(jnp.asarray(g), jnp.asarray(e), k=k,
                                   interpret=True)):
        jv, ji, je = map(np.asarray, (jv, ji, je))
        np.testing.assert_array_equal(np.sort(idx, 1), np.sort(ji, 1))
        q = np.zeros_like(g)
        np.add.at(q, (np.arange(4)[:, None], ji), jv)
        np.testing.assert_array_equal(
            q_dense(torch.from_numpy(vals), torch.from_numpy(idx), 512)
            .numpy().view(np.uint32), q.view(np.uint32))
        np.testing.assert_array_equal(new_err.view(np.uint32),
                                      je.view(np.uint32))


_SPECIAL = [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, -2.0, float("inf"),
            -float("inf"), 1e-38, -3e-39, 3.4e38]


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_four_passes_property_short_rows(data):
    """Short rows with ties, all-zero rows, +-0.0, infinities and
    denormals; the list's capacity from 4 (the threshold bin overflows
    it whenever it holds more than 4 keys) to the whole row."""
    m = data.draw(st.integers(1, 3))
    r = data.draw(st.integers(1, 70))
    k = data.draw(st.integers(1, r))
    pool = data.draw(st.sampled_from(["special", "mixed", "zero"]))
    if pool == "zero":
        g = np.zeros((m, r), np.float32)
        g[:, ::2] = -0.0
        e = None
    else:
        vals = st.sampled_from(_SPECIAL) if pool == "special" else \
            st.floats(-4, 4, width=32)
        g = np.array(data.draw(st.lists(vals, min_size=m * r,
                                        max_size=m * r)),
                     np.float32).reshape(m, r)
        e = np.array(data.draw(st.lists(st.sampled_from([0.0, -0.0, 0.5]),
                                        min_size=m * r, max_size=m * r)),
                     np.float32).reshape(m, r)
    cap = data.draw(st.sampled_from([4, 8, candidate_cap(r)]))
    chunk = data.draw(st.sampled_from([4, 16, CHUNK]))
    with np.errstate(invalid="ignore", over="ignore"):
        got = _four_passes(g, e, k, cap, chunk)
    _assert_matches_plain(g, e, k, got)
