"""The algorithm of the row-segment K4 kernel on the CPU.

``csrc/topk_cr_reduce.cu`` reads a top-k payload row as K1 writes it:
every pick above the threshold in index order, then the ties in index
order, so at most two strictly ascending runs.  It works in three parts:

1. the run pass: per payload row the descents (positions p > 0 with
   ``idx[p] <= idx[p - 1]``), a route flag set when a row holds more than
   ``MAX_RUNS`` runs, and for every segment boundary ``b * SEG`` the
   positions where a run crosses it, written by the pair of picks that
   straddles it (a searchsorted by scatter; a warp writes a long gap's
   boundaries 32 at a time);
2. the ranges: for each message, run and segment, the positions whose
   indices fall in the segment, from the run's end indices and the
   crossings;
3. the segment pass: a segment zeroed to +0.0, each message's products
   ``f32(v) * w`` added in order, the segment written once (16-byte
   stores, the staging shifted for rows that start off 16 bytes).  On the
   atomic route the call scatters one message after another instead.

The numpy mirror below takes ``SEG`` and ``MAX_RUNS`` as parameters and is
held bit for bit against the port's plain version ``topk_cr_reduce_plain``,
and against the JAX package's Pallas kernel in interpret mode within
``TOL`` (1e-6, the limit ``tests/test_torch_cr_reduce.py`` states: JAX's
scatter order is its own).  The payloads come from a numpy seed and are
put in K1's documented order by the port's ``documented_order``.  The
kernel runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cr_reduce import ops as JCR  # noqa: E402

from repro_torch.kernels.cr_reduce.ref import (  # noqa: E402
    topk_cr_reduce_plain)
from repro_torch.kernels.topk_ef.ref import (documented_order,  # noqa: E402
                                             topk_ef_plain)

TOL = 1e-6
SEG, MAX_RUNS = 1 << 13, 2       # the kernel's kSeg and kMaxRuns


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------

def _run_pass(idx, seg, max_runs, nseg):
    """idx (rows, k) -> (flag, descents per row, crossings): crossings[row]
    maps a boundary b to the sorted positions p with idx[p - 1] < b * seg
    <= idx[p] inside a run.  Positions are visited as the kernel's warps
    hold them: a lane four consecutive positions of the flattened payload,
    a warp 128.  A warp whose lanes see max_runs descents of one row (the
    rows of the first and the last such lane agree) sets the flag itself;
    any other descent is recorded per row (the kernel's atomicMax, whose
    old value tells a second descent).  Each ascending pair (j - 1, j)
    crosses the boundaries (q[j - 1], q[j]], q the clamped index // seg
    (the kernel's warp writes each lane's in turn, 32 at a time)."""
    rows, k = idx.shape
    flat = idx.reshape(-1).astype(np.int64)
    n = rows * k
    desc = [[] for _ in range(rows)]
    cross = [dict() for _ in range(rows)]
    flag = False
    for w0 in range(0, n, 128):
        f = w0 + np.arange(128)
        x = np.where(f < n, flat[np.minimum(f, n - 1)], 0)
        before = np.concatenate([[flat[w0 - 1] if w0 > 0 else 0], x[:-1]])
        row, p = f // k, f % k
        pair = (f < n) & (p > 0)
        is_desc = pair & (x <= before)
        lanes = [lane for lane in range(32) if is_desc[4 * lane:4 * lane + 4]
                 .any()]
        first_row = [row[4 * lane + int(np.argmax(is_desc[4 * lane:4 * lane
                                                           + 4]))]
                     for lane in lanes]
        multi = len(lanes) >= max_runs and first_row[0] == first_row[-1]
        if multi:
            flag = True
            continue
        for i in np.nonzero(is_desc)[0]:
            desc[row[i]].append(int(p[i]))
            if len(desc[row[i]]) >= max_runs:
                flag = True
        q = np.minimum(np.maximum(np.concatenate([before[:1], x]) // seg, 0),
                       nseg)
        nb = np.where(pair & ~is_desc, np.maximum(q[1:] - q[:-1], 0), 0)
        for i in np.nonzero(nb)[0]:
            for b in range(int(q[i]) + 1, int(q[i + 1]) + 1):
                cross[row[i]].setdefault(b, []).append(int(p[i]))
    return flag, [sorted(d) for d in desc], [
        {b: sorted(v) for b, v in c.items()} for c in cross]


def _runs(desc, k):
    cuts = [0] + desc + [k]
    return list(zip(cuts[:-1], cuts[1:]))


def _run_start(ix, cross_row, a, e, b, seg, which, max_runs):
    """First position of run [a, e) with index >= b * seg; the kernel's
    choice of crossing (the minimum for the first run, the maximum for the
    second) is checked against the one inside the run."""
    if e <= a:
        return a
    bound = b * seg
    if ix[a] >= bound:
        return a
    if ix[e - 1] < bound:
        return e
    inside = [p for p in cross_row.get(b, []) if a < p < e]
    assert len(inside) == 1
    if max_runs == 2:
        pick = cross_row[b][0] if which == 0 else cross_row[b][-1]
        assert pick == inside[0]
    return inside[0]


def _ranges(idx, r, seg, max_runs):
    """-> (flag, ranges[row][b] = [(lo, hi) per run])."""
    rows, k = idx.shape
    nseg = -(-r // seg)
    flag, desc, cross = _run_pass(idx, seg, max_runs, nseg)
    if flag:
        return flag, None
    out = []
    for row in range(rows):
        runs = _runs(desc[row], k)
        per_b = []
        for b in range(nseg):
            per_b.append([
                (_run_start(idx[row], cross[row], a, e, b, seg, i, max_runs),
                 _run_start(idx[row], cross[row], a, e, b + 1, seg, i,
                            max_runs))
                for i, (a, e) in enumerate(runs)])
        out.append(per_b)
    return flag, out


def _apply(dst, vals, idx, lo_hi, seg0, n, w):
    """One message's picks of one segment, in position order, added with
    the product rounded first."""
    with np.errstate(invalid="ignore"):          # inf * 0 is NaN
        for lo, hi in lo_hi:
            for p in range(lo, hi):
                o = int(idx[p]) - seg0
                if 0 <= o < n:
                    dst[o] = np.float32(dst[o] + np.float32(
                        np.float32(vals[p]) * w))


def _shifted_write(out_row_flat, base, segbuf, n):
    """The K4 write-back: a scalar head up to the first 16-byte boundary of
    the flat output, 4-wide stores from a staging copy shifted by
    ``shift``, a scalar tail.  -> the number of 4-wide stores."""
    head = min((4 - base % 4) % 4, n)
    shift = (4 - head) % 4
    stage = np.zeros(len(segbuf) + 4, np.float32)
    stage[shift:shift + n] = segbuf[:n]
    out_row_flat[base:base + head] = stage[shift:shift + head]
    n4 = (n - head) // 4
    first = (shift + head) // 4
    # the 4-wide stores start on 16 bytes and read 4-aligned staging (a
    # segment shorter than its head has none)
    assert n4 == 0 or (shift + head) % 4 == 0 == (base + head) % 4
    for i in range(n4):
        out_row_flat[base + head + 4 * i:base + head + 4 * i + 4] = \
            stage[4 * (first + i):4 * (first + i) + 4]
    t0 = head + 4 * n4
    out_row_flat[base + t0:base + n] = stage[shift + t0:shift + n]
    return n4


def reduce_mirror(vals, idx, w, r, seg=SEG, max_runs=MAX_RUNS):
    """K4: -> (out (M, R) f32, route)."""
    s, m, k = vals.shape
    vals = vals.astype(np.float32)
    out = np.zeros(m * r, np.float32)
    flag, rg = _ranges(idx.reshape(s * m, k), r, seg, max_runs) \
        if s * m * k else (False, None)
    if flag:
        for i in range(s):
            for row in range(m):
                _apply(out[row * r:(row + 1) * r], vals[i, row], idx[i, row],
                       [(0, k)], 0, r, w[i])
        return out.reshape(m, r), "atomic"
    out[:] = np.nan                    # every entry must be written
    for row in range(m):
        for b in range(-(-r // seg)):
            seg0, n = b * seg, min(seg, r - b * seg)
            buf = np.zeros(seg, np.float32)
            for i in range(s if rg is not None else 0):
                _apply(buf, vals[i, row], idx[i, row], rg[i * m + row][b],
                       seg0, n, w[i])
            _shifted_write(out, row * r + seg0, buf, n)
    return out.reshape(m, r), "segment"


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def k1_payload(rng, s, m, r, k, ties=False):
    """S messages of K1's picks in the documented order: ``topk_ef_plain``
    on seeded rows (``ties``: few magnitudes, so a long run of ties
    follows the picks above the threshold)."""
    vals, idx = [], []
    for _ in range(s):
        g = (rng.integers(-3, 4, (m, r)) * 0.5 if ties
             else rng.standard_normal((m, r))).astype(np.float32)
        v, i, _ = topk_ef_plain(torch.from_numpy(g), None, k)
        v, i = documented_order(v, i)
        vals.append(v.numpy())
        idx.append(i.numpy())
    return np.stack(vals), np.stack(idx).astype(np.int32)


def _runs_of(idx):
    return 1 + int(np.sum(idx[:, :, 1:] <= idx[:, :, :-1], axis=2).max())


def _reduce_check(vals, idx, w, r, seg, max_runs, route, dtype="float32"):
    tv = torch.from_numpy(vals)
    if dtype == "bfloat16":
        tv = tv.to(torch.bfloat16)
        vals = tv.float().numpy()
    got, took = reduce_mirror(vals, idx, w, r, seg, max_runs)
    want = topk_cr_reduce_plain(tv, torch.from_numpy(idx),
                                torch.from_numpy(w), r).numpy()
    assert took == route
    np.testing.assert_array_equal(got.view(np.int32) * ~np.isnan(got),
                                  want.view(np.int32) * ~np.isnan(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    return got


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seg,max_runs", [(32, 2), (64, 3), (256, 2)])
def test_reduce_mirror_k1_payloads(seg, max_runs, ties):
    """One run (the tie after every pick above) or two (the ties after a
    descent) per row: the segment route, bitwise the plain version."""
    rng = np.random.default_rng(seg + 7 * ties)
    s, m, r, k = 3, 4, 1000, 70
    vals, idx = k1_payload(rng, s, m, r, k, ties)
    assert _runs_of(idx) <= 2
    w = np.array([1.0, 0.5, 1.25], np.float32)
    _reduce_check(vals, idx, w, r, seg, max_runs, "segment")
    one = np.sort(idx, axis=2)          # one ascending run a row
    _reduce_check(np.take_along_axis(vals, np.argsort(idx, 2), 2), one, w, r,
                  seg, max_runs, "segment", "bfloat16")


@pytest.mark.parametrize("max_runs", [2, 3])
def test_reduce_mirror_routes(max_runs):
    """Runs over MAX_RUNS take the atomic route; a duplicate index (a
    non-strict ascent) starts a second run and stays on the segment route
    when MAX_RUNS allows; an ordered message beside a permuted one sends the
    whole call to the atomic route."""
    rng = np.random.default_rng(3)
    r, k = 300, 20
    base = np.sort(rng.choice(r, size=k, replace=False)).astype(np.int32)
    three = np.concatenate([base[10:], base[5:10], base[:5]])[None, None]
    vals = rng.standard_normal((1, 1, k)).astype(np.float32)
    w = np.ones(1, np.float32)
    _reduce_check(vals, three, w, r, 32, max_runs,
                  "segment" if max_runs >= 3 else "atomic")
    dup = base.copy()
    dup[7] = dup[6]                     # idx[7] <= idx[6]: a second run
    _reduce_check(vals, dup[None, None], w, r, 32, max_runs, "segment")
    perm = rng.permutation(r)[:k].astype(np.int32)
    mixed = np.stack([base, perm])[:, None]
    _reduce_check(rng.standard_normal((2, 1, k)).astype(np.float32), mixed,
                  np.ones(2, np.float32), r, 32, max_runs, "atomic")


def test_reduce_mirror_unaligned_rows_zero_and_inf():
    """M > 1 with R % 4 != 0 (rows start off 16 bytes), -0.0 products (a
    -0.0 value, and negative values under a zero weight) and inf under a
    zero weight (NaN, as in the plain version)."""
    rng = np.random.default_rng(5)
    s, m, r, k = 3, 6, 257, 15
    vals, idx = k1_payload(rng, s, m, r, k)
    vals[0, 1, :4] = -0.0
    vals[2, 5, 0] = np.inf
    w = np.array([1.0, 0.0, 0.0], np.float32)
    got = _reduce_check(vals, idx, w, r, 32, 2, "segment")
    assert np.isnan(got).sum() == 1
    assert not np.signbit(got[got == 0]).any()   # 0 + -0.0 is +0.0


def test_mirror_empty_segments_and_boundaries():
    """Segments with no pick, picks on the segment boundaries (b * SEG and
    b * SEG - 1) and a tie run that jumps over many segments."""
    seg, r = 16, 16 * 40
    row = np.array([0, 15, 16, 17, 31, 32, 64, 300, 301, 639, 5, 200, 480],
                   np.int32)                      # two runs
    k = len(row)
    idx = np.stack([row, np.sort(row)])[:, None]
    vals = np.random.default_rng(6).standard_normal((2, 1, k)).astype(
        np.float32)
    w = np.array([0.75, 1.5], np.float32)
    _reduce_check(vals, idx, w, r, seg, 2, "segment")


@pytest.mark.parametrize("ties", [False, True])
def test_mirror_matches_pallas_interpret(ties):
    """The mirror against the JAX package's Pallas kernel in interpret mode
    (M = 8, as its row blocks need), on K1-ordered payloads."""
    rng = np.random.default_rng(11 + ties)
    s, m, r, k = 2, 8, 384, 24
    vals, idx = k1_payload(rng, s, m, r, k, ties)
    w = np.array([1.0, 0.5], np.float32)
    got, took = reduce_mirror(vals, idx, w, r, 64, 2)
    want = np.asarray(JCR.topk_reduce(jnp.asarray(vals), jnp.asarray(idx),
                                      jnp.asarray(w), r, impl="kernel"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert took == "segment"


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 199), min_size=1, max_size=40, unique=True),
       st.integers(0, 40), st.sampled_from([4, 16, 64]))
def test_ranges_are_searchsorted(picks, cut, seg):
    """Two ascending runs (a row split at ``cut`` and sorted on each side):
    each run's range in each segment is what np.searchsorted finds."""
    r = 200
    cut = min(cut, len(picks))
    row = np.array(sorted(picks[:cut]) + sorted(picks[cut:]), np.int32)
    flag, rg = _ranges(row[None], r, seg, 2)
    assert not flag
    two = 0 < cut < len(row) and row[cut] <= row[cut - 1]
    runs = [(0, cut), (cut, len(row))] if two else [(0, len(row))]
    for b in range(-(-r // seg)):
        assert len(rg[0][b]) == len(runs)
        for (a, e), (lo, hi) in zip(runs, rg[0][b]):
            part = row[a:e]
            assert lo == a + np.searchsorted(part, b * seg)
            assert hi == a + np.searchsorted(part, (b + 1) * seg)
