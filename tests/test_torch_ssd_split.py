"""The arithmetic of K10's three-pass kernel (``csrc/ssd_chunked.cu``) on
the CPU.

The CUDA kernel runs the chunked SSD scan as three passes:

1. chunk states: per (b, chunk, head) the chunk's cumsum in the kernel's
   order (each of 32 lanes adds 4 steps in order, a warp scan adds the
   lanes' sums) and D = X^T (B * exp(cum_last - cum));
2. the ordered state scan: per (b, head) S = fma(exp(cum_last), S, D)
   chunk by chunk, keeping the state each chunk starts from;
3. outputs: G = C B^T once per (b, chunk), shared by its heads, then per
   head y = exp(cum) (C S^T) + (G * tril(exp2(c_i - c_j))) X, c = cum
   log2(e) rounded to f32 (1 on the diagonal, as exp(cum_i - cum_j)).

Every product runs on bf16 operands with f32 sums: an f32 operand is split
into hi + mid + lo bf16 parts (each the top 16 bits of what is left), and
every pair of parts whose weights reach 2^-16 is multiplied.
``_three_passes`` mirrors that in torch (f32 products of the parts, each
exact, the fused multiply-add taken in f64 and rounded once).  It is held
to the port's plain version ``ssd_plain`` and to the JAX package's Pallas
kernel in interpret mode at ``tests/test_torch_ssd.py``'s f32 limits, taken
relative to the magnitude they were set at: y within 1e-4 per 100 of the
reference's largest |y| (Y_REL) and the state within 2e-5 per 14 of its
largest |S| (S_REL); bf16 y also within one bf16 rounding step, 2^-7 |y|.
The mirror read at most 6.7e-7 and 7.2e-7 of those magnitudes.  The split
itself is checked under ``hypothesis``.  The kernel runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_chunked_kernel  # noqa: E402

from repro_torch.kernels.ssd.ref import chunk_len, ssd_plain  # noqa: E402

Y_REL, S_REL = 1e-4 / 100, 2e-5 / 14
LOG2E = 1.44269504088896341
_TOP16 = torch.tensor(-65536, dtype=torch.int32)          # 0xffff0000


def _split3(v):
    """f32 -> (hi, mid, lo) as f32 tensors holding bf16 values: each the
    top 16 bits of what is left."""
    def top16(u):
        return (u.contiguous().view(torch.int32) & _TOP16).view(torch.float32)

    hi = top16(v.float())
    r1 = v.float() - hi
    mid = top16(r1)
    return hi, mid, top16(r1 - mid)


def _mm(a, b):
    """a @ b over the parts of both, the pairs i + j <= 2, smallest first."""
    pa, pb = _split3(a), _split3(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i in (2, 1, 0):
        for j in (2, 1, 0):
            if i + j <= 2:
                out = out + pa[i] @ pb[j]
    return out


def _chunk_cumsum(a):
    """cumsum over the last axis (<= 128) in the kernel's order."""
    c = a.shape[-1]
    lanes = torch.zeros(a.shape[:-1] + (128,))
    lanes[..., :c] = a
    lanes = lanes.reshape(a.shape[:-1] + (32, 4))
    run = torch.zeros(a.shape[:-1] + (32,))
    local = []
    for q in range(4):
        run = run + lanes[..., q]
        local.append(run)
    inc, off = run, 1
    while off < 32:                      # Hillis-Steele over the lanes
        up = torch.zeros_like(inc)
        up[..., off:] = inc[..., :-off]
        inc = torch.where(torch.arange(32) >= off, inc + up, inc)
        off *= 2
    ex = torch.zeros_like(inc)
    ex[..., 1:] = inc[..., :-1]
    cum = torch.stack([ex + v for v in local], -1)
    return cum.reshape(a.shape[:-1] + (128,))[..., :c]


def _three_passes(xh, a, bmat, cmat, chunk=128):
    b, t, h, hd = xh.shape
    n = bmat.shape[-1]
    c = chunk_len(t, chunk)
    nc = t // c
    x = xh.float().reshape(b, nc, c, h, hd).permute(0, 3, 1, 2, 4)
    cum = _chunk_cumsum(a.float().reshape(b, nc, c, h).permute(0, 3, 1, 2))
    bm = bmat.float().reshape(b, nc, c, n)
    cm = cmat.float().reshape(b, nc, c, n)
    # pass 1: chunk states                                 (b, h, nc, hd, n)
    last = cum[..., -1:]
    d = _mm(x.transpose(-1, -2),
            bm[:, None] * torch.exp(last - cum)[..., None])
    # pass 2: the state each chunk starts from, in chunk order
    el = torch.exp(last[..., 0]).double()
    s = torch.zeros((b, h, hd, n))
    starts = []
    for j in range(nc):
        starts.append(s)
        s = (el[:, :, j, None, None] * s.double() + d[:, :, j].double()
             ).float()
    s_prev = torch.stack(starts, 2)
    # pass 3: C B^T once per (b, chunk), for every head
    g = _mm(cm, bm.transpose(-1, -2))[:, None]              # (b, 1, nc, c, c)
    lmask = torch.tril(torch.ones(c, c, dtype=torch.bool))
    c2 = cum * LOG2E
    amat = torch.where(lmask, g * torch.exp2(c2[..., :, None]
                                             - c2[..., None, :]), 0.0)
    z = _mm(cm[:, None].expand(b, h, nc, c, n), s_prev.transpose(-1, -2))
    y = z * torch.exp(cum)[..., None] + _mm(amat, x)
    return y.permute(0, 2, 3, 1, 4).reshape(b, t, h, hd).to(xh.dtype), s


def _inputs(shape, decay, dtype, seed):
    b, t, h, hd, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    if decay == "u":
        a = -0.1 * rng.uniform(size=(b, t, h))
    elif decay == "zero":
        a = np.zeros((b, t, h))
    else:                                # exp underflows across a chunk
        a = -20.0 - rng.uniform(size=(b, t, h))
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(bm).to(tdt), torch.from_numpy(cm).to(tdt))


def _within(got, want, dtype):
    (y, s), (wy, ws) = got, want
    wy = wy.float()
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    y_ok = bool(((y.float() - wy).abs()
                 <= Y_REL * wy.abs().max() + rtol * wy.abs()).all())
    s_ok = float((s - ws).abs().max()) <= S_REL * float(ws.abs().max())
    return y_ok and s_ok


CASES = [  # (B, T, H, hd, N), log-decays, dtype
    ((2, 128, 3, 32, 16), "u", "float32"),       # T = one chunk
    ((2, 8, 3, 16, 16), "u", "float32"),         # T = 8: one short chunk
    ((2, 384, 3, 40, 24), "u", "float32"),       # hd, N off the 16 tiles
    ((2, 384, 3, 40, 24), "u", "bfloat16"),
    ((1, 256, 2, 128, 128), "u", "float32"),     # the largest hd and N
    ((1, 256, 2, 32, 16), "zero", "float32"),    # no decay
    ((1, 256, 2, 32, 16), "zero", "bfloat16"),
    ((1, 256, 2, 32, 16), "-20", "float32"),     # exp underflows
]


@pytest.mark.parametrize("shape,decay,dtype", CASES)
def test_three_passes_match_plain(shape, decay, dtype):
    args = _inputs(shape, decay, dtype, seed=sum(shape))
    y, s = _three_passes(*args)
    assert y.dtype == args[0].dtype and s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    assert _within((y, s), ssd_plain(*args), dtype)


@pytest.mark.parametrize("shape,decay,dtype", [
    ((2, 8, 3, 16, 16), "u", "float32"),
    ((2, 384, 3, 40, 24), "u", "bfloat16"),
    ((1, 256, 2, 32, 16), "-20", "float32")])
def test_three_passes_match_pallas_kernel(shape, decay, dtype):
    args = _inputs(shape, decay, dtype, seed=7)
    x, a, bm, cm = args
    jx, jb, jc = (jnp.asarray(v.float().numpy()).astype(dtype)
                  for v in (x, bm, cm))
    jy, js = ssd_chunked_kernel(jx, jnp.asarray(a.numpy()), jb, jc,
                                interpret=True)
    want = (torch.from_numpy(np.array(jy.astype(jnp.float32))),
            torch.from_numpy(np.array(js)))
    assert _within(_three_passes(*args), want, dtype)


def test_g_is_shared_by_the_heads():
    """Pass 3 computes C B^T once per (b, chunk): heads that see the same
    x and a give the same y, whatever their index."""
    x, a, bm, cm = _inputs((1, 256, 1, 16, 8), "u", "float32", seed=3)
    y1, s1 = _three_passes(x, a, bm, cm)
    y3, s3 = _three_passes(x.repeat(1, 1, 3, 1), a.repeat(1, 1, 3), bm, cm)
    for hh in range(3):
        assert torch.equal(y3[:, :, hh], y1[:, :, 0])
        assert torch.equal(s3[:, hh], s1[:, 0])


_F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None)
@given(_F32)
def test_split_rebuilds_f32(v):
    """hi + mid + lo is v exactly for |v| >= 2^-110 (and 0): lo's last bit
    is then at or above bf16's smallest step, 2^-133; below that the parts
    miss v by less than 2^-133.  Each part is a bf16 value."""
    parts = _split3(torch.tensor([v], dtype=torch.float32))
    for p in parts:
        assert int(p.view(torch.int32)[0]) & 0xFFFF == 0
    total = sum(float(p[0]) for p in parts)       # exact in f64
    if v == 0.0 or abs(v) >= 2.0 ** -110:
        assert total == v
    else:
        assert abs(total - v) < 2.0 ** -133


@settings(max_examples=300, deadline=None)
@given(_F32, st.floats(width=32, min_value=-2.0 ** 60, max_value=2.0 ** 60,
                       allow_nan=False))
def test_split_part_times_bf16_is_exact(v, w):
    """A part times a bf16 value (8 significant bits each) is exact in f32
    wherever the product is a normal f32: the tensor cores' products of
    the parts lose nothing."""
    wb = _split3(torch.tensor([w], dtype=torch.float32))[0]
    for p in _split3(torch.tensor([v], dtype=torch.float32)):
        exact = float(p[0]) * float(wb[0])
        if exact == 0.0 or 2.0 ** -126 <= abs(exact) < 2.0 ** 127:
            assert float((p * wb)[0]) == exact
