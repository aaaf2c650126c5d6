"""The port's chunked SSD scan forms against the JAX reference, on the same
seeded numpy inputs:

* ``ssd_plain`` (K10's plain version) against the Pallas
  ``ssd_chunked_kernel`` in interpret mode.  f32: y within 1e-4 (the two
  read 2.3e-5 to 4.6e-5 apart at |y| near 100 to 127; the order of the
  f32 sums differs) and the state within 2e-5.  bf16: y within that f32
  limit plus one bf16 rounding step, 1e-4 + 2^-7 |kernel|, element by
  element: both round an f32 result once, and f32 results that differ by
  d round at most d + 2^-7 |y| apart.
* ``ssd_plain`` against ``kernels/ssd/ref.py::ssd_ref`` at
  ``tests/test_kernels.py``'s tolerances (atol 2e-4 in f32, 0.5 in bf16;
  rtol 1e-2): ``ssd_ref`` is the model's form, which casts the (C, C)
  matrix to x's dtype, so bf16 differs by up to a bf16 step of y.
* ``ssd_plain`` against ``models/ref_recurrent.py::ssd_sequential`` (the
  step-by-step recurrence) in f32, y within 2e-4 and the state 5e-5.
* The port's model form ``mamba2.ssd_chunked`` with a state against the
  reference's: f32 within 1e-5 + 1e-5 |y| (the einsums sum in other
  orders; 1.9e-5 read at |y| near 5), bf16 within 1e-2 + 2^-7 |y|, for
  T = 1 (decode) and a two-chunk T with a state handed over.

Shapes: the three of ``tests/test_kernels.py`` and (1, 256, 2, 112, 64),
zamba2's head dim.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_chunked_kernel  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models.ref_recurrent import ssd_sequential  # noqa: E402

from repro_torch.kernels.ssd import ops as SSD  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_plain  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402

F32_Y, F32_S = 1e-4, 2e-5
SHAPES = [  # (B, T, H, hd, N, chunk)
    (1, 256, 2, 64, 32, 128), (2, 128, 4, 32, 64, 64),
    (1, 512, 1, 128, 64, 128), (1, 256, 2, 112, 64, 128)]

jax_ssd_ref = jax.jit(ssd_ref)
jax_ssd_chunked = jax.jit(JM2.ssd_chunked)
jax_ssd_sequential = jax.jit(ssd_sequential)


def _inputs(b, t, h, hd, n, seed, dtype):
    """x, B, C ~ N(0, 1) rounded to ``dtype``; a = -0.1 U(0, 1) (f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    a = (-0.1 * rng.uniform(size=(b, t, h))).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    jx, jb, jc = (jnp.asarray(v).astype(dtype) for v in (x, bm, cm))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx, tb, tc = (torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
                  for v in (jx, jb, jc))
    return (jx, jnp.asarray(a), jb, jc), (tx, torch.from_numpy(a), tb, tc)


def _np(v):
    return np.asarray(v.float() if isinstance(v, torch.Tensor)
                      else v.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_kernel(shape, dtype):
    b, t, h, hd, n, chunk = shape
    jin, tin = _inputs(b, t, h, hd, n, seed=t * h + hd, dtype=dtype)
    jy, js = ssd_chunked_kernel(*jin, chunk=chunk, interpret=True)
    y, s = ssd_plain(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and s.dtype == torch.float32
    assert tuple(y.shape) == (b, t, h, hd) and tuple(s.shape) == (b, h, hd, n)
    want, got = _np(jy), _np(y)
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert np.all(np.abs(got - want) <= F32_Y + rtol * np.abs(want))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=F32_S)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_ssd_ref(shape, dtype):
    b, t, h, hd, n, _ = shape
    jin, tin = _inputs(b, t, h, hd, n, seed=b * t + h, dtype=dtype)
    jy, js = jax_ssd_ref(*jin)
    y, s = SSD.ssd(*tin)             # CPU tensors: the plain version
    atol = 2e-4 if dtype == "float32" else 0.5
    np.testing.assert_allclose(_np(y), _np(jy), atol=atol, rtol=1e-2)
    np.testing.assert_allclose(_np(s), np.asarray(js), atol=atol, rtol=1e-2)


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:])
def test_ssd_plain_matches_sequential_recurrence(shape):
    b, t, h, hd, n, chunk = shape
    jin, tin = _inputs(b, t, h, hd, n, seed=7, dtype="float32")
    jy, js = jax_ssd_sequential(*jin)
    y, s = ssd_plain(*tin, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(_np(s), np.asarray(js), atol=5e-5, rtol=0)


@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_ssd_chunked_with_state_matches_reference(t, dtype):
    """The decode form: a state handed in (and, at T = 256, carried over
    a chunk boundary); the (C, C) matrix cast to x's dtype."""
    b, h, hd, n = 2, 3, 16, 8
    jin, tin = _inputs(b, t, h, hd, n, seed=t, dtype=dtype)
    s0 = np.random.default_rng(11).standard_normal(
        (b, h, hd, n)).astype(np.float32)
    jy, js = jax_ssd_chunked(*jin, jnp.asarray(s0))
    y, s = M2.ssd_chunked(*tin, torch.from_numpy(s0))
    assert y.dtype == tin[0].dtype
    want, got = _np(jy), _np(y)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 1e-2 + 2.0 ** -7 * np.abs(want))
    np.testing.assert_allclose(_np(s), np.asarray(js), atol=1e-5, rtol=1e-6)


def test_ssd_rejects_ragged_sequence():
    _, tin = _inputs(1, 200, 1, 8, 4, seed=0, dtype="float32")
    with pytest.raises(ValueError):
        SSD.ssd(*tin)
    with pytest.raises(ValueError):
        M2.ssd_chunked(*tin)


def test_kernel_wrapper_rejects_cpu_tensors():
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    _, tin = _inputs(1, 8, 1, 8, 4, seed=0, dtype="float32")
    before = ssd_chunked.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked(*tin)
    assert ssd_chunked.launches == before
