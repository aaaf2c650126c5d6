"""zamba2 training in the port against the JAX reference: the gradients of
the Mamba2 stack with its shared attention block, one bounded-staleness
top-k step and one ``--sync topk_ef`` step, and the backward of the SSD
scan (K10's plain version, which is K10's backward on the card).

* ``ssd_plain``'s gradients (``torch.autograd``) against ``jax.vjp`` of
  the reference's ``ssd_chunked``, f32, decays in (-0.1, 0): every input's
  gradient within 1e-4 relative (Frobenius) error (read at most 2.6e-7).
  With strong decays (a in (-2, -1), a chunk of 128 sums to about -190,
  so exp(cum_i - cum_j) above the diagonal overflows) against ``jax.vjp``
  of the reference's stepwise ``ssd_sequential`` (the chunked form's own
  vjp is NaN there: it masks after the exponential): finite, within 1e-4
  (read at most 2.1e-6).
* The autograd function behind K10's wrapper, run on the CPU with its
  launch replaced by ``ssd_plain`` (the kernel has no CPU mode; the card
  tests hold the kernel itself): the forward bitwise the no-grad call,
  the gradients bitwise ``ssd_plain``'s autograd, contiguous and in the
  inputs' dtypes, one launch a forward and none in backward.
* ``zamba2-7b-smoke`` (2 layers, the shared block once): loss and every
  leaf's gradient of ``mean_grads`` against the reference's
  ``jax.value_and_grad`` of ``loss_fn``, batch 2 x 128 of the Markov
  stream.  f32 compute: loss within 1e-5, each leaf within 1e-4 relative
  error (read at most 2.5e-6); bf16: loss within 2e-2, each leaf within
  5e-2 (read at most 1.3e-2), the bounds ``test_torch_rwkv6.py`` holds
  RWKV6's gradients to.
* One async top-k step (tau_max 2, ``uniform``, top-k 1/8 with EF) and one
  ``topk_ef`` step (top-k 1/8) of ``zamba2-7b-smoke`` with p = 1 against
  the reference's steps: the port's own loss within 2e-2 of the
  reference step's, and its delivery / sync half, fed the reference's
  gradients, on the reference's params, rings and EF residuals within
  1e-6 (``tests/test_torch_async.py``'s TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import scheduler as JS  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro.dist import async_engine as JAE  # noqa: E402
from repro.dist import sharding as SH  # noqa: E402
from repro.dist.train import init_dist_sync_state as jax_init_sync  # noqa: E402
from repro.dist.train import loss_fn as jax_loss_fn  # noqa: E402
from repro.dist.train import make_elastic_train_step as jax_elastic  # noqa: E402
from repro.dist.train import mean_grads as jax_mean_grads  # noqa: E402
from repro.jax_compat import make_mesh  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import ref_recurrent as JRR  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import is_param_def  # noqa: E402
from repro.models.params import param_specs as jax_param_specs  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SyncConfig  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state,
                                           make_async_train_step)
from repro_torch.dist.train import (init_dist_sync_state,  # noqa: E402
                                    make_elastic_train_step, mean_grads)
from repro_torch.kernels.ssd import kernel as K10  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_plain  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import param_specs, params_from_jax  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

ARCH = "zamba2-7b-smoke"
TOL = 1e-6
MODEL_TOL = 2e-2
LR = 1e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ssd_inputs(seed, shape, decay):
    b, t, h, hd, n = shape
    rng = np.random.default_rng(seed)
    lo, hi = decay
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.uniform(lo, hi, (b, t, h)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(np.float32),
            rng.standard_normal((b, t, n)).astype(np.float32))


def _port_vjp(ins, seed):
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, s = ssd_plain(*ts)
    rng = np.random.default_rng(seed)
    gy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    gs = rng.standard_normal(tuple(s.shape)).astype(np.float32)
    grads = torch.autograd.grad((y, s), ts, (torch.from_numpy(gy),
                                             torch.from_numpy(gs)))
    return [g.numpy() for g in grads], gy, gs


@pytest.mark.parametrize("shape,decay,ref", [
    ((2, 256, 4, 16, 8), (-0.1, 0.0), "chunked"),
    ((1, 128, 3, 20, 12), (-0.1, 0.0), "chunked"),
    ((2, 256, 4, 16, 8), (-2.0, -1.0), "sequential")])
def test_ssd_plain_grads_match_reference_vjp(shape, decay, ref):
    ins = _ssd_inputs(sum(shape), shape, decay)
    got, gy, gs = _port_vjp(ins, 1)
    fn = (lambda *a: JM2.ssd_chunked(*a, None)) if ref == "chunked" \
        else (lambda *a: JRR.ssd_sequential(*a, None))
    _, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    for name, g, w in zip(("xh", "a", "bmat", "cmat"), got, want):
        assert np.isfinite(g).all(), name
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_autograd_function_on_the_plain_launch(dtype, monkeypatch):
    launches = []

    def launch(self, xh, a, bmat, cmat, c):
        launches.append(c)
        return ssd_plain(xh, a, bmat, cmat, chunk=c)

    monkeypatch.setattr(K10.SsdChunked, "_launch", launch)
    dt = getattr(torch, dtype)
    xh, a, bm, cm = (torch.from_numpy(v) for v in _ssd_inputs(
        3, (2, 256, 4, 16, 8), (-2.0, 0.0)))
    xh, bm, cm = xh.to(dt), bm.to(dt), cm.to(dt)
    with torch.no_grad():
        y0, s0 = K10._SsdFunction.apply(K10.ssd_chunked, 128, xh, a, bm, cm)
    outs, grads = [], []
    for fn in ("kernel", "plain"):
        ins = [v.clone().requires_grad_() for v in (xh, a, bm, cm)]
        y, s = (K10._SsdFunction.apply(K10.ssd_chunked, 128, *ins)
                if fn == "kernel" else ssd_plain(*ins))
        (y.float().square().sum() + s.sum()).backward()
        outs.append((y, s))
        grads.append([v.grad for v in ins])
    assert launches == [128, 128]
    assert torch.equal(outs[0][0], y0) and torch.equal(outs[0][1], s0)
    for g, w, v in zip(*grads, (xh, a, bm, cm)):
        assert torch.equal(g, w)
        assert g.dtype == v.dtype and g.is_contiguous()
        assert bool(torch.isfinite(g.float()).all())
    # the state unused (the training forward): only y's gradient flows
    ins = [v.clone().requires_grad_(i != 1) for i, v in
           enumerate((xh, a, bm, cm))]
    y, _ = K10._SsdFunction.apply(K10.ssd_chunked, 128, *ins)
    y.float().sum().backward()
    assert ins[1].grad is None and ins[0].grad is not None
    assert len(launches) == 3


# ---------------------------------------------------------------------------
# the model's gradients
# ---------------------------------------------------------------------------

def _numpy_params(jdefs, seed):
    """Matrices as the reference draws them; a_log, dt_bias, d_skip, the
    conv biases and the norm scales random around their inits.  a_log in
    (-1, 0) and dt_bias in (-2, -0.5) keep each chunk's summed decay well
    inside exp's range: the reference's chunked scan masks after the
    exponential, so its gradient is NaN where exp(cum_i - cum_j) above the
    diagonal overflows (see the strong-decay case above)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=is_param_def)
    out = []
    for path, d in flat:
        name, shape = str(path[-1].key), d.shape
        if name == "a_log":
            v = rng.uniform(-1.0, 0.0, shape)
        elif name == "dt_bias":
            v = rng.uniform(-2.0, -0.5, shape)
        elif name == "d_skip":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("conv_x_b", "conv_bc_b"):
            v = 0.1 * rng.standard_normal(shape)
        elif d.init == "ones":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = d.scale if d.scale is not None else fan_in ** -0.5
            v = std * rng.standard_normal(shape)
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JTF, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def ref():
    """zamba2-7b-smoke's numpy parameters (seed 8) on the reference's
    (1, 1) mesh, a Markov-stream batch of 2 x 128, and the reference's
    bf16 loss and gradients of it (``mean_grads``)."""
    cfg = jax_get_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    flags = JTF.RunFlags(remat=False)
    defs = JTF.model_defs(cfg)
    pspecs = jax_param_specs(defs, SH.axis_sizes(mesh))
    params = jax.tree.map(jnp.asarray, _numpy_params(defs, 8))
    batch = SyntheticLMDataset(cfg.vocab_size, 128, 2, seed=0).batch(0)
    loss, _, grads = jax.jit(
        lambda p, b: jax_mean_grads(cfg, flags, p, b, 1))(params, batch)
    return cfg, mesh, flags, pspecs, params, batch, (loss, grads)


def _compare_grads(loss, grads, jloss, jgrads, loss_tol, grad_tol):
    assert abs(float(loss) - float(jloss)) <= loss_tol
    paths = T.paths(grads)
    assert any(p.startswith("shared_attn/") for p in paths)
    for path, g, jg in zip(paths, T.leaves(grads), jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, path
        assert _rel(g.numpy(), jg) <= grad_tol, (path, _rel(g.numpy(), jg))


def test_grads_match_reference_f32(ref, f32_compute):
    jcfg, _, _, _, jparams, batch, _ = ref
    flags = JTF.RunFlags(remat=False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b, flags), has_aux=True))(
            jparams, batch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    loss, _, grads = mean_grads(get_config(ARCH), params,
                                to_device(batch, "cpu"))
    _compare_grads(loss, grads, jloss, jgrads, 1e-5, 1e-4)


def test_grads_match_reference_bf16(ref):
    _, _, _, _, jparams, batch, (jloss, jgrads) = ref
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    loss, _, grads = mean_grads(get_config(ARCH), params,
                                to_device(batch, "cpu"))
    _compare_grads(loss, grads, jloss, jgrads, 2e-2, 5e-2)


# ---------------------------------------------------------------------------
# one async top-k step and one topk_ef step against the reference's
# ---------------------------------------------------------------------------

def _port_start(jparams):
    cfg = get_config(ARCH)
    specs = param_specs(TF.model_defs(cfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    opt = momentum(constant(LR), 0.9)
    return cfg, specs, tparams, opt, opt.init(T.leaves(tparams))


def _close_trees(port, reference, what):
    for path, a, b in zip(T.paths(port), T.leaves(port),
                          jax.tree.leaves(reference)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {path}")


def test_async_topk_step_matches_reference(ref):
    jcfg, mesh, flags, pspecs, jparams, batch, (_, jgrads) = ref
    kw = dict(tau_max=2, schedule="uniform", seed=1, compressor="topk",
              topk_ratio=1 / 8)
    jacfg = JAE.AsyncConfig(axis_names=("data",), **kw)
    jopt = jax_momentum(LR, 0.9)
    jstate = JAE.init_async_state(jacfg, mesh, jparams, pspecs)
    jstep = jax.jit(JAE.make_async_train_step(jcfg, jopt, mesh, jacfg,
                                              pspecs, flags))
    jnew, _, jstate, jm = jstep(jparams, jopt.init(jparams), jstate, batch)

    cfg, specs, tparams, opt, topt = _port_start(jparams)
    acfg = AsyncConfig(**kw)
    tstate = init_async_state(acfg, 1, tparams, specs)
    tstep = make_async_train_step(cfg, opt, acfg, 1, specs)
    (loss, _), = list(tstep.worker_grads(tparams, to_device(batch, "cpu")))
    assert abs(float(loss) - float(jm["loss"])) < MODEL_TOL
    g = params_from_jax(jax.tree.map(np.asarray, jgrads))
    tparams, topt, tstate, tm = tstep.deliver(tparams, topt, tstate,
                                              [(loss, g)])
    _close_trees(tparams, jnew, "params")
    for key in ("acc", "err"):
        _close_trees(tstate[key], jstate[key], key)
    assert tm["mean_tau"] == float(jm["mean_tau"])
    np.testing.assert_allclose(float(tm["stale_gap2"]),
                               float(jm["stale_gap2"]), rtol=2e-5, atol=TOL)


def test_topk_ef_step_matches_reference(ref):
    jcfg, mesh, flags, pspecs, jparams, batch, (_, jgrads) = ref
    jscfg = JS.SyncConfig(strategy="topk_ef", axis_names=("data",),
                          topk_ratio=1 / 8)
    jopt = jax_momentum(LR, 0.9)
    jstate = jax_init_sync(jscfg, mesh, jparams)
    jstep = jax.jit(jax_elastic(jcfg, jopt, mesh, jscfg, pspecs, flags))
    jnew, _, jstate, jm = jstep(jparams, jopt.init(jparams), jstate, batch)

    cfg, specs, tparams, opt, topt = _port_start(jparams)
    scfg = SyncConfig(strategy="topk_ef", topk_ratio=1 / 8)
    tstate = init_dist_sync_state(scfg, 1, tparams)
    tstep = make_elastic_train_step(cfg, opt, scfg, 1, specs)
    (loss, _), = list(tstep.worker_grads(tparams, to_device(batch, "cpu")))
    assert abs(float(loss) - float(jm["loss"])) < MODEL_TOL
    g = params_from_jax(jax.tree.map(np.asarray, jgrads))
    tparams, topt, tstate, tm = tstep.sync_update(tparams, topt, tstate,
                                                  [(loss, g)])
    _close_trees(tparams, jnew, "params")
    _close_trees(tstate["err"], jstate["err"], "err")
    np.testing.assert_allclose(float(tm["gap2_over_alpha2"]),
                               float(jm["gap2_over_alpha2"]), rtol=1e-5)
