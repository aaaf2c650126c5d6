"""The port's RWKV6 (``models/rwkv6.py``, ``models/ref_recurrent.py`` and
the RWKV6 branch of ``models/transformer.py``) against the JAX reference,
with the same parameters carried across by ``params_from_jax`` (drawn
with numpy; ``mix``, ``cm_mix``, ``bonus_u``, ``decay_bias`` and the norm
scales away from their constant inits, which would hide a wrong index or
a dropped term):

* ``wkv6_chunked`` against the reference's and against the port's own
  ``wkv6_sequential``, whole and with the state handed over between two
  halves; ``ssd_sequential`` against the reference's.  f32: within 1e-4
  of the output's largest magnitude (states: of the state's).
* ``rwkv6_block`` with and without a state.  f32: within 1e-4 of the
  output's largest magnitude; bf16: within 3e-2 of it (the two
  frameworks round the bf16 token mix and projections at different
  places).
* ``forward``, ``prefill`` and 4 ``decode_step``s of ``rwkv6-1.6b-smoke``
  (2 layers, d 128, 8 heads of 16).  f32 compute (both packages'
  ``COMPUTE_DTYPE`` patched): logits within 1e-2 (read 5e-6).  bf16:
  within 0.1 (read 0.068; largest logit 4.7).
* The port's prefill + decode against its own ``forward``: f32 within
  1e-3 (read 3e-6), bf16 within 0.15 (the reference's own test's bound;
  read 0).
* The gradients of one exact step against the reference's
  ``jax.value_and_grad`` of ``loss_fn``: f32 compute, loss within 1e-5
  and every leaf within 1e-4 relative (Frobenius) error (read 4.8e-7 and
  1.8e-6); bf16, loss within 2e-2 and every leaf within 5e-2 relative
  error (read 1.1e-3 and 2.9e-2).
* The RWKV6 layer under ``torch.utils.checkpoint`` gives bitwise the
  output and gradients of a direct call.
* Config and leaf shapes equal the reference's: 19 leaves,
  ``param_count`` 1,400,995,840 and ``count_params`` 1,678,313,472 (the
  reference's analytic term counts 6 d^2 + 1.5 d d_ff a layer, the
  leaves 7 d^2 + 2 d d_ff).
* The launcher trains ``rwkv6-1.6b-smoke`` 2 async top-k steps and serves
  it through ``--engine loop`` on the CPU; ``--engine continuous`` raises
  ``NotImplementedError``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist.train import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import ref_recurrent as JRR  # noqa: E402
from repro.models import rwkv6 as JR6  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import count_params as jax_count  # noqa: E402
from repro.models.params import is_param_def  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.train import mean_grads  # noqa: E402
from repro_torch.models import ref_recurrent as RR  # noqa: E402
from repro_torch.models import rwkv6 as R6  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (count_params,  # noqa: E402
                                       params_from_jax)

ARCH = "rwkv6-1.6b-smoke"
B, S, PRE = 2, 128, 64
F32_LOGITS, BF16_LOGITS = 1e-2, 0.1


def _numpy_params(jdefs, seed):
    """A numpy tree shaped like the reference's ParamDefs: matrices
    N(0, std) as the reference draws them, the mixes, the bonus, the decay
    bias and the norm scales random around their inits."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=is_param_def)
    out = []
    for path, d in flat:
        name, shape = str(path[-1].key), d.shape
        if name in ("mix", "cm_mix"):
            v = rng.uniform(0.0, 1.0, shape)
        elif name == "bonus_u":
            v = 0.5 * rng.standard_normal(shape)
        elif name == "decay_bias":
            v = rng.uniform(-5.0, -1.0, shape)
        elif d.init == "ones":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = d.scale if d.scale is not None else fan_in ** -0.5
            v = std * rng.standard_normal(shape)
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def _cfgs():
    return jax_get_config(ARCH), get_config(ARCH)


def _both_params(jcfg, seed=0):
    tree = _numpy_params(JTF.model_defs(jcfg), seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in float32."""
    monkeypatch.setattr(JTF, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _wkv_inputs(seed, b=B, t=S, h=4, n=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.exp(rng.uniform(-4.0, 1.0, (b, t, h, n))).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, log_w, u


# ---------------------------------------------------------------------------
# the WKV and the sequential oracles
# ---------------------------------------------------------------------------

def test_wkv6_chunked_matches_reference_and_sequential():
    arrs = _wkv_inputs(0)
    jout, jst = jax.jit(JR6.wkv6_chunked)(*map(jnp.asarray, arrs))
    targs = [torch.from_numpy(a) for a in arrs]
    out, st = R6.wkv6_chunked(*targs)
    seq, seq_st = RR.wkv6_sequential(*targs)
    scale = float(np.abs(np.asarray(jout)).max())
    st_scale = float(np.abs(np.asarray(jst)).max())
    assert out.dtype == torch.float32 and st.shape == (B, 4, 16, 16)
    assert _max_err(out, jout) <= 1e-4 * scale
    assert _max_err(st, jst) <= 1e-4 * st_scale
    assert _max_err(out, seq) <= 1e-4 * scale
    assert _max_err(st, seq_st) <= 1e-4 * st_scale
    # the state handed over between two halves of the sequence
    half = S // 2
    first = [a[:, :half] for a in targs[:4]] + [targs[4]]
    second = [a[:, half:] for a in targs[:4]] + [targs[4]]
    o1, s1 = R6.wkv6_chunked(*first)
    o2, s2 = R6.wkv6_chunked(*second, state0=s1)
    assert _max_err(torch.cat([o1, o2], 1), jout) <= 1e-4 * scale
    assert _max_err(s2, jst) <= 1e-4 * st_scale
    q2, _ = RR.wkv6_sequential(*second, state0=s1)
    assert _max_err(q2, o2) <= 1e-4 * scale


def test_wkv6_chunk_rule_and_sequential_oracles_match_reference():
    """A prompt shorter than the chunk is one chunk, a length that is not
    a multiple of 64 is refused, as in the reference; both sequential
    oracles equal the reference's."""
    arrs = _wkv_inputs(1, t=24)
    targs = [torch.from_numpy(a) for a in arrs]
    out, _ = R6.wkv6_chunked(*targs)
    jout, _ = JRR.wkv6_sequential(*map(jnp.asarray, arrs))
    seq, _ = RR.wkv6_sequential(*targs)
    scale = float(np.abs(np.asarray(jout)).max())
    assert _max_err(out, jout) <= 1e-4 * scale
    assert _max_err(seq, jout) <= 1e-4 * scale
    bad = [torch.from_numpy(a) for a in _wkv_inputs(1, t=96)]
    with pytest.raises(AssertionError):
        R6.wkv6_chunked(*bad)
    rng = np.random.default_rng(2)
    xh = rng.standard_normal((B, 20, 3, 8)).astype(np.float32)
    a = -rng.uniform(0.0, 1.0, (B, 20, 3)).astype(np.float32)
    bm, cm = (rng.standard_normal((B, 20, 5)).astype(np.float32)
              for _ in range(2))
    st0 = rng.standard_normal((B, 3, 8, 5)).astype(np.float32)
    jy, js = JRR.ssd_sequential(*map(jnp.asarray, (xh, a, bm, cm, st0)))
    y, s = RR.ssd_sequential(*(torch.from_numpy(z)
                               for z in (xh, a, bm, cm, st0)))
    assert _max_err(y, jy) <= 1e-4 * float(np.abs(np.asarray(jy)).max())
    assert _max_err(s, js) <= 1e-4 * float(np.abs(np.asarray(js)).max())


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_block_matches_reference(dtype, with_state):
    jcfg, cfg = _cfgs()
    jparams, params = _both_params(jcfg, seed=3)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    lp = T.tree_map(lambda a: a[0], params["layers"])
    rng = np.random.default_rng(4)
    t = 1 if with_state else S
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jst = st = None
    if with_state:
        init = JR6.rwkv6_init_state(jcfg, B)
        nst = {k: rng.standard_normal(a.shape).astype(np.float32)
               for k, a in init.items()}
        jst = {k: jnp.asarray(a) for k, a in nst.items()}
        st = {k: torch.from_numpy(a) for k, a in nst.items()}
    jout, jnew = jax.jit(JR6.rwkv6_block, static_argnums=(1,))(
        jlp, jcfg, jx, state=jst)
    out, new = R6.rwkv6_block(lp, cfg, tx, st)
    assert out.dtype == tx.dtype
    rel = 1e-4 if dtype == "float32" else 3e-2
    assert _max_err(out.float(), jout) <= rel * float(
        np.abs(np.asarray(jout, np.float32)).max())
    for k in ("tm_last", "cm_last", "wkv"):
        want = np.asarray(jnew[k], np.float32)
        assert new[k].dtype == torch.float32 and new[k].shape == want.shape
        assert _max_err(new[k], want) <= rel * np.abs(want).max(), k


def test_checkpointed_layer_is_bitwise_the_direct_call():
    """The layer under ``torch.utils.checkpoint`` (as the stack runs it
    under autograd) gives bitwise the direct call's output and the
    gradients of x and of every parameter leaf."""
    from torch.utils.checkpoint import checkpoint
    _, cfg = _cfgs()
    _, params = _both_params(_cfgs()[0], seed=6)
    x0 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    runs = []
    for wrap in (False, True):
        lp = T.tree_map(lambda a: a[0].clone().requires_grad_(True),
                        params["layers"])
        x = x0.clone().requires_grad_(True)
        if wrap:
            out, _ = checkpoint(R6.rwkv6_block, lp, cfg, x, None,
                                use_reentrant=False)
        else:
            out, _ = R6.rwkv6_block(lp, cfg, x, None)
        out.float().square().sum().backward()
        runs.append([out.detach(), x.grad] + [p.grad for p in T.leaves(lp)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jax_steps(jcfg, jparams, toks, feed):
    flags = JTF.RunFlags(remat=False)
    logits = [jax.jit(lambda p, b: JTF.forward(jcfg, p, b, flags)[0])(
        jparams, {"tokens": toks})]
    lg, cache = jax.jit(lambda p, b: JTF.prefill(jcfg, p, b, S + 8, flags))(
        jparams, {"tokens": toks})
    logits.append(lg)
    decode = jax.jit(lambda p, c, t: JTF.decode_step(jcfg, p, c, t, flags))
    for f in feed:
        lg, cache = decode(jparams, cache, f)
        logits.append(lg)
    return [np.asarray(a, np.float32) for a in logits]


def _port_steps(cfg, params, toks, feed):
    with torch.no_grad():
        logits = [TF.forward(cfg, params,
                             {"tokens": torch.from_numpy(toks)})[0]]
        lg, cache = TF.prefill(cfg, params,
                               {"tokens": torch.from_numpy(toks)}, S + 8)
        logits.append(lg)
        for k, a in cache["state"].items():
            assert a.dtype == torch.float32 and a.shape[0] == cfg.n_layers
        for f in feed:
            lg, cache = TF.decode_step(cfg, params, cache,
                                       torch.from_numpy(f))
            logits.append(lg)
    assert cache["pos"] == S + len(feed)
    return [a.float().numpy() for a in logits]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(dtype, request):
    if dtype == "float32":
        request.getfixturevalue("f32_compute")
    jcfg, cfg = _cfgs()
    jparams, params = _both_params(jcfg)
    toks = _tokens(cfg.vocab_size, (B, S), 1)
    feed = _tokens(cfg.vocab_size, (4, B, 1), 2)
    want = _jax_steps(jcfg, jparams, toks, feed)
    got = _port_steps(cfg, params, toks, feed)
    tol = F32_LOGITS if dtype == "float32" else BF16_LOGITS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _max_err(g, w) <= tol, (dtype, i, _max_err(g, w))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 0.15)])
def test_prefill_decode_matches_forward(dtype, tol, request):
    if dtype == "float32":
        request.getfixturevalue("f32_compute")
    jcfg, cfg = _cfgs()
    _, params = _both_params(jcfg, seed=5)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), 6))
    with torch.no_grad():
        full, _ = TF.forward(cfg, params, {"tokens": toks})
        _, cache = TF.prefill(cfg, params, {"tokens": toks[:, :PRE]}, S)
        errs = []
        for t in range(PRE, PRE + 6):
            lg, cache = TF.decode_step(cfg, params, cache, toks[:, t:t + 1])
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < tol, errs
    zero = TF.init_cache(cfg, B, S)
    assert {k: a.shape for k, a in zero["state"].items()} == \
        {k: a.shape for k, a in cache["state"].items()}


@pytest.mark.parametrize("dtype,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_exact_step_grads_match_reference(dtype, loss_tol, grad_tol,
                                          request):
    """The port's ``mean_grads`` (sinks, each RWKV6 layer checkpointed)
    against the reference's ``value_and_grad`` of ``loss_fn``."""
    if dtype == "float32":
        request.getfixturevalue("f32_compute")
    jcfg, cfg = _cfgs()
    jparams, params = _both_params(jcfg, seed=8)
    toks = _tokens(cfg.vocab_size, (B, S + 1), 9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flags = JTF.RunFlags(remat=False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b, flags), has_aux=True))(
            jparams, batch)
    loss, _, grads = mean_grads(cfg, params, {
        k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= loss_tol
    for path, g, jg in zip(T.paths(grads), T.leaves(grads),
                           jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, path
        rel = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert rel <= grad_tol, (path, rel)
    for p in T.leaves(params):
        assert not p.requires_grad or p.grad is None


def test_configs_and_leaves_match_reference():
    for name in ("rwkv6-1.6b", ARCH):
        cfg, jcfg = get_config(name), jax_get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.attention_free and jcfg.attention_free
        defs, jdefs = TF.model_defs(cfg), JTF.model_defs(jcfg)
        jleaves = jax.tree.leaves(jdefs, is_leaf=is_param_def)
        assert [d.shape for d in T.leaves(defs)] == \
            [d.shape for d in jleaves]
        assert count_params(defs) == jax_count(jdefs)
    defs = TF.model_defs(get_config("rwkv6-1.6b"))
    shapes = dict(zip(T.paths(defs), (d.shape for d in T.leaves(defs))))
    assert len(shapes) == 19
    assert shapes["layers/cm_k"] == (24, 2048, 7168)
    assert get_config("rwkv6-1.6b").param_count() == 1_400_995_840
    assert count_params(defs) == 1_678_313_472


def test_launcher_trains_and_serves_rwkv6_on_the_cpu():
    from repro_torch.launch import serve, train
    history = train.main(["--device", "cpu", "--arch", ARCH, "--sync",
                          "async", "--compressor", "topk", "--workers", "2",
                          "--tau-max", "2", "--steps", "2", "--seq", "64",
                          "--batch", "4"])
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["stale_gap2"])
               for r in history)
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--engine", "loop",
                      "--prompt-len", "64", "--gen", "3", "--batch", "2"])
    assert [len(t) for t in out["tokens"]] == [3, 3]
    assert all(0 <= int(v) < 512 for t in out["tokens"] for v in t)
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--arch", ARCH, "--engine",
                    "continuous", "--gen", "2"])
