"""The port's other attention stacks, gradient accumulation and the
trainer's launcher flags against the JAX reference, with the same
parameters carried across by ``params_from_jax`` (drawn with numpy; norm
scales around 1):

* gemma3's local:global stack at ``n_layers=7, global_every=3`` (windows
  [32, 32, 0, 32, 32, 0, 32]: the reference's two groups of three and a
  remainder layer; the port loops over layers, each with its own window)
  and ``mistral-nemo-12b`` with ``head_dim`` 48 (n_heads x head_dim = 192
  != d_model = 128): ``forward``, ``prefill`` and 4 ``decode_step``s,
  sequence 128 (four windows).  f32 compute (both packages'
  ``COMPUTE_DTYPE`` and the reference's KV cache set to float32): logits
  within 1e-3 (read 3e-6 for gemma3, 2.2e-4 for nemo, whose reference
  differs from itself jitted and eager by 1.6e-4).  bf16: gemma3 within
  0.1 (read 0.039); nemo within 0.25 (read 0.157): without qk-norm its
  random attention is sharp, and the reference's own jitted and eager
  forwards differ by 0.132 there.
* ``configs_match_reference`` for rwkv6-1.6b, gemma3-27b and
  mistral-nemo-12b and their smoke variants: every field,
  ``param_count`` and ``count_params`` of the leaves.
* ``grad_accum`` 2 against the reference's ``make_train_step(...,
  grad_accum=2)`` (qwen3-1.7b-smoke, f32 compute, momentum 0.9): loss and
  ``grad_norm`` within 1e-5 relative, parameters after the step within
  1e-6; ``grad_accum`` 1 gives bitwise the step without it, and the
  elastic and async steps' workers take bitwise ``mean_grads`` of their
  shards over 2 microbatches.
* ``--crash-subst`` reaches ``AsyncConfig``; ``--log-every 2`` prints
  steps 0 and 2 of 3, and ``main`` still returns all three.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist.train import make_train_step as jax_train_step  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import count_params as jax_count  # noqa: E402
from repro.models.params import is_param_def  # noqa: E402
from repro import optim as JO  # noqa: E402

from repro_torch import optim as O  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (count_params,  # noqa: E402
                                       params_from_jax)

B, S = 2, 128
CASES = {
    "gemma3_mixed": ("gemma3-27b-smoke", dict(n_layers=7, global_every=3)),
    "nemo_head_dim": ("mistral-nemo-12b-smoke", dict(head_dim=48)),
}
TOL = {("gemma3_mixed", "float32"): 1e-3,
       ("gemma3_mixed", "bfloat16"): 0.1,
       ("nemo_head_dim", "float32"): 1e-3,
       ("nemo_head_dim", "bfloat16"): 0.25}


def _cfgs(case):
    name, repl = CASES[case]
    return tuple(dataclasses.replace(get(name), **repl)
                 for get in (jax_get_config, get_config))


def _numpy_params(jdefs, seed):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=is_param_def)
    out = []
    for _, d in flat:
        if d.init == "ones":
            v = 1.0 + 0.1 * rng.standard_normal(d.shape)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale if d.scale is not None else fan_in ** -0.5
            v = std * rng.standard_normal(d.shape)
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def _both_params(jcfg, seed=0):
    tree = _numpy_params(JTF.model_defs(jcfg), seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JTF, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    return JTF.RunFlags(remat=False, kv_cache_dtype=jnp.float32)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab,
                                                shape).astype(np.int32)


def _jax_steps(jcfg, jparams, toks, feed, flags):
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
        for f in feed:
            lg, cache = TF.decode_step(cfg, params, cache,
                                       torch.from_numpy(f))
            logits.append(lg)
    return [a.float().numpy() for a in logits]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_stacks_match_reference(case, dtype, request):
    flags = (request.getfixturevalue("f32_compute") if dtype == "float32"
             else JTF.RunFlags(remat=False))
    jcfg, cfg = _cfgs(case)
    if case == "gemma3_mixed":
        assert cfg.layer_window_sizes() == [32, 32, 0, 32, 32, 0, 32]
    else:
        assert cfg.n_heads * cfg.resolved_head_dim != cfg.d_model
    jparams, params = _both_params(jcfg)
    toks = _tokens(cfg.vocab_size, (B, S), 1)
    feed = _tokens(cfg.vocab_size, (4, B, 1), 2)
    want = _jax_steps(jcfg, jparams, toks, feed, flags)
    got = _port_steps(cfg, params, toks, feed)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _max_err(g, w) <= TOL[case, dtype], (case, dtype, i,
                                                    _max_err(g, w))


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "gemma3-27b",
                                  "mistral-nemo-12b"])
def test_configs_match_reference(name):
    for n in (name, name + "-smoke"):
        cfg, jcfg = get_config(n), jax_get_config(n)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.attention_free == jcfg.attention_free
        assert cfg.layer_window_sizes() == jcfg.layer_window_sizes()
        defs, jdefs = TF.model_defs(cfg), JTF.model_defs(jcfg)
        assert [d.shape for d in T.leaves(defs)] == \
            [d.shape for d in jax.tree.leaves(jdefs, is_leaf=is_param_def)]
        assert count_params(defs) == jax_count(jdefs)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def _qwen_batch(cfg, step=0):
    return SyntheticLMDataset(cfg.vocab_size, 32, 4, seed=step).batch(step)


def test_grad_accum_2_matches_reference(f32_compute):
    jcfg, cfg = (jax_get_config("qwen3-1.7b-smoke"),
                 get_config("qwen3-1.7b-smoke"))
    jparams, params = _both_params(jcfg, seed=3)
    b = _qwen_batch(cfg)
    jopt = JO.momentum(JO.constant(0.05), 0.9)
    jstep = jax.jit(jax_train_step(jcfg, jopt, f32_compute, grad_accum=2))
    jnew, _, jm = jstep(jparams, jopt.init(jparams), b)
    opt = O.momentum(O.constant(0.05), 0.9)
    step = DT.make_train_step(cfg, opt, grad_accum=2)
    params, _, m = step(params, opt.init(T.leaves(params)),
                        to_device(b, "cpu"))
    for k in ("loss", "grad_norm", "ce"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for path, p, jp in zip(T.paths(params), T.leaves(params),
                           jax.tree.leaves(jnew)):
        assert _max_err(p.detach(), jp) <= 1e-6, path


def test_grad_accum_1_is_the_step_without_it():
    cfg = get_config("qwen3-1.7b-smoke")
    _, base = _both_params(jax_get_config("qwen3-1.7b-smoke"), seed=4)
    b = to_device(_qwen_batch(cfg, 1), "cpu")
    runs = []
    for kw in ({}, {"grad_accum": 1}):
        params = T.tree_map(torch.clone, base)
        opt = O.momentum(O.constant(0.05), 0.9)
        params, _, m = DT.make_train_step(cfg, opt, **kw)(
            params, opt.init(T.leaves(params)), b)
        runs.append([m["loss"], m["grad_norm"]] + T.leaves(params))
    for x, y in zip(*runs):
        assert torch.equal(x.detach(), y.detach())


def test_worker_steps_accumulate_their_shards():
    """The elastic and async steps' workers each take the mean over 2
    microbatches of their own shard: bitwise ``mean_grads(shard, 2)``."""
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               make_async_train_step)
    from repro_torch.models.params import param_specs
    cfg = get_config("qwen3-1.7b-smoke")
    _, params = _both_params(jax_get_config("qwen3-1.7b-smoke"), seed=5)
    specs = param_specs(TF.model_defs(cfg))
    opt = O.momentum(O.constant(0.05), 0.9)
    b = to_device(_qwen_batch(cfg, 2), "cpu")
    shards = [{k: v[w * 2:(w + 1) * 2] for k, v in b.items()}
              for w in range(2)]
    want = [DT.mean_grads(cfg, params, s, 2) for s in shards]
    one = DT.mean_grads(cfg, params, shards[0])
    assert not torch.equal(T.leaves(one[2])[0], T.leaves(want[0][2])[0])
    steps = (DT.make_elastic_train_step(cfg, opt, SyncConfig(
        strategy="topk_ef"), 2, specs, grad_accum=2),
        make_async_train_step(cfg, opt, AsyncConfig(compressor="topk"), 2,
                              specs, grad_accum=2))
    for step in steps:
        got = list(step.worker_grads(params, b))
        assert len(got) == 2
        for (loss, grads), (wl, _, wg) in zip(got, want):
            assert torch.equal(loss, wl)
            for x, y in zip(T.leaves(grads), T.leaves(wg)):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the trainer's flags
# ---------------------------------------------------------------------------

def test_crash_subst_flag_reaches_async_config(monkeypatch):
    from repro_torch.dist import async_engine
    from repro_torch.launch import train
    seen = []
    make = async_engine.make_async_train_step

    def spy(cfg, opt, acfg, *args, **kw):
        seen.append(acfg)
        return make(cfg, opt, acfg, *args, **kw)

    monkeypatch.setattr(async_engine, "make_async_train_step", spy)
    argv = ["--device", "cpu", "--arch", "qwen3-1.7b-smoke", "--sync",
            "async", "--compressor", "topk", "--workers", "2",
            "--async-schedule", "crash", "--steps", "2", "--seq", "16",
            "--batch", "2"]
    for extra, want in (([], False), (["--crash-subst"], True)):
        history = train.main(argv + extra)
        assert seen[-1].crash_subst is want
        assert all(np.isfinite(r["loss"]) for r in history)


def test_log_every_prints_every_nth_step(capsys):
    from repro_torch.launch import train
    history = train.main(["--device", "cpu", "--arch", "qwen3-1.7b-smoke",
                          "--steps", "3", "--seq", "16", "--batch", "2",
                          "--log-every", "2"])
    assert [r["step"] for r in history] == [0, 1, 2]
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("step")]
    assert [int(l.split()[1]) for l in lines] == [0, 2]
    assert float(lines[1].split()[3]) == pytest.approx(history[2]["loss"],
                                                       abs=1e-6)
