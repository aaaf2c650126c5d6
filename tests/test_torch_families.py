"""The last four model families of the port against the JAX reference:
``moonshot-v1-16b-a3b`` (64 experts, top-6), ``grok-1-314b``, and the
vision (``internvl2-2b``) and audio (``musicgen-large``) frontend stubs;
``data/pipeline.py::synthetic_batch`` and the new ``configs`` members.
Parameters are drawn with numpy and carried across by ``params_from_jax``;
every batch is the reference's ``synthetic_batch`` (drawn with
``jax.random``, which torch cannot reproduce), fed to both packages.

* ``configs_match_reference`` for all ten configs and their smoke
  variants: every field, ``param_count``, ``active_param_count``,
  ``sub_quadratic``, ``layer_window_sizes``, the leaf shapes and
  ``count_params``.
* ``forward`` of the four smoke archs, batch 2 x 64 with the stubs'
  embeddings (largest logit about 5): f32 compute (both packages'
  ``COMPUTE_DTYPE`` patched), logits within ``F32_LOGITS`` = 1e-3, the
  bound ``test_torch_archs.py`` holds gemma3 and nemo to (read 8.3e-5 to
  1.4e-4), and the router aux loss within 1e-5 (read 0); bf16, logits
  within ``BF16_LOGITS`` = 0.3 (read 0.114 to 0.172, about the 0.157 nemo
  reads against its 0.25: the two frameworks round the bf16 products at
  other places) and aux within 2e-3 (read 5.9e-4 for grok-1, where a
  bf16 router logit can flip a top-2 pick).
* One ``make_train_step`` step with ``momentum(1e-3, 0.9)`` in f32
  compute, as ``tests/test_archs_smoke.py::test_one_train_step`` takes
  it: loss within 1e-5 and every parameter after the step within 2e-6
  (read at most 1.4e-6 and 6.1e-7).
* The two frontends' ``prefill`` of their stub batch plus 4 teacher-forced
  ``decode_step``s, f32 compute: logits within ``F32_LOGITS``; and
  ``launch/serve.main --engine loop --device cpu`` on each.
* moonshot's routing at its real 64 experts and top-6 (d cut to the
  smoke's 128): ``capacity`` (60 for training's 512-token group, 4 for a
  decode group of 4), ``route`` bitwise in its dispatch and within 1e-6 in
  its combine (absolute) and aux (relative: aux is scaled by E^2 = 4096),
  and ``moe_block`` within 1e-5 in f32 on a
  512-token group and a 4-token one.
* ``synthetic_batch``'s keys, shapes, dtypes and ranges for all ten archs
  against the reference's; the port's ``ARCH_IDS`` hold the reference's
  ten; ``launch/train.main(..., cfg=...)`` trains the given config.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.dist.train import make_train_step as jax_train_step  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import count_params as jax_count  # noqa: E402
from repro.models.params import is_param_def  # noqa: E402
from repro import optim as JO  # noqa: E402

from repro_torch import optim as O  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (count_params,  # noqa: E402
                                       params_from_jax)

FAMILIES = ("moonshot-v1-16b-a3b", "grok-1-314b", "internvl2-2b",
            "musicgen-large")
FRONTENDS = ("internvl2-2b", "musicgen-large")
B, S = 2, 64
F32_LOGITS, BF16_LOGITS = 1e-3, 0.3
F32_AUX, BF16_AUX = 1e-5, 2e-3


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


def _to_port(batch: dict) -> dict:
    """The reference's batch as the port's tensors: int64 token ids,
    float32 embeddings."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64 if a.dtype.kind == "i"
                                           else np.float32))
    return out


@pytest.fixture(scope="module")
def family():
    """Per smoke arch: both configs, both parameter trees (seed 0) and the
    reference's synthetic batch (seed 0)."""
    out = {}
    for name in FAMILIES:
        jcfg = jax_get_config(name + "-smoke")
        cfg = get_config(name + "-smoke")
        tree = _numpy_params(JTF.model_defs(jcfg), 0)
        jbatch = jax_synthetic_batch(jcfg, B, S, seed=0)
        out[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                     params_from_jax(tree), jbatch)
    return out


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JTF, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    return JTF.RunFlags(remat=False, kv_cache_dtype=jnp.float32)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_ARCH_IDS)
def test_configs_match_reference(name):
    for n in (name, name + "-smoke"):
        cfg, jcfg = get_config(n), jax_get_config(n)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        assert cfg.layer_window_sizes() == jcfg.layer_window_sizes()
        defs, jdefs = TF.model_defs(cfg), JTF.model_defs(jcfg)
        assert [d.shape for d in T.leaves(defs)] == \
            [d.shape for d in jax.tree.leaves(jdefs, is_leaf=is_param_def)]
        assert count_params(defs) == jax_count(jdefs)


def test_arch_ids_hold_the_reference_ten():
    assert set(JAX_ARCH_IDS) <= set(ARCH_IDS)
    assert len(JAX_ARCH_IDS) == 10
    for name in JAX_ARCH_IDS:
        assert get_config(name + "-smoke").n_layers == 2


def test_input_shapes_match_reference():
    from repro.configs import INPUT_SHAPES as JAX_SHAPES
    from repro_torch.configs import INPUT_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


# ---------------------------------------------------------------------------
# synthetic_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_ARCH_IDS)
def test_synthetic_batch_matches_reference_layout(name):
    cfg, jcfg = get_config(name + "-smoke"), jax_get_config(name + "-smoke")
    want = jax_synthetic_batch(jcfg, 3, 16, seed=5)
    got = synthetic_batch(cfg, 3, 16, seed=5)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert tuple(v.shape) == w.shape, k
        assert str(v.dtype).split(".")[-1] == str(w.dtype), k
    for k in ("tokens", "labels"):
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
        assert int(got[k].max()) > 0
    for k in ("frame_embeds", "patch_embeds"):
        if k in got:
            assert 0.01 < float(got[k].std()) < 0.03
    again = synthetic_batch(cfg, 3, 16, seed=5)
    other = synthetic_batch(cfg, 3, 16, seed=6)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["tokens"], other["tokens"])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(family, name, dtype, request):
    flags = (request.getfixturevalue("f32_compute") if dtype == "float32"
             else JTF.RunFlags(remat=False))
    jcfg, cfg, jparams, params, jbatch = family[name]
    want, jaux = jax.jit(lambda p, b: JTF.forward(jcfg, p, b, flags))(
        jparams, jbatch)
    with torch.no_grad():
        got, aux = TF.forward(cfg, params, _to_port(jbatch))
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    assert got.dtype == torch.float32
    tol, aux_tol = ((F32_LOGITS, F32_AUX) if dtype == "float32"
                    else (BF16_LOGITS, BF16_AUX))
    assert _max_err(got, want) <= tol, (name, dtype, _max_err(got, want))
    assert abs(float(aux) - float(jaux)) <= aux_tol


def test_frontend_stubs_reach_the_stack(family):
    """A vision batch's patch embeddings replace the first n_prefix_embeds
    positions only; an audio batch's frame embeddings replace every token
    embedding; without them both embed their tokens."""
    for name in FRONTENDS:
        _, cfg, _, params, jbatch = family[name]
        batch = _to_port(jbatch)
        tokens_only = TF.embed_input(cfg, params, {"tokens":
                                                   batch["tokens"]})
        x = TF.embed_input(cfg, params, batch)
        assert x.dtype == TF.COMPUTE_DTYPE
        if cfg.frontend == "vision":
            p = cfg.n_prefix_embeds
            assert torch.equal(x[:, :p], batch["patch_embeds"].to(x.dtype))
            assert torch.equal(x[:, p:], tokens_only[:, p:])
        else:
            assert torch.equal(x, batch["frame_embeds"].to(x.dtype))


@pytest.mark.parametrize("name", FAMILIES)
def test_one_train_step_matches_reference(family, name, f32_compute):
    jcfg, cfg, jparams, params, jbatch = family[name]
    jopt = JO.momentum(1e-3, 0.9)
    jnew, _, jm = jax.jit(jax_train_step(jcfg, jopt, f32_compute))(
        jparams, jopt.init(jparams), jbatch)
    opt = O.momentum(O.constant(1e-3), 0.9)
    tparams = T.tree_map(torch.clone, params)
    tparams, _, m = DT.make_train_step(cfg, opt)(
        tparams, opt.init(T.leaves(tparams)), _to_port(jbatch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    moved = 0.0
    for path, p, jp, p0 in zip(T.paths(tparams), T.leaves(tparams),
                               jax.tree.leaves(jnew), T.leaves(params)):
        assert _max_err(p.detach(), jp) <= 2e-6, path
        moved += float((p.detach() - p0).abs().sum())
    assert moved > 0


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_prefill_decode_match_reference(family, name, f32_compute):
    jcfg, cfg, jparams, params, jbatch = family[name]
    prompt = {k: v for k, v in jbatch.items() if k != "labels"}
    feed = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, B, 1)).astype(np.int32)
    max_len = S + len(feed)
    lg, cache = jax.jit(lambda p, b: JTF.prefill(
        jcfg, p, b, max_len, f32_compute))(jparams, prompt)
    want = [lg]
    decode = jax.jit(lambda p, c, t: JTF.decode_step(jcfg, p, c, t,
                                                     f32_compute))
    for f in feed:
        lg, cache = decode(jparams, cache, f)
        want.append(lg)
    with torch.no_grad():
        lg, tcache = TF.prefill(cfg, params, _to_port(prompt), max_len)
        got = [lg]
        for f in feed:
            lg, tcache = TF.decode_step(cfg, params, tcache,
                                        torch.from_numpy(f))
            got.append(lg)
    assert tcache["pos"] == max_len
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (B, 1, cfg.vocab_size)
        assert _max_err(g, w) <= F32_LOGITS, (name, i, _max_err(g, w))


@pytest.mark.parametrize("name", FRONTENDS)
def test_launcher_serves_frontend_through_the_loop(name):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", name + "-smoke",
                      "--engine", "loop", "--prompt-len", "16", "--gen", "3",
                      "--batch", "2"])
    vocab = get_config(name + "-smoke").vocab_size
    assert [len(t) for t in out["tokens"]] == [3, 3]
    assert all(0 <= int(v) < vocab for t in out["tokens"] for v in t)
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--arch", name + "-smoke",
                    "--engine", "continuous", "--gen", "2"])


# ---------------------------------------------------------------------------
# moonshot's routing at 64 experts, top-6
# ---------------------------------------------------------------------------

def _moonshot_routing_cfgs():
    repl = dict(n_experts=64, experts_per_token=6)
    return tuple(dataclasses.replace(get("moonshot-v1-16b-a3b-smoke"),
                                     **repl)
                 for get in (jax_get_config, get_config))


def test_capacity_at_64_experts_top6():
    for args, want in (((512, 6, 64, 1.25), 60), ((4, 6, 64, 1.25), 4)):
        assert MOE.capacity(*args) == JMOE.capacity(*args) == want


@pytest.mark.parametrize("tokens", [512, 4])
def test_moe_at_64_experts_top6_matches_reference(tokens):
    jcfg, cfg = _moonshot_routing_cfgs()
    rng = np.random.default_rng(tokens)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    cap = MOE.capacity(tokens, 6, e, cfg.capacity_factor)
    lg = rng.standard_normal((1, tokens, e)).astype(np.float32)
    jd, jc, ja = jax.jit(JMOE.route, static_argnums=(1, 2))(
        jnp.asarray(lg), 6, cap)
    dsp, comb, aux = MOE.route(torch.from_numpy(lg), 6, cap)
    assert tuple(dsp.shape) == (1, tokens, e, cap)
    np.testing.assert_array_equal(dsp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    # aux = mean(me * ce) * E^2: at E = 64 its rounding is scaled by 4096
    assert float(aux) == pytest.approx(float(ja), rel=1e-6, abs=1e-6)
    jparams = {
        "router": rng.standard_normal((d, e)) * d ** -0.5,
        "w_gate": rng.standard_normal((e, d, ff)) * d ** -0.5,
        "w_up": rng.standard_normal((e, d, ff)) * d ** -0.5,
        "w_down": rng.standard_normal((e, ff, d)) * ff ** -0.5,
    }
    jparams = {k: v.astype(np.float32) for k, v in jparams.items()}
    x = rng.standard_normal((1, tokens, d)).astype(np.float32)
    want, jaux = jax.jit(JMOE.moe_block, static_argnums=(1,))(
        jparams, jcfg, jnp.asarray(x))
    got, taux = MOE.moe_block(params_from_jax(jparams), cfg,
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-5


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_train_main_takes_a_config(monkeypatch):
    """``cfg`` overrides ``--arch``: grok-1's smoke variant cut to 1 layer
    trains 2 async top-k steps on the CPU, with --arch naming another."""
    from repro_torch.launch import train
    seen = []
    defs = TF.model_defs
    monkeypatch.setattr(TF, "model_defs",
                        lambda c: seen.append(c) or defs(c))
    cfg = dataclasses.replace(get_config("grok-1-314b-smoke"), n_layers=1)
    history = train.main(["--device", "cpu", "--arch", "qwen3-1.7b-smoke",
                          "--sync", "async", "--compressor", "topk",
                          "--workers", "2", "--steps", "2", "--seq", "16",
                          "--batch", "4"], cfg=cfg)
    assert seen and all(c is cfg for c in seen)
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) for r in history)
