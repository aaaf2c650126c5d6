"""The port's dense model against the JAX reference: the smoke config with
the reference's parameters carried over (``params_from_jax``) gives the
same loss and gradients.  Both compute in bf16, and the two frameworks
round bf16 at different places, so the loss is held within 2e-2 and every
gradient leaf within 2e-2 relative (Frobenius) error."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro.dist.train import mean_grads as jax_mean_grads  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.dist.train import mean_grads  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_jax)

TOL = 2e-2


@pytest.mark.parametrize("seq,batch,step", [(32, 2, 0), (48, 3, 1)])
def test_smoke_loss_and_grads_match_reference(seq, batch, step):
    jcfg, cfg = jax_get_config("qwen3-1.7b-smoke"), \
        get_config("qwen3-1.7b-smoke")
    jparams = jax_init_params(JTF.model_defs(jcfg), jax.random.PRNGKey(step))
    data = SyntheticLMDataset(jcfg.vocab_size, seq, batch, seed=step)
    b = data.batch(step)
    jloss, _, jgrads = jax.jit(
        lambda p, b: jax_mean_grads(jcfg, JTF.RunFlags(remat=False), p, b,
                                    1))(jparams, b)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    loss, parts, grads = mean_grads(cfg, params, to_device(b, "cpu"))
    assert abs(float(loss) - float(jloss)) < TOL
    assert float(parts["aux_loss"]) == 0.0
    for path, g, jg in zip(T.paths(grads), T.leaves(grads),
                           jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, path
        rel = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert rel <= TOL, (path, rel)


def test_layer_sinks_change_nothing_but_where_grads_land():
    """The forward with gradient sinks (the training path) gives the plain
    forward's logits bit for bit, and each sink holds what autograd
    computes for the stacked leaf."""
    cfg = get_config("qwen3-1.7b-smoke")
    params = init_params(TF.model_defs(cfg), torch.Generator().manual_seed(0))
    b = to_device(SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=0).batch(0),
                  "cpu")
    with torch.no_grad():
        plain, _ = TF.forward(cfg, params, b)
    flat = T.leaves(params["layers"])
    for p in flat:
        p.requires_grad_(True)
    sinks = T.tree_map(torch.zeros_like, params["layers"])
    logits, _ = TF.forward(cfg, params, b, sinks)
    assert torch.equal(logits.detach(), plain)
    want = torch.autograd.grad(TF.forward(cfg, params, b)[0].sum(), flat)
    logits.sum().backward()
    for p, s, w in zip(flat, T.leaves(sinks), want):
        p.requires_grad_(False)
        assert torch.equal(s, w)


def test_full_width_defs_have_the_stacked_leaves():
    """qwen3-1.7b: 13 leaves of 1.72 B parameters, each layer leaf stacked
    over the 28 layers (the compressors take one top-k per leaf)."""
    cfg = get_config("qwen3-1.7b")
    defs = TF.model_defs(cfg)
    shapes = {p: d.shape for p, d in zip(T.paths(defs), T.leaves(defs))}
    assert len(shapes) == 13
    assert shapes["layers/mlp/w_gate"] == (28, 2048, 6144)
    assert shapes["layers/attn/wk"] == (28, 2048, 8, 128)
    # the analytic param_count() leaves out the norm scales, as the
    # reference's does
    assert sum(int(np.prod(s)) for s in shapes.values()) == 1_720_574_976
