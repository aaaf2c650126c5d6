"""The port's host-side modules against the JAX reference: tau schedules,
delivery routing, the synthetic data stream and the configs (bitwise or
field-equal), plus the optimizer, parameter declarations and layers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import delivery as JD  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import param_specs as jax_param_specs  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import delivery as D  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import param_specs  # noqa: E402
from repro_torch.optim import apply_updates, constant, momentum, sgd  # noqa: E402


@pytest.mark.parametrize("schedule", D.TAU_SCHEDULES)
@pytest.mark.parametrize("p,T_,tau_max,seed", [(1, 7, 0, 0), (4, 50, 3, 5),
                                               (8, 33, 2, 11)])
def test_tau_schedules_bitwise(schedule, p, T_, tau_max, seed):
    want = JD.make_tau_schedule(schedule, p, T_, tau_max, seed)
    got = D.make_tau_schedule(schedule, p, T_, tau_max, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_tau_table_validation_matches_reference():
    good = D.make_tau_schedule("crash", 4, 20, 3, 1)
    np.testing.assert_array_equal(D.validate_tau_table(good, 3),
                                  JD.validate_tau_table(good, 3))
    for bad, tau_max in ((good, 2), (good.astype(float), 3), (good[0], 3)):
        with pytest.raises(ValueError):
            D.validate_tau_table(bad, tau_max)
        with pytest.raises(ValueError):
            JD.validate_tau_table(bad, tau_max)


@pytest.mark.parametrize("step", [0, 1, 5, 29])
def test_delivery_plan_matches_reference(step):
    taus = D.make_tau_schedule("crash", 4, 30, 2, 3)
    w, s = D.delivery_plan(taus, step, 3)
    jw, js = JD.delivery_plan(jnp.asarray(taus), step, 3)
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(s, np.asarray(js))


def test_ring_delivers_each_deposit_once_at_its_step():
    cap, steps = 3, 12
    taus = D.make_tau_schedule("uniform", 1, steps, cap - 1, 2)[:, 0]
    ring = D.ring_init(cap, (1,))
    got = []
    for t in range(steps):
        D.ring_deposit(ring, (t + int(taus[t])) % cap,
                       torch.tensor([float(2 ** t)]))
        got.append(D.ring_take(ring, t % cap)[0].item())
    want = [sum(2 ** s for s in range(steps) if s + taus[s] == t)
            for t in range(steps)]
    assert got == want


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (7, 1)])
def test_dataset_batches_bitwise(seed, step):
    want = JaxDataset(512, 24, 3, seed=seed).batch(step)
    got = SyntheticLMDataset(512, 24, 3, seed=seed).batch(step)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen3-1.7b-smoke"])
def test_configs_field_equal(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_get_config(name))
    assert get_config(name).param_count() == \
        jax_get_config(name).param_count()


def test_param_defs_and_specs_match_reference():
    cfg, jcfg = get_config("qwen3-1.7b"), jax_get_config("qwen3-1.7b")
    defs, jdefs = TF.model_defs(cfg), JTF.model_defs(jcfg)
    from repro.models.params import is_param_def
    jleaves = jax.tree.leaves(jdefs, is_leaf=is_param_def)
    assert len(T.leaves(defs)) == len(jleaves) == 13
    for d, jd in zip(T.leaves(defs), jleaves):
        assert (d.shape, d.axes, d.init, d.scale) == \
            (jd.shape, jd.axes, jd.init, jd.scale)
    for mesh_sizes in ({"data": 1, "model": 1}, {"data": 2, "model": 4}):
        want = jax.tree.leaves(jax_param_specs(jdefs, mesh_sizes),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))
        got = T.leaves(param_specs(defs, mesh_sizes))
        assert [tuple(w) + (None,) * (len(g) - len(tuple(w)))
                for w, g in zip(want, got)] == got


@pytest.mark.parametrize("name", ["momentum", "sgd"])
def test_optimizer_update_bitwise(name):
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2)]
    gs = [[rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2)]
          for _ in range(3)]
    jopt = jax_momentum(3e-3, 0.9) if name == "momentum" else jax_sgd(3e-3)
    jp = [jnp.asarray(x) for x in p0]
    js = jopt.init(jp)
    opt = (momentum(constant(3e-3), 0.9) if name == "momentum"
           else sgd(constant(3e-3)))
    tp = [torch.from_numpy(x.copy()) for x in p0]
    ts = opt.init(tp)
    for g in gs:
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        tupd, ts = opt.update([torch.from_numpy(x) for x in g], ts, tp)
        apply_updates(tp, tupd)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    pos = np.arange(6)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,chunk", [(0, 8), (0, 16), (5, 4)])
def test_gqa_attention_matches_reference(window, chunk):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    got = L.gqa_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                          chunk=chunk)
    want = JL.gqa_attention(*map(jnp.asarray, (q, k, v)), window=window,
                            chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
