"""Parity of the port's optimizers and schedules (`repro_torch.optim`) with
the JAX reference (`repro.optim`).

* Optimizers: the same numpy params and five steps of seeded numpy
  gradients through ``sgd``, ``momentum`` (with and without ``nesterov``),
  ``adam`` (with and without ``weight_decay``, and through
  ``warmup_cosine``) and ``clip_by_global_norm``.  Params, every state leaf
  and ``count`` are held to the reference's at rtol 1e-6, atol 1e-7: the
  arithmetic is the reference's in its order, and only ``sqrt``, ``**``
  and the order of the norm's sum may round differently from XLA's (on
  the CPU every case has been bitwise).
* Schedules: every schedule at steps 0 ... total + 2 (the warmup edge
  included) against the reference evaluated on an int32 step, at rtol
  1e-6: both compute in float32, and only ``np.cos`` against XLA's cosine
  may differ in the last bit (on the CPU, one step of the 100-step
  ``warmup_cosine`` has, by 6e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402

from repro_torch import optim as O  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
SCHED_RTOL = 1e-6
STEPS = 5
SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 3, 2)}


def _leaves(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    return [tree[k] for k in sorted(tree)]


def _close(port, ref, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _run_both(jopt, topt, clip=None):
    """Five steps of both; returns nothing, asserts every step."""
    rng = np.random.default_rng(0)
    p0 = _leaves(rng)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    tparams = [torch.tensor(v) for v in _flat(p0)]
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(STEPS):
        g = _leaves(rng)
        g = {k: v * np.float32(3.0 ** step) for k, v in g.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = [torch.tensor(v) for v in _flat(g)]
        if clip is not None:
            jg, jnorm = JO.clip_by_global_norm(jg, clip)
            tg, tnorm = O.clip_by_global_norm(tg, clip)
            _close(tnorm.numpy(), jnorm, f"norm step {step}")
        jup, jstate = jopt.update(jg, jstate, jparams)
        jparams = JO.apply_updates(jparams, jup)
        tup, tstate = topt.update(tg, tstate, tparams)
        O.apply_updates(tparams, tup)
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for key in ("mu", "m", "v"):
            if key in jstate:
                for i, (a, b) in enumerate(zip(tstate[key],
                                               _flat(jstate[key]))):
                    _close(a.numpy(), b, f"{key}[{i}] step {step}")
        for i, (a, b) in enumerate(zip(tparams, _flat(jparams))):
            _close(a.numpy(), b, f"param {i} step {step}")


SCHEDULE = dict(base=3e-2, warmup=2, total_steps=6, final_frac=0.1)

CASES = {
    "sgd": (lambda: JO.sgd(0.05), lambda: O.sgd(O.constant(0.05)), None),
    "momentum": (lambda: JO.momentum(0.05, 0.9),
                 lambda: O.momentum(O.constant(0.05), 0.9), None),
    "nesterov": (lambda: JO.momentum(0.05, 0.9, nesterov=True),
                 lambda: O.momentum(O.constant(0.05), 0.9, nesterov=True),
                 None),
    "adam": (lambda: JO.adam(1e-2), lambda: O.adam(O.constant(1e-2)), None),
    "adam_wd": (lambda: JO.adam(1e-2, weight_decay=0.01),
                lambda: O.adam(O.constant(1e-2), weight_decay=0.01), None),
    "adam_warmup_cosine": (
        lambda: JO.adam(JO.warmup_cosine(**SCHEDULE)),
        lambda: O.adam(O.warmup_cosine(**SCHEDULE)), None),
    "momentum_clipped": (lambda: JO.momentum(0.05, 0.9),
                         lambda: O.momentum(O.constant(0.05), 0.9), 2.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_reference(name):
    jmake, tmake, clip = CASES[name]
    _run_both(jmake(), tmake(), clip)


def test_clip_by_global_norm_leaves_small_gradients():
    g = [torch.tensor([0.3, -0.4])]
    out, norm = O.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(0.5)
    assert torch.equal(out[0], g[0])


SCHEDULES = {
    "constant": (lambda: JO.constant(3e-3), lambda: O.constant(3e-3), 4),
    "cosine_decay": (lambda: JO.cosine_decay(0.1, 7, 0.05),
                     lambda: O.cosine_decay(0.1, 7, 0.05), 7),
    "warmup_cosine": (lambda: JO.warmup_cosine(**SCHEDULE),
                      lambda: O.warmup_cosine(**SCHEDULE), 6),
    "warmup_cosine_long": (lambda: JO.warmup_cosine(1.0, 10, 100),
                           lambda: O.warmup_cosine(1.0, 10, 100), 100),
    "paper_nonconvex": (lambda: JO.paper_nonconvex_lr(400, 8),
                        lambda: O.paper_nonconvex_lr(400, 8), 4),
    "paper_strongly_convex": (
        lambda: JO.paper_strongly_convex_lr(600, 0.5, 8),
        lambda: O.paper_strongly_convex_lr(600, 0.5, 8), 4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    jmake, tmake, total = SCHEDULES[name]
    jfn, tfn = jmake(), tmake()
    for step in range(total + 3):
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        got = np.float32(tfn(step))
        np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0,
                                   err_msg=f"{name} at step {step}")
