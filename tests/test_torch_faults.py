"""The port's fault runtime (`repro_torch.faults`), its skip-step guard,
the faulted serve launcher and the supervisor, on the CPU, against the
JAX reference (`repro.faults`, `repro.dist.train`).

Tolerances: none is loosened below bitwise.

* Plans: ``FaultEvent`` validation as the reference's; the JSON text of
  hand-written plans, of ``FaultPlan.random(seed)`` and of the authoring
  CLI equal to the reference's byte for byte; ``apply_to_taus`` equal to
  the reference's on seeded tau tables.
* Injectors: the train injector's scale, checkpoint-IO and kill gating;
  the serve injector's page holds and poisoning through the port's
  scheduler over a fake engine.
* The skip-step guard: ``guarded_update`` on a poisoned gradient leaves
  params and the whole optimizer state (``count``, ``mu``, ``m``, ``v``)
  as the reference's leaves them, bitwise, and the next step's
  ``warmup_cosine`` rate and params match the reference's (bitwise on the
  CPU; the parent commit's guard advanced ``count``).  The guarded exact
  and async steps with a neutral scale are bitwise the unguarded ones; a
  poisoned step leaves the state as the reference's step does.
* ``launch.serve --engine continuous --fault-plan`` against the
  reference's launcher (``repro.launch.serve.main``) on the same argv,
  plan and weights, its engine's CPU race closed (``_SyncStepEngine``):
  the same clock, quarantines and failures, and at the small shapes the
  same tokens, bitwise; on ``chip_smoke.py`` phase 35's schedule, the
  quarantine count that phase requires.  Every request served, no page
  leaked, tokens equal to the fault-free run's.
* ``launch.train`` with a ``ckpt_io`` event: the failed save is printed
  and training goes on.
* ``launch.supervisor`` over a ``launch.train`` child cut to one layer
  (``--n-layers 1``) and killed at step 5 (checkpoints every 2 of 8
  steps): the printed losses equal its ``--fault-attempt 1`` oracle's,
  step for step; ``--n-layers`` beyond the arch's depth is refused.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JCONFIGS  # noqa: E402
import repro.launch.serve as JSERVE_LAUNCH  # noqa: E402
import repro.models.params as JPARAMS  # noqa: E402
import repro.serve as JSERVE  # noqa: E402
import repro.serve.engine as JENG  # noqa: E402
from repro import faults as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import delivery as JDLV  # noqa: E402
from repro.dist import train as JDT  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.faults import plan as jax_plan_mod  # noqa: E402

from repro_torch import optim as O  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import delivery as DLV  # noqa: E402
from repro_torch.core.delivery import DROPPED  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset, to_device  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state,
                                           make_async_train_step)
from repro_torch.faults import (FAULT_KINDS, FaultEvent, FaultPlan,  # noqa: E402
                                ServeFaultInjector, TrainFaultInjector)
from repro_torch.faults import plan as plan_mod  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       init_serving_params, param_specs)
from repro_torch.serve import (ContinuousScheduler, PageAllocator,  # noqa: E402
                               PagedCacheConfig, Request)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the plan DSL against the reference
# ---------------------------------------------------------------------------

def test_fault_event_validation():
    for bad in (dict(step=0, kind="meteor"), dict(step=-1, kind="kill"),
                dict(step=0, kind="crash", duration=-2)):
        with pytest.raises(ValueError):
            FaultEvent(**bad)
        with pytest.raises(ValueError):
            JF.FaultEvent(**bad)
    assert FAULT_KINDS == JF.FAULT_KINDS
    assert FaultEvent(step=0, kind="crash", duration=0).duration == 0


HAND_PLAN = [dict(step=2, kind="kill", on_attempt=1),
             dict(step=1, kind="grad_poison", param=1.0),
             dict(step=3, kind="ckpt_io"),
             dict(step=1, kind="crash", worker=1, duration=1),
             dict(step=5, kind="rejoin", worker=0),
             dict(step=4, kind="logit_poison"),
             dict(step=6, kind="page_exhaust", param=16.0, duration=3)]


def test_plan_json_is_the_reference_text(tmp_path):
    port = FaultPlan(events=tuple(HAND_PLAN), seed=3)
    ref = JF.FaultPlan(events=tuple(HAND_PLAN), seed=3)
    assert port.to_json() == ref.to_json()
    assert FaultPlan.from_json(ref.to_json()) == port
    assert FaultPlan.load(port.save(str(tmp_path / "p.json"))) == port
    assert FaultPlan.load(port.to_json()) == port
    assert port.kinds() == ref.kinds() and port.max_step == ref.max_step
    assert port.has_poison and port.has_tau_events
    assert [e.kind for e in port.at(1)] == ["grad_poison", "crash"]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_plan_draws_the_reference_events(seed):
    kw = dict(steps=40, workers=3, n_events=6, tau_max=2)
    assert FaultPlan.random(seed, **kw).to_json() == \
        JF.FaultPlan.random(seed, **kw).to_json()
    serve_kinds = ("logit_poison", "page_exhaust", "kill")
    assert FaultPlan.random(seed, 12, 2, kinds=serve_kinds).to_json() == \
        JF.FaultPlan.random(seed, 12, 2, kinds=serve_kinds).to_json()


CLI = ["--kill-at", "6", "--kill-attempt", "1", "--poison-at", "3",
       "--poison-at", "9", "--ckpt-io-at", "8", "--crash", "1@4:0",
       "--rejoin", "1@9", "--delay", "0@2:3", "--drop", "2@5:2",
       "--seed", "11"]


def test_cli_prints_and_writes_the_reference_text(tmp_path, capsys,
                                                  monkeypatch):
    outs = []
    for mod in (plan_mod, jax_plan_mod):
        monkeypatch.setattr(sys, "argv", ["plan", *CLI])
        mod._main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("{")
    files = []
    for i, mod in enumerate((plan_mod, jax_plan_mod)):
        path = tmp_path / f"p{i}.json"
        monkeypatch.setattr(sys, "argv", ["plan", "--out", str(path), *CLI])
        mod._main()
        assert capsys.readouterr().out == \
            f"wrote 8 events to {path}\n"
        files.append(path.read_bytes())
    assert files[0] == files[1]


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_apply_to_taus_matches_reference(seed):
    taus = DLV.make_tau_schedule("uniform", 4, 30, 3, seed)
    ref_taus = JDLV.make_tau_schedule("uniform", 4, 30, 3, seed)
    np.testing.assert_array_equal(taus, ref_taus)
    kw = dict(steps=30, workers=4, n_events=8, tau_max=3)
    got = FaultPlan.random(seed, **kw).apply_to_taus(taus, 3)
    want = JF.FaultPlan.random(seed, **kw).apply_to_taus(ref_taus, 3)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    live = got[got != DROPPED]
    assert live.size == 0 or (live.min() >= 0 and live.max() <= 3)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------

def test_train_injector_scale_ckpt_io_and_kill_gating():
    plan = FaultPlan(events=(
        FaultEvent(step=2, kind="grad_poison"),
        FaultEvent(step=4, kind="grad_poison", param=1.0),
        FaultEvent(step=8, kind="ckpt_io"),
        FaultEvent(step=5, kind="kill", on_attempt=1)))
    inj = TrainFaultInjector(plan, attempt=0)
    assert inj.has_poison
    assert inj.loss_scale(0) == 1.0 and inj.loss_scale(3) == 1.0
    assert np.isnan(inj.loss_scale(2)) and np.isposinf(inj.loss_scale(4))
    assert inj.poisoned_steps == 2
    inj.check_ckpt_io(4)
    with pytest.raises(OSError, match="step 8"):
        inj.check_ckpt_io(8)
    assert inj.ckpt_errors == 1
    inj.maybe_kill(5)        # scheduled for attempt 1: must not fire here


class FakeEngine:
    """The scheduler's engine surface plus the quarantine verbs over the
    port's real page allocator; poison lives with the request's pages."""

    def __init__(self, pcfg):
        self.pcfg = pcfg
        self.alloc = PageAllocator(pcfg)
        self.active = np.zeros(pcfg.max_requests, bool)
        self._slot_of = {}
        self.steps = 0
        self.poisoned = set()

    def has_slot(self):
        return int(self.active.sum()) < self.pcfg.max_requests

    def can_admit(self, prompt_len, max_new):
        return self.has_slot() and self.alloc.can_alloc(
            self.pcfg.pages_needed(prompt_len + max_new))

    def start(self, rid, prompt, max_new):
        assert self.alloc.alloc(rid, self.pcfg.pages_needed(
            len(prompt) + max_new)) is not None
        slot = int(np.flatnonzero(~self.active)[0])
        self.active[slot] = True
        self._slot_of[rid] = slot
        return torch.tensor([9000 + rid])

    def step(self):
        self.steps += 1
        return torch.arange(self.pcfg.max_requests) * 1000 + self.steps

    def nonfinite_rids(self):
        return [r for r in sorted(self.poisoned) if r in self._slot_of]

    def poison_kv(self, rid):
        self.poisoned.add(rid)

    def finish(self, rid):
        slot = self._slot_of.pop(rid)
        self.alloc.free(rid)
        self.active[slot] = False
        self.poisoned.discard(rid)

    def slot_of(self, rid):
        return self._slot_of[rid]


def _pcfg():
    return PagedCacheConfig(page_size=4, num_pages=4, max_requests=2,
                            max_pages_per_seq=2)


def test_serve_injector_page_exhaust_backpressure():
    engine = FakeEngine(_pcfg())
    inj = ServeFaultInjector(FaultPlan(events=(
        FaultEvent(step=0, kind="page_exhaust", duration=3),)), engine)
    sched = ContinuousScheduler(engine, on_tick=inj.on_tick)
    toks = sched.run([Request(rid=0, prompt=np.zeros(2, np.int32),
                              max_new=2, arrival=0)])
    assert inj.exhausted == 1 and len(toks[0]) == 2
    assert sched.completions[0].admitted >= 3
    inj.release_all()
    engine.alloc.check()
    assert engine.alloc.n_free == engine.pcfg.num_pages


def test_serve_injector_partial_hold_and_poison():
    engine = FakeEngine(_pcfg())
    inj = ServeFaultInjector(FaultPlan(events=(
        FaultEvent(step=0, kind="page_exhaust", duration=2, param=3.0),)),
        engine)
    sched = ContinuousScheduler(engine, on_tick=inj.on_tick)
    sched.step()
    assert engine.alloc.n_free == 1
    sched.step()
    sched.step()
    assert engine.alloc.n_free == 4
    inj.release_all()

    engine = FakeEngine(_pcfg())
    inj = ServeFaultInjector(FaultPlan(events=(
        FaultEvent(step=1, kind="logit_poison"),)), engine)
    sched = ContinuousScheduler(engine, quarantine=True, on_tick=inj.on_tick)
    toks = sched.run([Request(rid=i, prompt=np.zeros(2, np.int32),
                              max_new=3, arrival=0) for i in range(2)])
    assert inj.poisoned == 1
    assert sched.quarantined == 1 and sched.failed == 0
    assert sorted(toks) == [0, 1]
    inj.release_all()
    engine.alloc.check()


# ---------------------------------------------------------------------------
# the skip-step guard: the repaired fault
# ---------------------------------------------------------------------------

SHAPES = {"a": (3, 4), "b": (5,)}
SCHEDULE = dict(base=3e-2, warmup=2, total_steps=6)


def _np_leaves(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["momentum", "adam_warmup_cosine"])
def test_guarded_update_leaves_whole_state_as_reference(name):
    """A poisoned step keeps params, ``count`` and every moment leaf as
    they were (the reference's ``jnp.where`` over all of ``new_opt``);
    the next step then reads the schedule at the same count as the
    reference.  The parent commit's guard returned ``count`` 1 here."""
    if name == "momentum":
        jopt, topt = JO.momentum(0.05, 0.9), O.momentum(O.constant(0.05),
                                                         0.9)
    else:
        jopt = JO.adam(JO.warmup_cosine(**SCHEDULE))
        topt = O.adam(O.warmup_cosine(**SCHEDULE))
    p0 = _np_leaves(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = [torch.tensor(p0[k]) for k in sorted(p0)]
    js, ts = jopt.init(jp), topt.init(tp)
    grads = [_np_leaves(1), _np_leaves(2), _np_leaves(3)]
    grads[1]["a"][1, 2] = np.nan          # the poisoned step
    for i, g in enumerate(grads):
        jp, js, jbad = JDT.guarded_update(
            jopt, {k: jnp.asarray(v) for k, v in g.items()}, js, jp,
            skip_nonfinite=True)
        tp, ts, tbad = DT.guarded_update(
            topt, [torch.tensor(g[k]) for k in sorted(g)], ts, tp,
            skip_nonfinite=True)
        assert float(tbad) == float(jbad) == (1.0 if i == 1 else 0.0)
        assert ts["count"] == int(js["count"]) == (1 if i == 0 else i), \
            f"count after step {i}"
        for key in ("mu", "m", "v"):
            if key in js:
                for a, k in zip(ts[key], sorted(SHAPES)):
                    np.testing.assert_array_equal(
                        a.numpy(), np.asarray(js[key][k]),
                        err_msg=f"{key}/{k} after step {i}")
        for a, k in zip(tp, sorted(SHAPES)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(jp[k]),
                                          err_msg=f"param {k} step {i}")


def test_guarded_update_keeps_no_copy_of_the_params(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.Tensor, "clone",
                        lambda self, *a, **k: calls.append(1))
    params = [torch.ones(4)]
    opt = O.momentum(O.constant(0.1), 0.9)
    state = opt.init(params)
    DT.guarded_update(opt, [torch.full((4,), float("nan"))], state, params,
                      skip_nonfinite=True)
    DT.guarded_update(opt, [torch.ones(4)], state, params,
                      skip_nonfinite=True)
    assert not calls


ARCH = "qwen3-1.7b-smoke"


@pytest.fixture(scope="module")
def tiny():
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticLMDataset as JData
    from repro.models import transformer as JTF
    from repro.models.params import init_params as jax_init_params

    from repro_torch.models.params import params_from_jax

    jcfg = jax_get_config(ARCH)
    jparams = jax_init_params(JTF.model_defs(jcfg), jax.random.PRNGKey(0))
    tparams_np = jax.tree.map(np.asarray, jparams)
    data = SyntheticLMDataset(get_config(ARCH).vocab_size, 32, 4, seed=0)
    jdata = JData(jcfg.vocab_size, 32, 4, seed=0)
    return jcfg, jparams, tparams_np, params_from_jax, data, jdata


def _scaled(batch, scale):
    out = to_device(batch, "cpu")
    out["loss_scale"] = torch.full((4,), scale, dtype=torch.float32)
    return out


def test_guarded_exact_step_neutral_and_poisoned(tiny):
    from repro.models import transformer as JTF

    jcfg, jparams, np_params, from_jax, data, jdata = tiny
    cfg = get_config(ARCH)
    opt = O.momentum(O.constant(1e-2), 0.9)
    plain = DT.make_train_step(cfg, opt)
    guarded = DT.make_train_step(cfg, opt, skip_nonfinite=True)
    pa, pb = from_jax(np_params), from_jax(np_params)
    sa = opt.init(T.leaves(pa))
    sb = opt.init(T.leaves(pb))
    _, sa, ma = plain(pa, sa, to_device(data.batch(0), "cpu"))
    _, sb, mb = guarded(pb, sb, _scaled(data.batch(0), 1.0))
    assert float(mb["nonfinite"]) == 0.0
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(T.leaves(pa) + sa["mu"], T.leaves(pb) + sb["mu"]):
        assert torch.equal(x, y)
    assert sa["count"] == sb["count"] == 1

    # a poisoned step from there: the port and the reference both keep
    # params, count and mu as they were
    before = [x.clone() for x in T.leaves(pb) + sb["mu"]]
    _, sc, mc = guarded(pb, sb, _scaled(data.batch(1), float("nan")))
    assert float(mc["nonfinite"]) == 1.0
    assert not np.isfinite(float(mc["loss"]))
    assert sc["count"] == 1
    for x, y in zip(before, T.leaves(pb) + sc["mu"]):
        assert torch.equal(x, y)
    jopt = JO.momentum(1e-2, 0.9)
    jstep = jax.jit(JDT.make_train_step(jcfg, jopt, JTF.RunFlags(
        remat=False), skip_nonfinite=True))
    js = jopt.init(jparams)
    jb = dict(jdata.batch(1), loss_scale=np.full((4,), np.nan, np.float32))
    jp1, js1, jm = jstep(jparams, js, jb)
    assert float(jm["nonfinite"]) == 1.0 and int(js1["count"]) == 0
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(jp1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_guarded_async_step_neutral_and_poisoned(tiny):
    """p = 1, tau_max 1, top-k with EF.  Neutral scale: bitwise the
    unguarded engine.  A poisoned first step transmits zeros: params, EF
    residual and rings stay zero-moved, ``count`` advances (the delivered
    mean is finite), as the reference's engine does."""
    from repro.dist import async_engine as JAE
    from repro.dist import sharding as SH
    from repro.jax_compat import make_mesh
    from repro.models import transformer as JTF
    from repro.models.params import param_specs as jax_param_specs

    jcfg, jparams, np_params, from_jax, data, jdata = tiny
    cfg = get_config(ARCH)
    specs = param_specs(TF.model_defs(cfg))
    opt = O.momentum(O.constant(1e-2), 0.9)
    kw = dict(tau_max=1, compressor="topk", topk_ratio=1 / 8)
    runs = []
    for guard in (False, True):
        acfg = AsyncConfig(skip_nonfinite=guard, **kw)
        params = from_jax(np_params)
        ost = opt.init(T.leaves(params))
        st = init_async_state(acfg, 1, params, specs)
        step = make_async_train_step(cfg, opt, acfg, 1, specs)
        for t in range(2):
            batch = (_scaled(data.batch(t), 1.0) if guard
                     else to_device(data.batch(t), "cpu"))
            params, ost, st, m = step(params, ost, st, batch)
        runs.append((params, ost, st, m))
    (pa, oa, sa, _), (pb, ob, sb, mb) = runs
    assert float(mb["nonfinite"]) == 0.0
    for x, y in zip(T.leaves(pa) + oa["mu"] + T.leaves(sa["err"])
                    + T.leaves(sa["acc"]),
                    T.leaves(pb) + ob["mu"] + T.leaves(sb["err"])
                    + T.leaves(sb["acc"])):
        assert torch.equal(x, y)

    acfg = AsyncConfig(skip_nonfinite=True, **kw)
    params = from_jax(np_params)
    ost = opt.init(T.leaves(params))
    st = init_async_state(acfg, 1, params, specs)
    step = make_async_train_step(cfg, opt, acfg, 1, specs)
    params, ost, st, m = step(params, ost, st,
                              _scaled(data.batch(0), float("nan")))
    assert float(m["nonfinite"]) == 1.0

    mesh = make_mesh((1, 1), ("data", "model"))
    jdefs = JTF.model_defs(jcfg)
    jacfg = JAE.AsyncConfig(axis_names=("data",), skip_nonfinite=True, **kw)
    jstate = JAE.init_async_state(
        jacfg, mesh, jparams, jax_param_specs(jdefs, SH.axis_sizes(mesh)))
    jopt = JO.momentum(1e-2, 0.9)
    jstep = jax.jit(JAE.make_async_train_step(
        jcfg, jopt, mesh, jacfg, jax_param_specs(jdefs, SH.axis_sizes(mesh)),
        JTF.RunFlags(remat=False)))
    jb = dict(jdata.batch(0), loss_scale=np.full((4,), np.nan, np.float32))
    jp, jo, js, jm = jstep(jparams, jopt.init(jparams), jstate, jb)
    assert float(jm["nonfinite"]) == 1.0
    assert ost["count"] == int(jo["count"]) == 1
    assert st["step"] == int(js["step"]) == 1
    for x, y in zip(T.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(y))
    for x, y in zip(ost["mu"], jax.tree.leaves(jo["mu"])):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for key in ("err", "acc"):
        for x, y in zip(T.leaves(st[key]), jax.tree.leaves(js[key])):
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(y).reshape(x.shape))


def test_poison_plan_refuses_other_syncs():
    plan = json.dumps({"events": [{"step": 1, "kind": "grad_poison"}]})
    with pytest.raises(SystemExit, match="skip-step guard"):
        train.main(["--device", "cpu", "--sync", "topk_ef", "--steps", "1",
                    "--fault-plan", plan])


# ---------------------------------------------------------------------------
# the faulted serve launcher
# ---------------------------------------------------------------------------

SERVE = ["--engine", "continuous", "--prompt-lens", "45,16,30,8", "--gen",
         "8", "--batch", "2", "--page-size", "8"]
SERVE_PLAN = json.dumps({"events": [
    {"step": 4, "kind": "logit_poison"},
    {"step": 6, "kind": "page_exhaust", "param": 4.0, "duration": 3}]})
SUMMARY = re.compile(r"^continuous: \d+ requests in (\d+) steps, .*"
                     r"quarantined=(\d+) failed=(\d+)$", re.M)


def _chip_smoke():
    """``chip_smoke.py``'s constants (it imports nothing but the standard
    library at module level), so phase 35's schedule is the one held here."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SyncStepEngine(JENG.StepEngine):
    """The reference's engine with its CPU race closed (``ROADMAP.md``,
    queue 3): ``step`` uploads ``pos``, ``table`` and ``active`` with
    ``jnp.asarray``, which may alias the numpy arrays it then changes in
    place while the decode may still read them.  Here each upload is of a
    copy and every call is waited for; the arithmetic is the reference's."""

    def start(self, rid, prompt, max_new):
        tok = super().start(rid, prompt, max_new)
        jax.block_until_ready((tok, self.k_pool, self.v_pool, self.tokens))
        return tok

    def step(self):
        if self._dirty:
            self._d_pos = jnp.asarray(self.pos.copy())
            self._d_table = jnp.asarray(self.table.copy())
            self._d_active = jnp.asarray(self.active.copy())
            self._dirty = False
        toks = super().step()
        jax.block_until_ready((toks, self.k_pool, self.v_pool, self._d_pos,
                               self._finite))
        return toks


def _reference_serve(monkeypatch, capsys, arch, changes, argv):
    """``repro.launch.serve.main`` on ``argv`` (its own parser, so no
    ``--device``) over ``_SyncStepEngine``, with ``arch``'s config under
    ``changes`` and the port launcher's weights (``init_serving_params``
    from seed 0, as float32 numpy); returns (tokens, clock, quarantined,
    failed) as it prints them."""
    cfg = dataclasses.replace(get_config(arch), **changes)
    jcfg = dataclasses.replace(jax_get_config(arch), **changes)
    params = init_serving_params(TF.model_defs(cfg),
                                 torch.Generator().manual_seed(0))
    jparams = T.tree_map(lambda t: t.float().numpy(), params)
    monkeypatch.setattr(JSERVE, "StepEngine", _SyncStepEngine)
    monkeypatch.setattr(JCONFIGS, "get_config", lambda name: jcfg)
    monkeypatch.setattr(JPARAMS, "init_params", lambda defs, key: jparams)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    toks = JSERVE_LAUNCH.main()
    clock, quarantined, failed = map(
        int, SUMMARY.search(capsys.readouterr().out).groups())
    return [list(map(int, t)) for t in toks], clock, quarantined, failed


def _port_serve(capsys, cfg, argv):
    capsys.readouterr()
    out = serve.main(["--device", "cpu", *argv], cfg=cfg)
    clock, quarantined, failed = map(
        int, SUMMARY.search(capsys.readouterr().out).groups())
    sched = out["scheduler"]
    assert (sched.clock, sched.quarantined, sched.failed) == \
        (clock, quarantined, failed)
    return out, [list(map(int, t)) for t in out["tokens"]]


def _check_recovered(out, clean):
    engine = out["engine"]
    assert engine.check_finite
    engine.alloc.check()
    assert engine.alloc.n_free == engine.pcfg.num_pages
    assert [list(map(int, t)) for t in out["tokens"]] == \
        [list(map(int, t)) for t in clean["tokens"]]


# the expected counts are the reference's on this plan: qwen3 quarantines
# the poisoned request alone; mixtral's dense MoE dispatch product spreads
# its NaN into every token of its group (both live requests), whose pages
# then hold NaN values that the next two requests admitted into them read
# under zero attention weights (0 * NaN): 4 quarantines, none twice
@pytest.mark.parametrize("arch,quarantined", [
    ("qwen3-1.7b-smoke", 1), ("mixtral-8x7b-smoke", 4)])
def test_serve_fault_plan_quarantines_and_recovers(arch, quarantined,
                                                   monkeypatch, capsys):
    """The port's faulted launcher against the reference's on the same
    argv, plan and weights: the same clock, quarantines, failures and
    tokens (bitwise at these lengths); every request served, no page
    leaked, the tokens the fault-free run's."""
    cfg = get_config(arch)
    argv = ["--arch", arch, *SERVE, "--fault-plan", SERVE_PLAN]
    ref = _reference_serve(monkeypatch, capsys, arch, {}, argv)
    clean = serve.main(["--device", "cpu", "--arch", arch, *SERVE])
    out, toks = _port_serve(capsys, cfg, argv)
    sched = out["scheduler"]
    assert (toks, sched.clock, sched.quarantined, sched.failed) == ref
    assert sched.quarantined == quarantined and sched.failed == 0
    _check_recovered(out, clean)


def test_serve_fault_plan_card_schedule_matches_reference(monkeypatch,
                                                          capsys):
    """``chip_smoke.py`` phase 35's schedule (its prompts, slots, pages and
    plan) on mixtral-8x7b-smoke with the full model's window and experts,
    at one layer: the port's clock, quarantines and failures are the
    reference's, and the quarantines are the ``FAULT_SERVE_QUARANTINED``
    that phase 35 requires on the card.  They follow from the schedule, the
    window and the dense dispatch, not from width or depth: ``poison_kv``
    writes NaN at every layer.  Tokens are held against the port's
    fault-free run only: at prompts of 4,600 tokens the two frameworks'
    bf16 sums, taken in other orders, break argmax near-ties apart."""
    cs = _chip_smoke()
    full = get_config("mixtral-8x7b")
    arch, changes = "mixtral-8x7b-smoke", dict(
        n_layers=1, sliding_window=full.sliding_window,
        n_experts=full.n_experts, experts_per_token=full.experts_per_token)
    cfg = dataclasses.replace(get_config(arch), **changes)
    argv = cs.serve_argv(arch)
    at = argv.index("--device")
    argv = argv[:at] + argv[at + 2:]
    plan = ["--fault-plan", json.dumps(cs.FAULT_SERVE_PLAN)]
    _, *counts = _reference_serve(monkeypatch, capsys, arch, changes,
                                  argv + plan)
    clean = serve.main(["--device", "cpu", *argv], cfg=cfg)
    out, _ = _port_serve(capsys, cfg, argv + plan)
    sched = out["scheduler"]
    assert [sched.clock, sched.quarantined, sched.failed] == counts
    assert sched.quarantined == cs.FAULT_SERVE_QUARANTINED
    assert sched.failed == 0
    _check_recovered(out, clean)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step\s+(\d+)\s+loss\s+(\S+)")


def test_supervisor_recovers_killed_run(tmp_path, capsys):
    plan = FaultPlan(events=(
        FaultEvent(step=5, kind="kill"),
        FaultEvent(step=1, kind="grad_poison"),
        FaultEvent(step=2, kind="crash", worker=1, duration=1)))
    plan_path = plan.save(str(tmp_path / "plan.json"))
    args = ["--device", "cpu", "--arch", ARCH, "--sync", "async",
            "--compressor", "topk", "--tau-max", "1", "--workers", "2",
            "--seq", "32", "--batch", "4", "--steps", "8", "--log-every",
            "1", "--ckpt-every", "2", "--n-layers", "1"]
    # one intra-op thread in the child, as in this process (where the
    # oracle runs): CPU sums split over more threads round apart
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervisor",
         "--backoff", "0.05", "--fault-plan", plan_path, "--",
         *args, "--ckpt-dir", str(tmp_path / "sup")],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert "fault: SIGKILL at step 5 (attempt 0)" in out
    assert "resumed from step 6" in out
    assert "[supervisor] child completed on attempt 1" in out
    sup = [STEP_LINE.match(line).groups() for line in out.splitlines()
           if STEP_LINE.match(line)]
    assert [int(s) for s, _ in sup] == list(range(8))

    train.main([*args, "--ckpt-dir", str(tmp_path / "oracle"),
                "--fault-plan", plan_path, "--fault-attempt", "1"])
    text = capsys.readouterr().out
    oracle = [STEP_LINE.match(line).groups() for line in text.splitlines()
              if STEP_LINE.match(line)]
    assert [loss for _, loss in sup] == [loss for _, loss in oracle]
    assert "faults: poisoned=1 skipped=1" in text
    assert oracle[1][1] == "nan"
    # the child ran the depth cut its arguments asked for
    params = load_checkpoint(str(tmp_path / "sup"), 8)[0]
    assert params["layers"]["attn"]["wq"].shape[0] == 1


@pytest.mark.parametrize("n_layers", [-1, 3])
def test_n_layers_beyond_the_depth_is_refused(n_layers):
    assert get_config(ARCH).n_layers == 2
    with pytest.raises(SystemExit, match="--n-layers"):
        train.main(["--device", "cpu", "--arch", ARCH, "--steps", "1",
                    "--n-layers", str(n_layers)])


def test_failed_save_is_printed_and_training_goes_on(tmp_path, capsys):
    plan = json.dumps({"events": [{"step": 2, "kind": "ckpt_io"}]})
    hist = train.main(["--device", "cpu", "--arch", ARCH, "--sync", "exact",
                       "--seq", "32", "--batch", "4", "--steps", "4",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                       "--fault-plan", plan])
    out = capsys.readouterr().out
    assert len(hist) == 4
    assert "ckpt save failed at step 2: injected checkpoint IO failure" \
        in out
    assert "faults: poisoned=0 skipped=0 ckpt_errors=1" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000004.npz",
                                            "step_00000004.npz.treedef"]
