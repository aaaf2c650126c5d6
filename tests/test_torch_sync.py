"""Parity of the port's synchronous gradient-sync strategies
(`repro_torch.core.scheduler`) and their train step with the JAX reference.

* The elastic gates (``bucket_assignment``, ``norm_gate_mask`` with and
  without a budget, ``static_gate_mask``) equal the reference's exactly.
* ``sync_gradients``: the reference runs in a subprocess on a forced
  4-device host mesh (the device count is fixed when jax initializes),
  inside ``shard_map`` over ``data``, for ``exact``, ``topk_ef``,
  ``onebit_ef``, ``elastic`` with the norm gate (without a budget, and
  with a budget that forces a full sync) and ``elastic`` with the static
  gate, and ``exact`` and ``elastic`` with a bf16 wire on 2 of the
  devices, over two rounds of per-worker gradients drawn with numpy.  One
  leaf has spec ``("model", None)``, so it is compressed as M > 1 rows.
  The port, fed the same gradients in worker order, must give the same
  synced gradients and per-worker state within 1e-6 and the same
  ``gap2_over_alpha2`` within rtol 1e-5 (a sum over every entry, added in
  another order than XLA's).
* A p = 1 trajectory of ``make_elastic_train_step`` (``topk_ef``, 2 steps)
  on qwen3-1.7b-smoke: the port's own loss within the model-parity
  tolerance of the reference's, and its sync/update half, fed the
  reference's gradients, on the reference's params and EF residuals at
  1e-5 (``tests/test_dist_parity.py``'s TOL).
* The trainer's entry point on the CPU for each synchronous ``--sync``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scheduler as JS  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.core.scheduler import (SyncConfig, bucket_assignment,  # noqa: E402
                                        init_sync_state, norm_gate_mask,
                                        static_gate_mask, sync_gradients)

TOL = 1e-6
GAP_RTOL = 1e-5


# ---------------------------------------------------------------------------
# the elastic gates, in-process
# ---------------------------------------------------------------------------

def test_bucket_assignment_matches_reference():
    rng = np.random.default_rng(0)
    for n_leaves in (1, 4, 9, 13):
        shapes = [tuple(rng.integers(1, 40, rng.integers(1, 4)))
                  for _ in range(n_leaves)]
        tree = {f"l{i:02d}": np.zeros(s, np.float32)
                for i, s in enumerate(shapes)}
        ttree = {k: torch.zeros(v.shape) for k, v in tree.items()}
        for nb in (1, 2, 3, 8):
            assert bucket_assignment(ttree, nb) == \
                JS.bucket_assignment(tree, nb), (shapes, nb)


@pytest.mark.parametrize("budget", [False, True])
def test_norm_gate_mask_matches_reference(budget):
    rng = np.random.default_rng(1 + budget)
    for trial in range(40):
        nb = int(rng.choice([1, 4, 9]))
        norms = (rng.random(nb) ** 3 * 10).astype(np.float32)
        if trial % 5 == 0:
            norms[rng.integers(0, nb)] = norms[0]       # a tie
        beta = float(rng.choice([0.1, 0.5, 0.9, 0.95, 1.0]))
        b2 = float(rng.choice([0.5, 4.0])) if budget else 0.0
        gap = np.float32(rng.choice([0.1, 1.0, 9.0]))
        want = np.asarray(JS.norm_gate_mask(
            jnp.asarray(norms), beta, b2, jnp.asarray(gap) if budget
            else None))
        got = norm_gate_mask(torch.from_numpy(norms), beta, b2,
                             torch.tensor(gap) if budget else None)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{norms} {beta} {b2} {gap}")


def test_static_gate_mask_matches_reference():
    for period in (1, 2, 3, 4):
        for nb in (1, 4, 8):
            for step in range(9):
                assert static_gate_mask(step, nb, period) == \
                    JS.static_gate_mask(step, nb, period)


# ---------------------------------------------------------------------------
# sync_gradients: the reference on 4 host devices in a subprocess
# ---------------------------------------------------------------------------

N_WORKERS = 4
# leaf shapes in the trees' leaf order (sorted keys) and their specs
SHAPES = {"a": (16, 24), "b": {"c": (8, 40), "d": (64,)}, "e": (12, 10),
          "f": (4, 6, 10)}
SPECS = {"a": (None, None), "b": {"c": (None, None), "d": (None,)},
         "e": ("model", None), "f": (None, None, None)}
CASES = {
    "exact": dict(strategy="exact"),
    "topk_ef": dict(strategy="topk_ef", topk_ratio=1 / 8),
    "onebit_ef": dict(strategy="onebit_ef"),
    "elastic_norm": dict(strategy="elastic", n_buckets=4, beta=0.5),
    "elastic_budget": dict(strategy="elastic", n_buckets=4, beta=0.5,
                           budget_b=1e-3),
    "elastic_static": dict(strategy="elastic", n_buckets=4, gate="static",
                           phase_period=2),
    # a bf16 wire, on 2 workers: a sum of two bf16 values is exact in f32,
    # so the port's f32 sum rounded to bf16 is the reference's bf16 psum
    "exact_bf16": dict(strategy="exact", wire_dtype="bf16", workers=2),
    "elastic_bf16": dict(strategy="elastic", n_buckets=4, beta=0.5,
                         wire_dtype="bf16", workers=2),
}

_SYNC_SCRIPT = textwrap.dedent("""
    import os, sys
    # one Eigen thread: the subprocess runs beside the rest of the suite
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.scheduler import SyncConfig, init_sync_state, \\
        sync_gradients
    from repro.jax_compat import shard_map

    out, shapes, specs, cases = sys.argv[1], *map(json.loads, sys.argv[2:])
    n = 4
    is_shape = lambda x: isinstance(x, list) and all(
        isinstance(i, int) for i in x)
    specs = jax.tree.map(lambda s: P(*s), specs,
                         is_leaf=lambda x: isinstance(x, list))
    rng = np.random.default_rng(0)
    rounds = [jax.tree.map(lambda s: rng.standard_normal(
        (n, *s)).astype(np.float32), shapes, is_leaf=is_shape)
        for _ in range(2)]
    rec = {}
    for r, g in enumerate(rounds):
        for i, a in enumerate(jax.tree.leaves(g)):
            rec[f"g{r}_{i}"] = a
    for case, kw in cases.items():
        workers = kw.pop("workers", n)
        mesh = Mesh(np.array(jax.devices()[:workers]), ("data",))
        scfg = SyncConfig(axis_names=("data",), **kw)
        inputs = [jax.tree.map(lambda a: a[:workers], g) for g in rounds]

        def local(g0, g1):
            g0 = jax.tree.map(lambda x: x[0], g0)
            g1 = jax.tree.map(lambda x: x[0], g1)
            state = init_sync_state(scfg, g0)
            outs = []
            for phase, g in enumerate((g0, g1)):
                synced, state, m = sync_gradients(scfg, g, state, specs=specs,
                                                  static_phase=phase)
                per_worker = {k: jax.tree.map(lambda a: a[None], v)
                              for k, v in state.items() if k != "step"}
                outs.append((synced, per_worker, m["gap2_over_alpha2"]))
            return outs

        in_spec = jax.tree.map(lambda _: P("data"), rounds[0])
        key = {"exact": None, "elastic": "residual"}.get(kw["strategy"],
                                                         "err")
        state_spec = {} if key is None else {key: in_spec}
        out_spec = [(jax.tree.map(lambda _: P(), rounds[0]), state_spec,
                     P())] * 2
        fn = jax.jit(shard_map(local, mesh, (in_spec, in_spec), out_spec,
                               check=False))
        for r, (synced, per_worker, gap) in enumerate(fn(*inputs)):
            for i, a in enumerate(jax.tree.leaves(synced)):
                rec[f"{case}_s{r}_{i}"] = np.asarray(a)
            for i, a in enumerate(jax.tree.leaves(per_worker)):
                rec[f"{case}_st{r}_{i}"] = np.asarray(a)
            rec[f"{case}_gap{r}"] = np.asarray(gap)
    np.savez(out, **rec)
""")


@pytest.fixture(scope="module")
def reference_sync(tmp_path_factory):
    import json
    out = tmp_path_factory.mktemp("sync") / "ref.npz"
    shapes = jax.tree.map(list, SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    specs = jax.tree.map(list, SPECS, is_leaf=lambda x: isinstance(x, tuple))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _SYNC_SCRIPT, str(out), json.dumps(shapes),
         json.dumps(specs), json.dumps(CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _close(port, reference, what):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(reference, np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_sync_gradients_matches_reference(reference_sync, case):
    rec = reference_sync
    kw = dict(CASES[case])
    workers = kw.pop("workers", N_WORKERS)
    scfg = SyncConfig(**kw)
    like = T.tree_map(lambda s: torch.zeros(s), SHAPES)
    _, td = T.flatten(like)
    n_leaves = len(T.leaves(like))
    state = init_sync_state(scfg, like, workers)
    for r in range(2):
        stacks = [rec[f"g{r}_{i}"] for i in range(n_leaves)]
        grads = [T.unflatten(td, [torch.from_numpy(s[w].copy())
                                  for s in stacks])
                 for w in range(workers)]
        synced, state, m = sync_gradients(scfg, iter(grads), state,
                                          specs=SPECS, static_phase=r)
        assert state["step"] == r + 1
        for i, a in enumerate(T.leaves(synced)):
            _close(a.numpy(), rec[f"{case}_s{r}_{i}"],
                   f"{case} synced leaf {i} round {r}")
        per_worker = [v for k, v in sorted(state.items()) if k != "step"]
        for i, a in enumerate(T.leaves(per_worker[0]) if per_worker
                              else []):
            _close(a.numpy(), rec[f"{case}_st{r}_{i}"],
                   f"{case} state leaf {i} round {r}")
        np.testing.assert_allclose(float(m["gap2_over_alpha2"]),
                                   float(rec[f"{case}_gap{r}"]),
                                   rtol=GAP_RTOL, atol=TOL,
                                   err_msg=f"{case} gap2 round {r}")


def test_sync_cases_exercise_both_gate_outcomes(reference_sync):
    """The elastic cases defer mass (non-zero residual, positive gap) and
    the budget case forces the full sync in round 2 (zero residual)."""
    rec = reference_sync
    n_leaves = len(T.leaves(SHAPES))
    for case in ("elastic_norm", "elastic_static"):
        assert float(rec[f"{case}_gap1"]) > 0.0
    deferred = [np.abs(rec[f"elastic_budget_st1_{i}"]).max()
                for i in range(n_leaves)]
    assert float(rec["elastic_budget_gap0"]) > 1e-6 and max(deferred) == 0.0


# ---------------------------------------------------------------------------
# the train step: a p = 1 trajectory against the reference's
# ---------------------------------------------------------------------------

def test_elastic_train_step_p1_topk_matches_reference():
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticLMDataset
    from repro.dist import sharding as SH
    from repro.dist.train import init_dist_sync_state as jax_init_state
    from repro.dist.train import make_elastic_train_step as jax_make_step
    from repro.dist.train import mean_grads as jax_mean_grads
    from repro.jax_compat import make_mesh
    from repro.models import transformer as JTF
    from repro.models.params import init_params as jax_init_params
    from repro.models.params import param_specs as jax_param_specs
    from repro.optim import momentum as jax_momentum

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import to_device
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_specs, params_from_jax
    from repro_torch.optim import constant, momentum

    lr, steps, tol, model_tol = 1e-2, 2, 1e-5, 2e-2
    jcfg = jax_get_config("qwen3-1.7b-smoke")
    mesh = make_mesh((1, 1), ("data", "model"))
    flags = JTF.RunFlags(remat=False)
    jdefs = JTF.model_defs(jcfg)
    pspecs = jax_param_specs(jdefs, SH.axis_sizes(mesh))
    jparams = jax_init_params(jdefs, jax.random.PRNGKey(0))
    jscfg = JS.SyncConfig(strategy="topk_ef", axis_names=("data",),
                          topk_ratio=1 / 8)
    jopt = jax_momentum(lr, 0.9)
    jstate = jax_init_state(jscfg, mesh, jparams)
    jstep = jax.jit(jax_make_step(jcfg, jopt, mesh, jscfg, pspecs, flags))
    gfn = jax.jit(lambda p, b: jax_mean_grads(jcfg, flags, p, b, 1)[2])
    data = SyntheticLMDataset(jcfg.vocab_size, 32, 4, seed=0)

    cfg = get_config("qwen3-1.7b-smoke")
    specs = param_specs(TF.model_defs(cfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    opt = momentum(constant(lr), 0.9)
    topt = opt.init(T.leaves(tparams))
    scfg = SyncConfig(strategy="topk_ef", topk_ratio=1 / 8)
    tstate = init_dist_sync_state(scfg, 1, tparams)
    tstep = make_elastic_train_step(cfg, opt, scfg, 1, specs)
    jopt_state = jopt.init(jparams)
    for t in range(steps):
        batch = data.batch(t)
        jgrads = params_from_jax(jax.tree.map(np.asarray,
                                              gfn(jparams, batch)))
        jparams, jopt_state, jstate, jm = jstep(jparams, jopt_state, jstate,
                                                batch)
        (loss, _), = list(tstep.worker_grads(tparams,
                                             to_device(batch, "cpu")))
        assert abs(float(loss) - float(jm["loss"])) < model_tol, t
        tparams, topt, tstate, tm = tstep.sync_update(
            tparams, topt, tstate, [(loss, jgrads)])
        for path, a, b in zip(T.paths(tparams), T.leaves(tparams),
                              jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=tol,
                                       err_msg=f"params {path} step {t}")
        for path, a, b in zip(T.paths(tstate["err"]),
                              T.leaves(tstate["err"]),
                              jax.tree.leaves(jstate["err"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol, err_msg=f"err {path} {t}")
        np.testing.assert_allclose(float(tm["gap2_over_alpha2"]),
                                   float(jm["gap2_over_alpha2"]),
                                   rtol=GAP_RTOL, err_msg=f"gap2 step {t}")
        assert float(tm["loss"]) == float(loss)


# ---------------------------------------------------------------------------
# the trainer's entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync", ["topk_ef", "onebit_ef", "elastic"])
def test_launcher_cpu_runs_each_sync_strategy(sync, capsys):
    from repro_torch.launch import train
    history = train.main(["--device", "cpu", "--arch", "qwen3-1.7b-smoke",
                          "--sync", sync, "--workers", "2", "--steps", "3",
                          "--seq", "32", "--batch", "4", "--log-every", "1"])
    assert len(history) == 3
    for row in history:
        assert np.isfinite(row["loss"]) and abs(row["loss"]) < 1e3
        assert np.isfinite(row["gap2_over_alpha2"])
    # EF residuals and deferred mass are non-zero after the first step
    assert history[-1]["gap2_over_alpha2"] > 0.0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("step")]
    assert len(lines) == 3 and all("gap2/a2" in l for l in lines)
    assert float(lines[0].split()[3]) == pytest.approx(history[0]["loss"],
                                                       abs=1e-6)
