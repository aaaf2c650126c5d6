"""The port's simulator (``repro_torch.core``) against the JAX reference, on
the CPU.

* **Exact:** the schedules of every kind (bitwise), the quadratic's A and
  x* and the MLP data set (bitwise), ``delivery_tensors``, ``delay_masks``
  and the Table 1 bounds.
* **Step for step:** ``simulate`` with the reference's gradient draws
  against the reference's numpy oracle (``engine="ref"``), for every kind
  plus shared memory: the port's unfused loop, its fused step (the fused
  kinds) and its own oracle, at the reference's parity tolerances
  (``tests/test_sim_engine.py``: rtol 2e-3; atol 2e-3 on gaps, 2e-4 on
  losses, gradient norms and x).
* **Batches:** ``simulate_sweep`` against single runs, and
  ``simulate_grid`` against a loop of ``simulate_sweep`` calls.

Each reference result is computed once per module (the reference compiles
its programs per problem).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.core import delivery as JD  # noqa: E402
from repro.core import theory as JT  # noqa: E402
from repro.core.problems import MLPClassification as JaxMLP  # noqa: E402
from repro.core.problems import Quadratic as JaxQuadratic  # noqa: E402
from repro.core.sim import Relaxation as JaxRelaxation  # noqa: E402
from repro.core.sim import simulate as jax_simulate  # noqa: E402
from repro.core.sim import simulate_shared_memory as jax_shm  # noqa: E402
from repro.core.sim_types import make_schedule as jax_make_schedule  # noqa: E402
from repro.core.sim_types import \
    make_shared_memory_schedule as jax_make_shm_schedule  # noqa: E402

from repro_torch.core import compression as C  # noqa: E402
from repro_torch.core import delivery as D  # noqa: E402
from repro_torch.core import theory as TH  # noqa: E402
from repro_torch.core.problems import MLPClassification, Quadratic  # noqa: E402
from repro_torch.core.sim import (Relaxation, simulate,  # noqa: E402
                                  simulate_grid, simulate_shared_memory,
                                  simulate_sweep)
from repro_torch.core.sim_engine import simulate_scan  # noqa: E402
from repro_torch.core.sim_types import (make_schedule,  # noqa: E402
                                        make_shared_memory_schedule)
from repro_torch.kernels import sim_step as SSK  # noqa: E402

P, T, ALPHA, DIM = 8, 60, 0.02, 32

# (name, kind, knobs, compressor)
KINDS = [
    ("sync", "sync", {}, None),
    ("crash", "crash", dict(f=3), None),
    ("crash_subst", "crash_subst", dict(f=3), None),
    ("omission", "omission", dict(f=6, drop_prob=0.25), None),
    ("async", "async", dict(tau_max=3), None),
    ("async_tau1", "async", dict(tau_max=1), None),
    ("ef_topk", "ef_comp", {}, "topk"),
    ("ef_onebit", "ef_comp", {}, "onebit"),
    ("elastic_norm", "elastic_norm", dict(beta=0.8), None),
    ("elastic_variance", "elastic_variance", dict(drop_prob=0.3), None),
    ("adversarial", "adversarial", dict(B_adv=20.0), None),
]
KIND_IDS = [k[0] for k in KINDS]
FUSED = ["sync", "crash", "crash_subst", "elastic_variance"]


def _relaxes(name):
    _, kind, kw, comp = next(k for k in KINDS if k[0] == name)
    jkw, tkw = dict(kw), dict(kw)
    if comp == "topk":
        jkw["compressor"] = JC.topk_compressor(0.25)
        tkw["compressor"] = C.topk_compressor(0.25)
    elif comp == "onebit":
        jkw["compressor"] = JC.onebit_compressor()
        tkw["compressor"] = C.onebit_compressor()
    return JaxRelaxation(kind, **jkw), Relaxation(kind, **tkw)


def _jax_draws(problem, seed, t_len, p):
    """The reference's gradient draws: one batched draw at PRNGKey(seed+1)."""
    return torch.from_numpy(np.array(problem.presample_grads(
        jax.random.PRNGKey(seed + 1), t_len, p)))


def _assert_parity(a, b):
    np.testing.assert_allclose(a.gap2_over_alpha2, b.gap2_over_alpha2,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(a.losses, b.losses, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(a.grad_norms2, b.grad_norms2,
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(a.x_final, b.x_final, rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def probs():
    return (JaxQuadratic(dim=DIM, cond=8.0, sigma=1.0, seed=0),
            Quadratic(dim=DIM, cond=8.0, sigma=1.0, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def x0():
    return np.ones(DIM, np.float32) * 2.0


@pytest.fixture(scope="module")
def oracle(probs, x0):
    """name -> (reference oracle result, its draws), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            jrel, _ = _relaxes(name)
            ref = jax_simulate(probs[0], jrel, P, ALPHA, T, seed=3, x0=x0,
                               engine="ref")
            cache[name] = (ref, _jax_draws(probs[0], 3, T, P))
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# exact: schedules, problem data, delivery tensors, theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KIND_IDS)
@pytest.mark.parametrize("p,d,t_len,seed", [(8, 32, 60, 3), (5, 7, 13, 11)])
def test_schedules_bitwise(name, p, d, t_len, seed):
    jrel, trel = _relaxes(name)
    want = jax_make_schedule(jrel, p, d, t_len, seed)
    got = make_schedule(trel, p, d, t_len, seed)
    for w, g in ((want.per_step, got.per_step), (want.per_run, got.per_run)):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_shared_memory_schedule_bitwise_and_crash_bound_checked():
    want = jax_make_shm_schedule(8, 32, 60, 3, 3)
    got = make_shared_memory_schedule(8, 32, 60, 3, 3)
    np.testing.assert_array_equal(got.per_step["taus"],
                                  want.per_step["taus"])
    with pytest.raises(ValueError):
        make_schedule(Relaxation("crash", f=4), 4, 8, 10, 0)


@pytest.mark.parametrize("dim,cond,seed", [(32, 8.0, 0), (100, 10.0, 3)])
def test_quadratic_data_bitwise(dim, cond, seed):
    jp = JaxQuadratic(dim=dim, cond=cond, sigma=0.5, seed=seed)
    tp = Quadratic(dim=dim, cond=cond, sigma=0.5, seed=seed, device="cpu")
    np.testing.assert_array_equal(tp.A.numpy(), np.asarray(jp.A))
    np.testing.assert_array_equal(tp.x_star.numpy(), np.asarray(jp.x_star))
    assert (tp.L, tp.c, tp.sigma2) == (jp.L, jp.c, jp.sigma2)
    x = np.linspace(-1, 1, dim).astype(np.float32)
    np.testing.assert_allclose(float(tp.loss(torch.from_numpy(x))),
                               float(jp.loss(x)), rtol=1e-5)
    np.testing.assert_allclose(tp.grad(torch.from_numpy(x)).numpy(),
                               np.asarray(jp.grad(x)), rtol=1e-5, atol=1e-5)
    assert tp.m2_estimate(2.0) == jp.m2_estimate(2.0)
    tc, jc = tp.constants(x), jp.constants(x)
    np.testing.assert_allclose([tc.L, tc.sigma2, tc.f0_minus_fstar, tc.c,
                                tc.x0_dist2],
                               [jc.L, jc.sigma2, jc.f0_minus_fstar, jc.c,
                                jc.x0_dist2], rtol=1e-5)


def test_mlp_data_bitwise_and_gradients():
    jm = JaxMLP(seed=0)
    tm = MLPClassification(seed=0, device="cpu")
    np.testing.assert_array_equal(tm.xs.numpy(), np.asarray(jm.xs))
    np.testing.assert_array_equal(tm.ys.numpy(), np.asarray(jm.ys))
    assert tm.dim == jm.dim
    x = tm.init(seed=1)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jm.init(seed=1)))
    np.testing.assert_allclose(float(tm.loss(x)), float(jm.loss(x.numpy())),
                               rtol=1e-5)
    np.testing.assert_allclose(tm.grad(x).numpy(),
                               np.asarray(jm.grad(x.numpy())), rtol=1e-4,
                               atol=1e-6)
    idx = np.array(jm.presample_grads(jax.random.PRNGKey(0), 2, 3))
    views = np.stack([x.numpy()] * 3)
    want = np.asarray(jm.batch_grads_at(views, idx[1]))
    got = tm.batch_grads_at(torch.from_numpy(views), torch.from_numpy(idx[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    sigma2, m2 = tm.estimate_noise(x)
    assert 0 < sigma2 < m2


def _crash_schedule(p, t_len, seed, rejoin):
    sched = make_schedule(Relaxation("crash_subst", f=3), p, 4, t_len, seed)
    if rejoin:
        sched.per_run["rejoin_step"] = np.where(
            sched.per_run["crash_step"] < t_len,
            sched.per_run["crash_step"] + 5, t_len).astype(np.int32)
    return sched


@pytest.mark.parametrize("kind,rejoin", [
    ("crash", False), ("crash_subst", False), ("crash", True),
    ("crash_subst", True), ("elastic_variance", False)])
def test_delivery_tensors_exact(kind, rejoin):
    p, t_len = 6, 40
    if kind == "elastic_variance":
        sched = make_schedule(Relaxation(kind), p, 4, t_len, 2)
    else:
        sched = _crash_schedule(p, t_len, 2, rejoin)
    knobs = {"drop_prob": 0.3}
    u, alive = D.delivery_tensors(kind, p, t_len, sched.per_step,
                                  sched.per_run, knobs)
    ju, jalive = JD.delivery_tensors(kind, p, t_len, sched.per_step,
                                     sched.per_run,
                                     {"drop_prob": np.float32(0.3)})
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    if jalive is None:
        assert alive is None
    else:
        np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))


def test_delay_masks_and_message_delays_exact():
    taus = D.make_tau_schedule("rejoin", 5, 30, 3, 4)
    delays = D.taus_to_message_delays(taus)
    np.testing.assert_array_equal(delays, JD.taus_to_message_delays(taus))
    got = D.delay_masks(torch.from_numpy(delays), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JD.delay_masks(delays, 4)))


def test_theory_bounds_equal():
    for fn, args in ((TH.b_shared_memory, (32, 3, 2.5)),
                     (TH.b_async_mp, (8, 2, 2.5)),
                     (TH.b_async_mp_variance, (8, 2, 1.5)),
                     (TH.b_crash_m, (8, 3, 2.5)),
                     (TH.b_crash_variance, (8, 3, 1.5)),
                     (TH.b_ef_compression, (0.75, 2.5)),
                     (TH.b_elastic_scheduler_variance, (1.5,)),
                     (TH.lemma6_iters, (2.0, 0.01))):
        assert fn(*args) == getattr(JT, fn.__name__)(*args)
    pc = TH.ProblemConstants(L=8.0, sigma2=1.0, f0_minus_fstar=3.0, c=1.0,
                             x0_dist2=4.0)
    jpc = JT.ProblemConstants(L=8.0, sigma2=1.0, f0_minus_fstar=3.0, c=1.0,
                              x0_dist2=4.0)
    assert TH.thm2_rhs(pc, 2.0, 100) == JT.thm2_rhs(jpc, 2.0, 100)
    assert TH.thm3_rhs(pc, 2.0, 100, 8) == JT.thm3_rhs(jpc, 2.0, 100, 8)
    assert TH.thm4_rhs(pc, 2.0, 100) == JT.thm4_rhs(jpc, 2.0, 100)
    assert TH.thm5_rhs(pc, 2.0, 100, 8) == JT.thm5_rhs(jpc, 2.0, 100, 8)


# ---------------------------------------------------------------------------
# simulate, step for step, against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KIND_IDS)
def test_scan_matches_reference(probs, x0, oracle, name):
    ref, draws = oracle(name)
    _, trel = _relaxes(name)
    got = simulate(probs[1], trel, P, ALPHA, T, seed=3, x0=x0,
                   engine="scan", fused=False, draws=draws)
    _assert_parity(got, ref)


@pytest.mark.parametrize("name", KIND_IDS)
def test_ref_engine_matches_reference(probs, x0, oracle, name):
    ref, draws = oracle(name)
    _, trel = _relaxes(name)
    got = simulate(probs[1], trel, P, ALPHA, T, seed=3, x0=x0, engine="ref",
                   draws=draws)
    _assert_parity(got, ref)


@pytest.mark.parametrize("name", FUSED)
def test_fused_matches_reference(probs, x0, oracle, name):
    ref, draws = oracle(name)
    _, trel = _relaxes(name)
    assert SSK.supports_fused(probs[1], trel)
    got = simulate(probs[1], trel, P, ALPHA, T, seed=3, x0=x0, fused=True,
                   draws=draws)
    _assert_parity(got, ref)


@pytest.mark.parametrize("engine", ["scan", "ref"])
def test_shared_memory_matches_reference(probs, x0, engine):
    ref = jax_shm(probs[0], P, 0.005, T, tau_max=3, seed=3, x0=x0,
                  engine="ref")
    got = simulate_shared_memory(probs[1], P, 0.005, T, tau_max=3, seed=3,
                                 x0=x0, engine=engine,
                                 draws=_jax_draws(probs[0], 3, T, 1))
    _assert_parity(got, ref)


def test_mlp_matches_reference():
    jm = JaxMLP(seed=0)
    tm = MLPClassification(seed=0, device="cpu")
    x0m = np.asarray(jm.init(seed=1))
    ref = jax_simulate(jm, JaxRelaxation("async", tau_max=2), 4, 0.1, 40,
                       seed=2, x0=x0m, engine="ref")
    got = simulate(tm, Relaxation("async", tau_max=2), 4, 0.1, 40, seed=2,
                   x0=x0m, draws=_jax_draws(jm, 2, 40, 4))
    _assert_parity(got, ref)


def test_auto_dispatch_and_fused_errors(probs, x0):
    """``auto`` is the fused step at d >= AUTO_MIN_DIM and the unfused one
    below; unsupported (problem, kind) pairs raise under ``fused=True``."""
    relax = Relaxation("crash_subst", f=3)
    big = Quadratic(dim=128, cond=8.0, sigma=1.0, seed=0, device="cpu")
    auto = simulate(big, relax, P, ALPHA, 20, seed=3, fused="auto")
    fused = simulate(big, relax, P, ALPHA, 20, seed=3, fused=True)
    np.testing.assert_array_equal(auto.x_final, fused.x_final)
    small_auto = simulate(probs[1], relax, P, ALPHA, 20, seed=3, x0=x0)
    small_unfused = simulate(probs[1], relax, P, ALPHA, 20, seed=3, x0=x0,
                             fused=False)
    np.testing.assert_array_equal(small_auto.x_final, small_unfused.x_final)
    mlp = MLPClassification(seed=0, device="cpu")
    assert not SSK.supports_fused(mlp, relax)
    with pytest.raises(ValueError):
        simulate(mlp, relax, 4, 0.1, 5, seed=2, fused=True)
    with pytest.raises(ValueError):
        simulate(probs[1], Relaxation("async", tau_max=2), P, ALPHA, 5,
                 fused=True)
    with pytest.raises(ValueError):
        simulate(probs[1], relax, P, ALPHA, 5, engine="nope")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((AssertionError, RuntimeError)):
        Quadratic(dim=8)


# ---------------------------------------------------------------------------
# batches: sweeps and grids
# ---------------------------------------------------------------------------

def test_sweep_matches_single_runs(probs, x0):
    """The port's sweep against the port's single runs (1e-5, the
    reference's own bound) and against the reference's SINGLE runs at the
    parity tolerances.  The reference's own sweep-vs-single equality
    (``tests/test_sim_engine.py::test_vmap_over_seeds_matches_single_runs``)
    misses its 1e-5 bound under jax 0.9.0: one gap entry of 60 (about 2.58)
    is off by 5.0e-5 absolute, 1.9e-5 relative (fp32 reordering under
    ``vmap``), so the port is not held to the reference's sweep."""
    seeds = [0, 1, 2]
    jrel = JaxRelaxation("async", tau_max=2)
    relax = Relaxation("async", tau_max=2)
    draws = [_jax_draws(probs[0], s, T, P) for s in seeds]
    batch = simulate_sweep(probs[1], relax, P, ALPHA, T, seeds, x0=x0,
                           draws=draws)
    assert len(batch) == len(seeds)
    for s, dr, res in zip(seeds, draws, batch):
        single = simulate(probs[1], relax, P, ALPHA, T, seed=s, x0=x0,
                          draws=dr)
        np.testing.assert_allclose(res.gap2_over_alpha2,
                                   single.gap2_over_alpha2,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.x_final, single.x_final,
                                   rtol=1e-5, atol=1e-6)
        ref = jax_simulate(probs[0], jrel, P, ALPHA, T, seed=s, x0=x0,
                           engine="scan")
        _assert_parity(res, ref)
    assert not np.allclose(batch[0].x_final, batch[1].x_final)


def test_fused_sweep_matches_single_runs(probs, x0):
    relax = Relaxation("elastic_variance", drop_prob=0.3)
    batch = simulate_sweep(probs[1], relax, P, ALPHA, T, [0, 5], x0=x0,
                           fused=True)
    for s, res in zip([0, 5], batch):
        single = simulate(probs[1], relax, P, ALPHA, T, seed=s, x0=x0,
                          fused=True)
        np.testing.assert_allclose(res.x_final, single.x_final,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_grid_matches_looped_sweep(x0, fused):
    """Several problems x relaxation knobs x alphas x seeds in one call
    equal a loop of sweeps (``tests/test_sim_step_kernel.py``'s bounds)."""
    probs = [Quadratic(dim=DIM, cond=8.0, sigma=1.0, seed=s, device="cpu")
             for s in (0, 1)]
    relaxes = [Relaxation("crash_subst", f=3),
               Relaxation("elastic_variance", drop_prob=0.3),
               Relaxation("elastic_variance", drop_prob=0.1)]
    alphas, seeds = [0.01, 0.02], [0, 1]
    grid = simulate_grid(probs, relaxes, P, alphas, T, seeds=seeds, x0=x0,
                         fused=fused)
    assert len(grid) == len(probs) * len(relaxes) * len(alphas) * len(seeds)
    for ip, prob in enumerate(probs):
        for ir, relax in enumerate(relaxes):
            for ia, alpha in enumerate(alphas):
                swept = simulate_sweep(prob, relax, P, alpha, T, seeds,
                                       x0=x0, fused=fused)
                for s, want in zip(seeds, swept):
                    got = grid[(ip, ir, P, ia, s)]
                    np.testing.assert_allclose(
                        got.gap2_over_alpha2, want.gap2_over_alpha2,
                        rtol=1e-4, atol=1e-4)
                    np.testing.assert_allclose(got.losses, want.losses,
                                               rtol=1e-4, atol=1e-5)
                    np.testing.assert_allclose(got.x_final, want.x_final,
                                               rtol=1e-4, atol=1e-5)


def test_grid_hooks_and_select(probs, x0):
    """``schedule_fn`` and ``draws`` override a case's randomness;
    ``select`` filters by coordinate."""
    relaxes = [Relaxation("sync"), Relaxation("crash", f=2)]
    sched = make_schedule(relaxes[1], P, DIM, T, 7)
    dr = _jax_draws(probs[0], 7, T, P)
    grid = simulate_grid(probs[1], relaxes, P, ALPHA, T, seeds=(0, 1), x0=x0,
                         schedule_fn=lambda ir, p, s: sched if ir == 1
                         else None,
                         draws=lambda ip, p, s: dr if s == 1 else None)
    assert len(grid.select(i_relax=0)) == 2
    assert len(grid.select(seed=1)) == 2
    assert len(grid.select()) == 4
    want = simulate_scan(probs[1], relaxes[1], P, ALPHA, T, x0=x0,
                         schedule=sched, draws=dr)
    np.testing.assert_allclose(grid[(0, 1, P, 0, 1)].x_final, want.x_final,
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(grid[(0, 1, P, 0, 0)].x_final, want.x_final)
