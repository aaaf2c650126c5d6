"""The port's delivery-ring model checker (``repro_torch.analysis.rings``)
and the ring ops it drives, against the JAX reference, on the CPU.

Every comparison here is exact: the checker's layers are integer and 0/1
arithmetic, so findings, statistics, delivery matrices, delivery tensors
and served versions are held to the reference's with ``==`` /
``array_equal``.  ``ParamReplica(lags=)`` raises where
the reference raises and serves the reference's versions.

The full ``run()`` (about 17 s of the reference's CPU time, most of it its
ground-truth compiles) runs once, in one test.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import rings as JR  # noqa: E402
from repro.core import delivery as JD  # noqa: E402
from repro.serve.replica import ParamReplica as JaxReplica  # noqa: E402

from repro_torch.analysis import rings as R  # noqa: E402
from repro_torch.analysis.findings import Finding  # noqa: E402
from repro_torch.core import delivery as D  # noqa: E402
from repro_torch.core.delivery import DROPPED  # noqa: E402
from repro_torch.serve.replica import ParamReplica  # noqa: E402

CPU = "cpu"


def _same_findings(got, want):
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]


# ---------------------------------------------------------------------------
# the whole pass against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_run_matches_reference(fast):
    want = JR.run(fast=fast)
    got = R.run(fast=fast, device=CPU)
    assert got.findings == [] and want.findings == []
    assert got.info == want.info


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((AssertionError, RuntimeError)):
        R.run(fast=True)


# ---------------------------------------------------------------------------
# layers 1 and 2: the model's closed-form cases, the prover, its teeth
# ---------------------------------------------------------------------------

def test_delivery_rings_exhaustive_small():
    findings, stats = R.check_gradient_rings(2, 2, 6, device=CPU)
    want_f, want_s = JR.check_gradient_rings(2, 2, 6)
    assert findings == [] and want_f == []
    assert stats == want_s and stats["schedules"] == 4 ** 6


@pytest.mark.parametrize("tau_max", [1, 2, 3])
def test_negative_control_capacity_short_by_one(tau_max):
    """cap = tau_max (one slot short) MUST alias, with the reference's
    finding, fingerprint for fingerprint."""
    taus = R.enumerate_schedules(tau_max, 2 * (tau_max + 1), rings=1,
                                 crashes=False)
    np.testing.assert_array_equal(taus, JR.enumerate_schedules(
        tau_max, 2 * (tau_max + 1), rings=1, crashes=False))
    res = R.prove_ring_schedules(taus, tau_max, "t")
    assert any(f.rule in ("slot-alias", "mistimed-delivery")
               for f in res.findings)
    _same_findings(res.findings,
                   JR.prove_ring_schedules(taus, tau_max, "t").findings)
    assert R.check_negative_control(tau_max, 2 * (tau_max + 1)) == []


def test_reference_model_matches_closed_form():
    model = R.simulate_ring_model([2, 0, DROPPED, 1], cap=3)
    assert model["violations"] == []
    assert model["delivered"] == {0: 2, 1: 1}
    model = R.simulate_ring_model([0, 0, 0], cap=1)
    assert model["delivered"] == {0: 0, 1: 1, 2: 2}
    model = R.simulate_ring_model([1, 0], cap=2)       # dues 1 and 1
    assert model["violations"] == []
    assert model["delivered"] == {0: 1, 1: 1}


def test_reference_model_catches_capacity_violations():
    model = R.simulate_ring_model([1, 0], cap=1)
    assert any("mistimed" in v for v in model["violations"])
    assert model == JR.simulate_ring_model([1, 0], cap=1)
    model = R.simulate_ring_model([2, 1, 0], cap=2)
    assert model["violations"] != []
    assert model == JR.simulate_ring_model([2, 1, 0], cap=2)


def test_finding_fingerprint_is_the_reference():
    from repro.analysis.findings import Finding as JaxFinding
    args = ("rings", "slot-alias", "delivery-ring/tau2/p1/H6", "detail")
    assert Finding(*args).fingerprint == JaxFinding(*args).fingerprint
    assert Finding(*args).to_json() == JaxFinding(*args).to_json()


# ---------------------------------------------------------------------------
# layer 3: the port's ring ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau_max,cap", [(1, 2), (2, 3), (2, 2), (3, 3)])
def test_ring_deliveries_match_reference(tau_max, cap):
    """The port's ring ops, routed per ring by `delivery_plan`, deliver
    exactly as the reference's ``vmap``-ed ring ops at the right capacity
    (and on capacity ``tau_max``, where both diverge from the law); the
    slot ``delivery_plan`` clips to ``cap - 1`` is never reached at the
    right capacity."""
    taus = R.enumerate_schedules(tau_max, 2 * (tau_max + 1))[:, :, 0]
    taus = taus[::max(1, len(taus) // 2048)]
    got = R.ring_deliveries(taus, cap, CPU)
    if cap == tau_max + 1:
        np.testing.assert_array_equal(got, JR.jnp_ring_deliveries(taus, cap))
        assert R.check_ground_truth(taus, cap, "t", CPU) == []
    else:
        found = R.check_ground_truth(taus, cap, "t", CPU)
        assert [f.rule for f in found] == ["torch-divergence"]
        assert JR.check_ground_truth(taus, cap, "t") != []


@pytest.mark.parametrize("p,tau_max,horizon,seed",
                         [(3, 2, 6, 0), (4, 3, 9, 1), (2, 0, 5, 2),
                          (5, 1, 7, 3)])
def test_worker_ring_independence_witness(p, tau_max, horizon, seed):
    assert R.check_worker_ring_independence(p, tau_max, horizon, seed,
                                            device=CPU) == []
    assert JR.check_worker_ring_independence(p, tau_max, horizon, seed) == []


# ---------------------------------------------------------------------------
# crash / rejoin conservation: delivery_tensors under torch.func.vmap
# ---------------------------------------------------------------------------

def test_crash_rejoin_conservation_matches_reference():
    got_f, got_s = R.check_crash_rejoin_conservation(2, 4, device=CPU)
    want_f, want_s = JR.check_crash_rejoin_conservation(2, 4)
    assert got_f == [] and want_f == []
    assert got_s == want_s and got_s["configs"] > 0


@pytest.mark.parametrize("kind", ["crash", "crash_subst"])
@pytest.mark.parametrize("hear", [0.0, 1.0])
def test_vmapped_delivery_tensors_bitwise(kind, hear):
    """The batch the checker feeds (every (crash, rejoin) pair per worker
    at p 3, T 4) through the port's `delivery_tensors` under
    ``torch.func.vmap`` equals the reference's ``jax.vmap``, and each
    config equals the port's own unbatched call."""
    p, t_steps = 3, 4
    pairs = [(c, r) for c in range(t_steps + 1)
             for r in (range(c + 1, t_steps + 1) if c < t_steps else [])] \
        + [(t_steps, 2 * t_steps)] + [(c, 2 * t_steps)
                                     for c in range(t_steps)]
    combos = np.asarray(list(itertools.product(pairs, repeat=p)), np.int32)
    cs, rs = combos[:, :, 0], combos[:, :, 1]
    hu = np.full((len(combos), p, p), hear, np.float32)
    fn = torch.func.vmap(lambda c, r, h: D.delivery_tensors(
        kind, p, t_steps, {}, {"crash_step": c, "rejoin_step": r,
                               "hear_u": h}, {}))
    u, alive = fn(torch.from_numpy(cs), torch.from_numpy(rs),
                  torch.from_numpy(hu))
    ju, jalive = jax.jit(jax.vmap(lambda c, r, h: JD.delivery_tensors(
        kind, p, t_steps, {}, {"crash_step": c, "rejoin_step": r,
                               "hear_u": h}, {})))(
        jnp.asarray(cs), jnp.asarray(rs), jnp.asarray(hu))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    for b in (0, len(combos) // 2, len(combos) - 1):
        ub, ab = D.delivery_tensors(kind, p, t_steps, {}, {
            "crash_step": cs[b], "rejoin_step": rs[b], "hear_u": hu[b]}, {})
        assert torch.equal(ub, u[b]) and torch.equal(ab, alive[b])


def test_conservation_checker_catches_violations():
    p, t = 2, 3
    u = np.zeros((1, t, 1 + p, p), np.float32)
    alive = np.ones((1, t, p), bool)
    u[0, :, 0, :] = 1.0
    u[0, :, 1:, :] = 1.0
    assert R._conservation_violations("crash_subst", u, alive, "t") == []
    u[0, 1, 1, 0] = 0.0
    bad = R._conservation_violations("crash_subst", u, alive, "t")
    assert any(f.rule == "mass-not-conserved" for f in bad)
    _same_findings(bad, JR._conservation_violations("crash_subst", u, alive,
                                                    "t"))
    u2 = u.copy()
    u2[0, :, 1:, :] = 1.0
    alive2 = alive.copy()
    alive2[0, 2, 1] = False
    bad2 = R._conservation_violations("crash", u2, alive2, "t")
    assert any(f.rule == "dead-row-mass" for f in bad2)
    _same_findings(bad2, JR._conservation_violations("crash", u2, alive2,
                                                     "t"))


# ---------------------------------------------------------------------------
# the version ring: ParamReplica(lags=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau_serve,real_runs", [(0, 16), (1, 32), (2, 48)])
def test_replica_version_ring_matches_reference(tau_serve, real_runs):
    horizon = 4
    got = R.check_replica_ring(tau_serve, horizon, real_runs=real_runs,
                               device=CPU)
    want = JR.check_replica_ring(tau_serve, horizon, real_runs=real_runs)
    assert got == want and got[0] == []
    assert got[1]["interleavings"] == (tau_serve + 3) ** horizon


def test_replica_model_cases():
    ops = [("publish",), ("publish",), ("refresh", 1)]
    assert R.simulate_replica_model(ops, tau_serve=1) == []
    bad = [("publish",), ("publish",), ("publish",), ("refresh", 2)]
    assert R.simulate_replica_model(bad, tau_serve=1) == \
        JR.simulate_replica_model(bad, tau_serve=1)


@pytest.mark.parametrize("lags,tau", [([], 1), ([0, 2], 1), ([-2], 2),
                                      ([3, 0, DROPPED], 2), ([5], 0)])
def test_replica_lags_refused_as_reference(lags, tau):
    with pytest.raises(ValueError, match="lags must be in"):
        JaxReplica({"v": jnp.zeros(())}, tau, lags=lags)
    with pytest.raises(ValueError, match="lags must be in"):
        ParamReplica({"v": torch.zeros(())}, tau, lags=lags)


@pytest.mark.parametrize("lags,tau", [([DROPPED], 2), ([0, 1, DROPPED], 2),
                                      ([1, 0, 1, 1, DROPPED, 0], 1),
                                      ([0], 0), ((2, 2, 0), 3)])
def test_replica_lags_serve_as_reference(lags, tau):
    """A publish/refresh sequence through both replicas driven by the same
    explicit lags: the same serving version and the same served value at
    every read (DROPPED served as the maximal lag)."""
    jrep = JaxReplica({"v": jnp.zeros(())}, tau, lags=lags)
    rep = ParamReplica({"v": torch.zeros(())}, tau, lags=lags)
    ops = "ppr" "rpr" "pprr" "prpr" "r"
    latest = 0
    for op in ops:
        if op == "p":
            latest += 1
            assert jrep.publish({"v": jnp.full((), float(latest))}) == \
                rep.publish({"v": torch.full((), float(latest))})
        else:
            assert jrep.refresh() == rep.refresh()
        assert rep.serving_version == jrep.serving_version
        assert float(rep.serving_params()["v"]) == \
            float(jrep.serving_params()["v"]) == rep.serving_version
