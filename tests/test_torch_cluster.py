"""The port's cluster model and co-simulation (``repro_torch.cluster``,
``repro_torch.launch.cosim``) against the JAX reference, on the CPU.

* **Exact:** a spec's JSON (text), the trace and duration tables, and the
  event loop: its body is f32 adds, maxes and selects only, so the finish
  times and the learner clock are bitwise the reference's ``lax.scan``
  and the host-side tau table (``DROPPED`` rows included) is equal; the
  analytic roofline record (dict-equal).
* **Co-simulation, on the reference's gradient draws** (its
  ``presample_grads`` at ``PRNGKey(seed + 1)``): every recorded loss
  within ``LOSS_ATOL + LOSS_RTOL * |reference|`` (1e-6 + 1e-4) of the
  reference's (the two frameworks sum the quadratic's products in other
  orders: the first 60 steps read at most 3e-5 relative; later losses
  near the noise floor, about 5e-4, differ by up to 1e-7).  One-bit EF is
  chaotic in the last bits (a coordinate near zero changes sign class on
  one rounding difference, as ``chip_smoke.py``'s Table 1 notes): its
  losses are held to that tolerance over the reference's parity horizon
  (60 steps, ``tests/test_sim_engine.py``) and to the reference's parity
  tolerances (rtol 2e-3, atol 2e-4) after it (it reads 6.8e-6 at step
  110).  Every loss crossing lies inside the horizon and clears the
  tolerance (the two records around it lie further than the tolerance
  from the target; the tightest, ``sync`` at a 0.01 target, 2.1e-3 of
  it), so steps-to-loss, time-to-loss, the winners and the CLI's
  ``--out`` JSON are held equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.cluster import ClusterSpec as JaxSpec  # noqa: E402
from repro.cluster import analytic_record as jax_record  # noqa: E402
from repro.cluster import preset as jax_preset  # noqa: E402
from repro.cluster import rank_candidates as jax_rank  # noqa: E402
from repro.cluster import simulate_cluster as jax_simulate  # noqa: E402
from repro.cluster import trace_tables as jax_tables  # noqa: E402
from repro.cluster.perf import durations_table as jax_durations  # noqa: E402
from repro.core.problems import Quadratic as JaxQuadratic  # noqa: E402

from repro_torch.cluster import (DEFAULT_CANDIDATES, ClusterSpec,  # noqa: E402
                                 TraceEvent, analytic_record, preset,
                                 rank_candidates, simulate_cluster,
                                 trace_tables, winners)
from repro_torch.cluster.perf import durations_table  # noqa: E402
from repro_torch.core import delivery as D  # noqa: E402
from repro_torch.core.delivery import DROPPED  # noqa: E402

from test_torch_sim import _jax_draws  # noqa: E402

CPU = "cpu"
PRESETS = ("uniform", "straggler_heavy", "preemptible")
LOSS_RTOL = 1e-4
LOSS_ATOL = 1e-6
PARITY_STEPS = 60
PARITY_TOL = dict(rtol=2e-3, atol=2e-4)     # tests/test_sim_engine.py
CHAOTIC = ("onebit_ef",)
# (name, p, steps) presets and (seed, p, steps) random fleets
SPECS = [("uniform", 4, 50), ("straggler_heavy", 4, 120),
         ("preemptible", 3, 60), ("straggler_heavy", 2, 400)]
RANDOM = [(0, 4, 100), (7, 4, 100), (8, 3, 60)]


def _pair(kind, a, p, steps):
    if kind == "preset":
        return jax_preset(a, p=p, steps=steps), preset(a, p=p, steps=steps)
    return (JaxSpec.random(seed=a, p=p, steps=steps),
            ClusterSpec.random(seed=a, p=p, steps=steps))


CASES = [("preset",) + s for s in SPECS] + [("random",) + r for r in RANDOM]
CASE_IDS = [f"{k}-{a}-p{p}-T{t}" for k, a, p, t in CASES]


# ---------------------------------------------------------------------------
# ClusterSpec: JSON, validation, tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,a,p,steps", CASES, ids=CASE_IDS)
def test_spec_json_text_equal(kind, a, p, steps, tmp_path):
    want, got = _pair(kind, a, p, steps)
    assert got.to_json() == want.to_json()
    again = ClusterSpec.from_json(want.to_json())
    assert again == got and again.events == got.events
    path = want.save(str(tmp_path / "spec.json"))
    assert ClusterSpec.load(path) == got
    assert ClusterSpec.load(got.to_json()) == got


def test_spec_validation():
    for bad in (dict(step=0, kind="meteor", worker=0),
                dict(step=-1, kind="straggle", worker=0),
                dict(step=0, kind="netdeg", worker=0, duration=-1),
                dict(step=0, kind="straggle", worker=0, factor=0.0)):
        with pytest.raises(ValueError):
            TraceEvent(**bad)
    with pytest.raises(ValueError):
        ClusterSpec(p=0)
    with pytest.raises(ValueError):
        ClusterSpec(p=4, flops_per_s=(1e9, 2e9))
    with pytest.raises(ValueError):
        preset("nope")


@pytest.mark.parametrize("kind,a,p,steps", CASES, ids=CASE_IDS)
def test_trace_and_duration_tables_equal(kind, a, p, steps):
    want, got = _pair(kind, a, p, steps)
    for w, g in zip(jax_tables(want, steps), trace_tables(got, steps)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for w, g in zip(jax_durations(want, steps, 4e8, 4.7e6, 1e6),
                    durations_table(got, steps, 4e8, 4.7e6, 1e6)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_trace_tables_apply_events():
    spec = ClusterSpec(p=2, flops_per_s=(1e9,), link_bytes_per_s=(1e8,),
                       events=(
                           TraceEvent(step=2, kind="straggle", worker=0,
                                      duration=3, factor=4.0),
                           TraceEvent(step=1, kind="netdeg", worker=1,
                                      duration=0, factor=2.0),
                           TraceEvent(step=4, kind="preempt", worker=1,
                                      duration=2),
                       ))
    rates, bw, alive = trace_tables(spec, 8)
    np.testing.assert_allclose(rates[2:5, 0], 2.5e8)
    np.testing.assert_allclose(rates[5:, 0], 1e9)
    np.testing.assert_allclose(bw[1:, 1], 5e7)
    assert not alive[4:6, 1].any() and alive[6:, 1].all()


# ---------------------------------------------------------------------------
# the event loop: bitwise the reference's scan
# ---------------------------------------------------------------------------

def _same_run(got, want):
    for field in ("taus", "closes", "finishes", "durations"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.tau_histogram() == want.tau_histogram()
    assert got.total_s == want.total_s


@pytest.mark.parametrize("tau_max", [0, 2, 4])
@pytest.mark.parametrize("name", PRESETS)
def test_event_loop_bitwise(name, tau_max):
    steps = 60
    wire = 4.7e6 if name == "straggler_heavy" else 5e5
    run = simulate_cluster(preset(name, p=4, steps=steps), steps, tau_max,
                           4e8, wire, device=CPU)
    _same_run(run, jax_simulate(jax_preset(name, p=4, steps=steps), steps,
                                tau_max, 4e8, wire))
    assert run.device == CPU
    live = run.taus[run.taus != DROPPED]
    assert live.min() >= 0 and live.max() <= tau_max


@pytest.mark.parametrize("seed,tau_max", [(0, 3), (8, 4)])
def test_event_loop_bitwise_random_fleet(seed, tau_max):
    steps = 100
    run = simulate_cluster(ClusterSpec.random(seed=seed, p=4, steps=steps),
                           steps, tau_max, 4e8, 5.5e4, hbm_bytes=2e6,
                           device=CPU)
    _same_run(run, jax_simulate(JaxSpec.random(seed=seed, p=4, steps=steps),
                                steps, tau_max, 4e8, 5.5e4, hbm_bytes=2e6))


def test_preemption_emits_dropped_exactly_where_not_alive():
    run = simulate_cluster(preset("preemptible", p=4, steps=80), 80, 4,
                           4e8, 4.7e6, device=CPU)
    dead = run.taus == DROPPED
    assert dead.any()
    _, _, alive = trace_tables(run.spec, 80)
    np.testing.assert_array_equal(dead, ~alive)
    assert set(run.tau_histogram()) <= set(range(-1, 5))


def _run_ring(delays, tau_max):
    """The port's int-slot ring ops driven with one message per (step,
    worker): the p workers are rows of one slot-leading (cap, p, T) ring,
    each slot takes one deposit of the payloads routed to it (``+0.0``
    elsewhere), the payload one-hot in the source step
    (``tests/test_delivery.py::run_ring``)."""
    t_steps, p = delays.shape
    cap = tau_max + 1
    rings = D.ring_init(cap, (p, t_steps))
    taken = []
    for t in range(t_steps + tau_max):
        if t < t_steps:
            payload = torch.zeros((p, t_steps))
            payload[:, t] = torch.from_numpy(
                (delays[t] >= 0).astype(np.float32))
            slots = torch.from_numpy(
                (t + np.clip(delays[t], 0, tau_max)) % cap)
            for s in range(cap):
                D.ring_deposit(rings, s, payload * (slots == s)[:, None])
        out, _ = D.ring_take(rings, t % cap)
        taken.append(out.numpy())
    return np.stack(taken)                     # taken[t, w, s]


def _check_ring_invariants(delays, tau_max):
    taken = _run_ring(delays, tau_max)
    t_steps, p = delays.shape
    for s in range(t_steps):
        for w in range(p):
            hits = np.nonzero(taken[:, w, s])[0]
            if delays[s, w] < 0:
                assert hits.size == 0
                continue
            assert hits.size == 1 and taken[hits[0], w, s] == 1.0
            assert hits[0] - s == delays[s, w] <= tau_max


@pytest.mark.parametrize("name,tau_max", [("straggler_heavy", 3),
                                          ("preemptible", 4),
                                          ("uniform", 2)])
def test_measured_taus_satisfy_ring_exactly_once(name, tau_max):
    """Tables measured off the port's event loop drive the port's rings
    with exactly-once delivery, preemption windows included (the twin of
    ``tests/test_cluster.py::test_measured_taus_satisfy_ring_exactly_once``)."""
    run = simulate_cluster(preset(name, p=4, steps=40), 40, tau_max, 4e8,
                           5e5, device=CPU)
    D.validate_tau_table(run.taus, tau_max)
    _check_ring_invariants(run.taus, tau_max)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((AssertionError, RuntimeError)):
        simulate_cluster(preset("uniform", p=2, steps=8), 8, 1, 4e8, 5e5)
    with pytest.raises((AssertionError, RuntimeError)):
        rank_candidates(preset("uniform", p=2, steps=8), t_len=8)
    from repro_torch.launch import cosim as cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--cluster", "uniform", "--steps", "8"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b-smoke", "mixtral-8x7b",
                                  "zamba2-7b-smoke"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k",
                                   "prefill_32k"])
def test_analytic_record_matches_reference(arch, shape):
    assert analytic_record(arch, shape) == jax_record(arch, shape)
    assert analytic_record(arch, shape, chips=8) == \
        jax_record(arch, shape, chips=8)


# ---------------------------------------------------------------------------
# co-simulation on the reference's draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_problem():
    return JaxQuadratic(dim=32, cond=8.0, sigma=0.4, seed=0)


def _draws(jax_problem, t_len):
    return lambda ip, p, s: _jax_draws(jax_problem, s, t_len, p)


def _capture_reference_grid(monkeypatch, into):
    """Keep the reference's ``simulate_grid`` result: its
    ``rank_candidates`` returns no losses (the port's results carry them)."""
    import repro.cluster.cosim as jax_cosim
    orig = jax_cosim.simulate_grid

    def grid(*a, **k):
        into.append(orig(*a, **k))
        return into[-1]
    monkeypatch.setattr(jax_cosim, "simulate_grid", grid)


def _same_results(got, want, want_grid, target, record_every=2):
    for g, w in zip(got, want):
        assert (g.cluster, g.candidate, g.steps_to_loss, g.time_to_loss,
                g.step_s, g.wire_bytes, g.tau_histogram, g.dropped) == \
            (w.cluster, w.candidate, w.steps_to_loss, w.time_to_loss,
             w.step_s, w.wire_bytes, w.tau_histogram, w.dropped)
    assert len(got) == len(want)
    horizon = PARITY_STEPS // record_every
    assert len(want_grid.results) == len(got)
    for key, wr in want_grid.results.items():
        wl = np.asarray(wr.losses, np.float64)
        gl = np.asarray(got[key[1]].losses[0], np.float64)
        if DEFAULT_CANDIDATES[key[1]].name in CHAOTIC:
            np.testing.assert_allclose(gl[horizon:], wl[horizon:],
                                       **PARITY_TOL)
            gl, wl = gl[:horizon], wl[:horizon]
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        hits = np.flatnonzero(wl <= target)
        if hits.size:       # the crossing clears the tolerance
            assert hits[0] < horizon
            around = wl[max(hits[0] - 1, 0):hits[0] + 1]
            assert np.all(np.abs(around - target)
                          > LOSS_ATOL + LOSS_RTOL * target)
    assert winners(got) == dict(winners(want))


@pytest.mark.parametrize("name,t_len,target_frac",
                         [("uniform", 80, 0.01), ("preemptible", 120, 0.01)])
def test_rank_candidates_matches_reference(name, t_len, target_frac,
                                           jax_problem, monkeypatch):
    """All five default candidates (``topk_ef`` and ``onebit_ef`` through
    the EF rows' plain versions here): the reference's steps, times,
    winners, tau histograms and drops, losses within the tolerance
    (``straggler_heavy`` goes through the CLI's test below)."""
    want_grid = []
    _capture_reference_grid(monkeypatch, want_grid)
    want, want_runs = jax_rank(jax_preset(name, p=4, steps=t_len),
                               t_len=t_len, target_frac=target_frac)
    got, runs = rank_candidates(preset(name, p=4, steps=t_len), t_len=t_len,
                                target_frac=target_frac, device=CPU,
                                draws=_draws(jax_problem, t_len))
    target = target_frac * float(jax_problem.loss(np.zeros(32, np.float32)))
    _same_results(got, want, want_grid[0], target)
    for c in DEFAULT_CANDIDATES:
        _same_run(runs[c.name], want_runs[c.name])
        _check_ring_invariants(runs[c.name].taus, c.tau_max)


def test_winners_all_unreached():
    results, _ = rank_candidates(preset("uniform", p=4, steps=8),
                                 DEFAULT_CANDIDATES[:1], t_len=8,
                                 target_frac=1e-12, device=CPU)
    assert winners(results) == {"steps": None, "time": None}


def test_cosim_cli_out_matches_reference(jax_problem, tmp_path, capsys,
                                         monkeypatch):
    """The same spec file, flags and draws through both CLIs: the same
    printed table and winner lines, and an equal ``--out`` JSON."""
    from repro.launch import cosim as jax_cli
    from repro_torch.launch import cosim as cli

    spec_path = preset("straggler_heavy", p=4, steps=80).save(
        str(tmp_path / "spec.json"))
    flags = ["--cluster", spec_path, "--steps", "80", "--target-frac",
             "0.05"]
    monkeypatch.setattr("sys.argv", ["cosim"] + flags + [
        "--out", str(tmp_path / "want.json")])
    assert jax_cli.main() == 0
    want_text = capsys.readouterr().out
    report = {}
    assert cli.main(flags + ["--device", "cpu", "--out",
                             str(tmp_path / "got.json")],
                    draws=_draws(jax_problem, 80), report=report) == 0
    got_text = capsys.readouterr().out
    assert got_text.replace("got.json", "want.json") == want_text
    assert "winner by  time-to-loss" in got_text
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == json.loads((tmp_path / "want.json").read_text())
    assert got["cluster"] == json.loads(
        ClusterSpec.load(spec_path).to_json())
    assert report["winners"] == got["winners"]
    assert sorted(report["runs"]) == sorted(c.name
                                            for c in DEFAULT_CANDIDATES)


def test_cosim_cli_rejects_unknown_cluster(tmp_path):
    from repro_torch.launch import cosim as cli
    with pytest.raises(SystemExit):
        cli.load_cluster("not-a-preset-or-file", 4, 100)
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--cluster",
                  str(tmp_path / "missing.json")])
