"""The port's data-parallel workers over ``torch.distributed`` ranks
(`repro_torch.launch.mesh`, `repro_torch.dist.workers`,
`repro_torch.dist.sharding`, the checkpoint's gathered layout and the
launcher's ``--ranks``), on the CPU over ``gloo``.

Tolerances: bitwise, except where stated.

* ``--ranks 2 --workers 2`` against the in-process ``--workers 2``: every
  step's loss, gap metric (``gap2_over_alpha2`` or ``stale_gap2``, each a
  dense mean over the workers) and wire bytes, and the final checkpoint
  leaf for leaf (its
  sidecar too), for async top-k and one-bit (fused), top-k densified
  (``--no-overlap``), async ``tau_max 0`` without a compressor,
  ``topk_ef``, ``onebit_ef``, ``elastic`` with ``--budget-b`` and a
  ``grad_poison`` plan under the guard.  The ``tau_max 0`` run is also held
  to the in-process ``--sync exact`` step, which takes the gradient of the
  whole batch and so sums in another order: params at ``EXACT_TOL``
  absolute, losses at ``BF16_STEP`` relative (one bf16 rounding step: the
  bf16 forward amplifies params that differ in their last bits).
* ``--ranks 2 --workers 4`` (two workers a rank) against ``--workers 4``
  on the compact paths (async top-k, ``topk_ef``, ``onebit_ef``).
* A checkpoint of the 2-rank run resumes in one process, and one of the
  one-process run under 2 ranks; both end on the uninterrupted run's
  final checkpoint.
* A ``kill`` plan under ``launch.supervisor`` with ``--ranks 2``: rank 0
  dies after step 1, the launcher takes the world down, the supervisor
  restarts it, and it resumes from the gathered checkpoint; its printed
  losses are the uninterrupted run's and its final checkpoint is.
* The refusals: ``nccl`` without a card a rank, ranks that do not divide
  the workers, ``--sync exact`` over ranks.
* The reference's 2-device async top-k step (run as
  ``test_torch_async.py::test_p2_delivery_half_matches_reference_subprocess``
  runs it) recording each worker's gradients, which feed the port's
  delivery half on 2 ranks, one worker each: params, rings and residuals
  within that test's ``TOL``, ``stale_gap2`` at its 2e-5 relative,
  ``mean_tau`` equal.
* The wire: one step of the reduced qwen3 of
  ``tests/golden/collective_inventory.json`` (batch 4 x 32, one worker,
  its entry points' configurations) counts exactly the golden's
  ``all_gather`` bytes on the four compressed entries, fewer bytes than the
  dense ``sync`` entry on each, and the dense entries are logged beside
  the golden's.

Every run is a subprocess pinned to one intra-op thread (CPU sums over
more threads round apart); the ranks are spawned by the launcher, whose
children import package code, never this module.  Runs that do not depend
on each other start together.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402

from test_torch_async import _P2_SCRIPT, TOL  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SyncConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset, to_device  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state,
                                           make_async_train_step)
from repro_torch.dist.train import (init_dist_sync_state,  # noqa: E402
                                    make_elastic_train_step)
from repro_torch.dist import workers as W  # noqa: E402
from repro_torch.dist.workers import WorkerGroup, WorkerSum  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (init_params, param_specs,  # noqa: E402
                                       params_from_jax)
from repro_torch.optim import constant, momentum  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b-smoke"
BASE = ["--device", "cpu", "--arch", ARCH, "--seq", "32", "--batch", "4",
        "--log-every", "1", "--seed", "0"]
STEPS = 3
# the data-parallel tau_max 0 step against the whole-batch exact step
EXACT_TOL = 1e-5
BF16_STEP = 2.0 ** -8
TOPK = ["--sync", "async", "--compressor", "topk", "--tau-max", "2"]
POISON = json.dumps({"events": [{"step": 1, "kind": "grad_poison"}]})
KILL = json.dumps({"events": [{"step": 1, "kind": "kill", "on_attempt": 0}]})
# name: (workers, flags); every case runs STEPS steps and saves the last,
# but "async_topk" runs 4 and saves every 2 (the resume cases start from
# its step 2)
CASES = {
    "async_topk": (2, TOPK),
    "async_onebit": (2, ["--sync", "async", "--compressor", "onebit",
                         "--tau-max", "2"]),
    "async_topk_densified": (2, TOPK + ["--no-overlap"]),
    "async_tau0": (2, ["--sync", "async", "--compressor", "none",
                       "--tau-max", "0"]),
    "topk_ef": (2, ["--sync", "topk_ef"]),
    "onebit_ef": (2, ["--sync", "onebit_ef"]),
    "elastic_budget": (2, ["--sync", "elastic", "--budget-b", "0.1"]),
    "grad_poison": (2, TOPK + ["--fault-plan", POISON]),
    "async_topk_p4": (4, TOPK),
    "topk_ef_p4": (4, ["--sync", "topk_ef"]),
    "onebit_ef_p4": (4, ["--sync", "onebit_ef"]),
}

# one process: run launch.train.main on each (argv, out) of a job file and
# write each run's exact losses, gap metrics and wire bytes
_RUNNER = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import train
    for argv, out in json.load(open(sys.argv[1])):
        hist = train.main(argv)
        with open(out, "w") as f:
            json.dump({k: [r[v] for r in hist] for k, v in (
                ("loss", "loss"), ("wire", "wire_bytes"),
                ("gap", "gap2_over_alpha2"), ("stale", "stale_gap2"))}, f)
""")

# one rank of the port's delivery half fed the reference's gradients of
# its worker (the reference's p = 2 run, _P2_SCRIPT's record)
_PORT_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.workers import WorkerGroup
    from repro_torch.launch.mesh import close, make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_specs
    from repro_torch.optim import constant, momentum

    rank, store, rec, p0, out, steps = sys.argv[1:7]
    rank, steps, rec = int(rank), int(steps), np.load(rec)
    layout = make_host_mesh(backend="gloo", world=2, rank=rank,
                            store_path=store)
    group = WorkerGroup(2, layout)
    cfg = get_config("qwen3-1.7b-smoke")
    specs = param_specs(TF.model_defs(cfg))
    params = load_checkpoint(p0, 0)
    opt = momentum(constant(1e-2), 0.9)
    opt_state = opt.init(T.leaves(params))
    acfg = AsyncConfig(tau_max=2, schedule="uniform", seed=1,
                       compressor="topk", topk_ratio=1 / 8)
    state = init_async_state(acfg, group, params, specs)
    step = make_async_train_step(cfg, opt, acfg, group, specs)
    _, td = T.flatten(params)
    n = len(T.leaves(params))
    metrics = []
    for t in range(steps):
        g = [torch.as_tensor(rec[f"g{t}_{rank}_{i}"]) for i in range(n)]
        params, opt_state, state, m = step.deliver(
            params, opt_state, state, [(torch.zeros(()), T.unflatten(td, g))])
        metrics.append([float(m["stale_gap2"]), m["mean_tau"]])
    save_checkpoint(out, steps, (params, SH.gather_state(state, group)),
                    write=rank == 0)
    if rank == 0:
        json.dump(metrics, open(out + "/metrics.json", "w"))
    close(layout)
""")


def _env(tmp):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                TMPDIR=str(tmp))


def _run(cmd, tmp, timeout=600):
    proc = subprocess.run(cmd, env=_env(tmp), capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, (cmd, proc.stdout[-3000:],
                                  proc.stderr[-3000:])
    return proc.stdout


def _argv(name, ranks, ckpt):
    workers, flags = CASES[name]
    every = ["--steps", "4", "--ckpt-every", "2"] if name == "async_topk" \
        else ["--steps", str(STEPS), "--ckpt-every", str(STEPS)]
    return (BASE + flags + every + ["--workers", str(workers), "--ranks",
                                    str(ranks), "--ckpt-dir", str(ckpt)])


def _run_jobs(runs, tmp, tag):
    """Run ``[(argv, out)]`` one after another in one subprocess."""
    spec = tmp / f"{tag}.json"
    spec.write_text(json.dumps([(a, str(o)) for a, o in runs]))
    return _run([sys.executable, "-c", _RUNNER, str(spec)], tmp)


def _reference_chain(tmp, steps=3):
    """The reference's p = 2 record, then the port's two ranks fed it."""
    rec = tmp / "p2.npz"
    _run([sys.executable, "-c", _P2_SCRIPT, str(rec), str(steps)], tmp)
    p0, out = tmp / "p0", tmp / "port_p2"
    cfg = jax_get_config(ARCH)
    params = jax_init_params(JTF.model_defs(cfg), jax.random.PRNGKey(0))
    save_checkpoint(str(p0), 0, params_from_jax(jax.tree.map(np.asarray,
                                                             params)))
    out.mkdir()
    store = tmp / "p2_store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(r), str(store), str(rec),
         str(p0), str(out), str(steps)], env=_env(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    return rec, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launcher run of the file: the in-process runs in one process,
    the 2-rank runs in three, the supervised run and the reference chain
    beside them; then the two cross-layout resumes."""
    tmp = tmp_path_factory.mktemp("dist")
    out = {name: {r: tmp / name / f"r{r}" for r in (1, 2)} for name in CASES}
    for d in out.values():
        for p in d.values():
            p.mkdir(parents=True)
    one = [(_argv(n, 1, d[1] / "ckpt"), d[1] / "hist.json")
           for n, d in out.items()]
    exact = tmp / "exact"
    one.append((BASE + ["--sync", "exact", "--workers", "2", "--steps",
                        str(STEPS), "--ckpt-every", str(STEPS), "--ckpt-dir",
                        str(exact / "ckpt")], exact / "hist.json"))
    two = [(_argv(n, 2, d[2] / "ckpt"), d[2] / "hist.json")
           for n, d in out.items()]
    sup = tmp / "sup"
    sup_cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
               "--backoff", "0.05", "--fault-plan", KILL, "--",
               *_argv("async_topk", 2, sup / "ckpt")]
    with ThreadPoolExecutor(6) as pool:
        futures = [pool.submit(_run_jobs, one, tmp, "one")]
        futures += [pool.submit(_run_jobs, two[i::3], tmp, f"two{i}")
                    for i in range(3)]
        sup_f = pool.submit(_run, sup_cmd, tmp)
        ref_f = pool.submit(_reference_chain, tmp)
        for f in futures:
            f.result()
        sup_out, reference = sup_f.result(), ref_f.result()

    # the cross-layout resumes, from the uninterrupted runs' step 2
    resumed = {}
    for src, dst in ((2, 1), (1, 2)):
        ckpt = tmp / f"resume_{src}_to_{dst}"
        ckpt.mkdir()
        for suffix in (".npz", ".npz.treedef"):
            shutil.copy(out["async_topk"][src] / "ckpt" /
                        f"step_00000002{suffix}", ckpt)
        resumed[dst] = (_argv("async_topk", dst, ckpt), ckpt / "hist.json")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda kv: _run_jobs([kv[1]], tmp, f"res{kv[0]}"),
                      resumed.items()))
    return {"out": out, "exact": exact, "sup": (sup, sup_out),
            "resumed": resumed, "reference": reference}


def _hist(path):
    return json.loads(pathlib.Path(path).read_text())


def _bits(losses):
    return [float(x).hex() for x in losses]


def _same_checkpoint(a, b, step):
    name = f"step_{step:08d}.npz"
    assert (a / f"{name}.treedef").read_bytes() == \
        (b / f"{name}.treedef").read_bytes()
    with np.load(a / name) as x, np.load(b / name) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            u, v = x[key], y[key]
            assert u.dtype == v.dtype and u.shape == v.shape, key
            assert u.tobytes() == v.tobytes(), f"leaf {key} differs"


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_process_bitwise(runs, name):
    d = runs["out"][name]
    one, two = _hist(d[1] / "hist.json"), _hist(d[2] / "hist.json")
    for key in ("loss", "gap", "stale"):
        assert _bits(two[key]) == _bits(one[key]), key
    assert two["wire"] == one["wire"]
    assert all(w > 0 for w in one["wire"])
    steps = 4 if name == "async_topk" else STEPS
    _same_checkpoint(d[1] / "ckpt", d[2] / "ckpt", steps)
    if name == "grad_poison":
        assert np.isnan(one["loss"][1])
        assert all(np.isfinite(x) for i, x in enumerate(one["loss"]) if i != 1)


def test_tau0_over_ranks_is_the_exact_step(runs):
    """Two workers' mean gradient on 2 ranks against the whole batch's."""
    dp = runs["out"]["async_tau0"][2]
    got, want = _hist(dp / "hist.json"), _hist(runs["exact"] / "hist.json")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=BF16_STEP,
                               atol=0)
    p_dp = load_checkpoint(str(dp / "ckpt"), STEPS)[0]
    p_ex = load_checkpoint(str(runs["exact"] / "ckpt"), STEPS)[0]
    for path, a, b in zip(T.paths(p_dp), T.leaves(p_dp), T.leaves(p_ex)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=EXACT_TOL, err_msg=path)


@pytest.mark.parametrize("dst", [1, 2])
def test_checkpoint_resumes_under_the_other_layout(runs, dst):
    """From the other layout's step 2 to step 4: the uninterrupted run's
    last two losses and its step-4 checkpoint."""
    argv, hist = runs["resumed"][dst]
    want = _hist(runs["out"]["async_topk"][dst] / "hist.json")
    assert _bits(_hist(hist)["loss"]) == _bits(want["loss"][2:])
    ckpt = pathlib.Path(argv[argv.index("--ckpt-dir") + 1])
    for r in (1, 2):
        _same_checkpoint(runs["out"]["async_topk"][r] / "ckpt", ckpt, 4)


def test_supervised_kill_over_two_ranks_resumes_bitwise(runs):
    sup, text = runs["sup"]
    assert "fault: SIGKILL at step 1 (attempt 0)" in text
    assert "rank 0 exited with code -9" in text
    assert "resumed from step 2" in text
    assert "[supervisor] child completed on attempt 1" in text
    printed = [line.split() for line in text.splitlines()
               if line.startswith("step ")]
    want = _hist(runs["out"]["async_topk"][1] / "hist.json")["loss"]
    assert [int(p[1]) for p in printed] == [0, 1, 2, 3]
    assert [p[3] for p in printed] == [f"{x:.6f}" for x in want]
    _same_checkpoint(runs["out"]["async_topk"][1] / "ckpt", sup / "ckpt", 4)


def test_two_ranks_match_the_reference_p2_step(runs):
    """The reference's 2-device step against the port's two ranks fed its
    gradients: the gathered checkpoint holds params, ``acc`` and the
    2-row ``err``."""
    rec_path, out = runs["reference"]
    rec = np.load(rec_path)
    params, state = load_checkpoint(str(out), 3)
    for key, tree in (("p", params), ("acc", state["acc"]),
                      ("err", state["err"])):
        for i, a in enumerate(T.leaves(tree)):
            np.testing.assert_allclose(a.numpy(), rec[f"{key}_{i}"],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{key} leaf {i}")
    assert state["err"]["embed"].shape[0] == 2
    metrics = json.loads((out / "metrics.json").read_text())
    for t, (gap2, tau) in enumerate(metrics):
        np.testing.assert_allclose(np.float32(gap2),
                                   np.float32(rec[f"stale_gap2{t}"]),
                                   rtol=2e-5, atol=TOL)
        assert tau == float(rec[f"mean_tau{t}"])


# ---------------------------------------------------------------------------
# refusals and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,match", [
    (["--ranks", "2", "--workers", "2", "--dist-backend", "nccl"],
     "nccl runs one rank a card"),
    (["--ranks", "3", "--workers", "2"], "must divide"),
])
def test_launcher_refuses_a_layout_before_any_rank(extra, match):
    with pytest.raises(ValueError, match=match):
        train.main(BASE + ["--sync", "topk_ef", "--steps", "1", *extra])


def test_exact_step_refuses_ranks():
    with pytest.raises(SystemExit, match="--sync exact"):
        train.main(BASE + ["--sync", "exact", "--workers", "2", "--ranks",
                           "2", "--steps", "1"])


def test_rank_layout_is_pod_major():
    layout = mesh.RankLayout(world=2, rank=1, backend="gloo")
    assert [list(mesh.RankLayout(3, r, "gloo").local_workers(6))
            for r in range(3)] == [[0, 1], [2, 3], [4, 5]]
    group = WorkerGroup(4, layout)
    assert group.n_local == 2 and group.distributed
    shards = group.shard_batch({"x": torch.arange(8)})
    assert [s["x"].tolist() for s in shards] == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="split evenly"):
        WorkerGroup(3, layout)
    with pytest.raises(ValueError, match="cpu cards"):
        mesh.check_layout(2, 2, "nccl", "cpu")
    assert mesh.rank_device(layout, "cpu") == torch.device("cpu")


def test_one_process_state_is_its_own_whole_layout():
    group = WorkerGroup(2)
    state = {"step": 3, "err": {"w": torch.ones(2, 3)}}
    assert SH.gather_state(state, group) is state
    assert SH.scatter_state(state, state) is state


def _fake_nccl(monkeypatch, other):
    """``dist.all_gather_into_tensor`` of rank 0 of 2, whose peer holds
    ``other``; records the devices of each call's output and input."""
    seen = []

    def gather(out, src):
        seen.append((out.device, src.device))
        out[0].copy_(src)
        out[1].copy_(other.contiguous().reshape(-1).view(torch.uint8))

    monkeypatch.setattr(W.dist, "all_gather_into_tensor", gather)
    return seen


@pytest.mark.parametrize("device", [None, "cpu", "meta"])
def test_nccl_gathers_on_the_rank_device(monkeypatch, device):
    # nccl gathers where the rank's rows live (its card) and only then
    # moves the whole leaf where it was asked for; "meta" stands in for a
    # device other than the rows'
    group = WorkerGroup(2, mesh.RankLayout(2, 0, "nccl"))
    mine = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    other = mine + 100
    seen = _fake_nccl(monkeypatch, other)
    out = group.gather_rows(mine, None if device is None
                            else torch.device(device))
    assert seen == [(mine.device, mine.device)]
    assert out.shape == (2, 2, 3) and out.dtype == torch.float32
    assert out.device == torch.device(device or "cpu")
    if device != "meta":
        assert torch.equal(out, torch.cat([mine, other]))


def test_nccl_rank_writes_the_gathered_checkpoint(monkeypatch, tmp_path):
    # the per-worker leaves of a rank's state are gathered to the host and
    # written whole, as with gloo
    group = WorkerGroup(2, mesh.RankLayout(2, 0, "nccl"))
    mine = torch.arange(4, dtype=torch.bfloat16).reshape(1, 4)
    other = mine * 3
    _fake_nccl(monkeypatch, other)
    state = {"step": 5, "err": {"w": mine}, "acc": {"w": torch.ones(3)}}
    save_checkpoint(str(tmp_path), 5, SH.gather_state(state, group))
    whole = load_checkpoint(str(tmp_path), 5)
    assert torch.equal(whole["err"]["w"], torch.cat([mine, other]))
    assert whole["step"] == 5 and torch.equal(whole["acc"]["w"],
                                              torch.ones(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_worker_sum_one_process_runs_a_sum(dtype):
    # one process adds as the workers come, keeping no worker's tensor,
    # bitwise the sum in worker order, without writing what it was fed
    items = [torch.randn(5, generator=torch.Generator().manual_seed(w)
                         ).to(dtype) for w in range(4)]
    kept = [x.clone() for x in items]
    group = WorkerGroup(4)
    acc = WorkerSum(group)
    for x in items:
        acc.add(x)
        assert acc._rows == []
    want = items[0].float()
    for x in items[1:]:
        want = want + x
    assert torch.equal(acc.mean(), want / 4)
    assert all(torch.equal(x, k) for x, k in zip(items, kept))
    assert group.wire == {"psum": {"count": 1,
                                   "bytes": 2 * items[0].nbytes}}
    assert torch.equal(group.pmean(items), want / 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_worker_sum_over_ranks_is_the_one_process_sum(monkeypatch, dtype):
    # rank 1 of 2, two workers a rank: its rows are gathered with rank 0's
    # and added in worker order, bitwise the one-process sum, with the
    # same bytes counted
    items = [torch.randn(5, generator=torch.Generator().manual_seed(w)
                         ).to(dtype) for w in range(4)]
    group = WorkerGroup(4, mesh.RankLayout(2, 1, "gloo"))
    monkeypatch.setattr(group, "gather_rows",
                        lambda local: torch.cat([torch.stack(items[:2]),
                                                 local]))
    acc = WorkerSum(group)
    for x in items[2:]:
        acc.add(x)
    one = WorkerGroup(4)
    assert torch.equal(acc.total(), one.worker_sum(items))
    assert group.wire == one.wire


# ---------------------------------------------------------------------------
# the wire against the reference's golden inventory
# ---------------------------------------------------------------------------

def _golden_async(tau, comp, overlap=True):
    return "async", AsyncConfig(
        tau_max=tau, schedule="uniform", compressor=comp,
        error_feedback=comp != "none", topk_ratio=1 / 8, horizon=64,
        track_gap=False, overlap=overlap)


def _golden_elastic(strategy, track_gap=False):
    return "elastic", SyncConfig(
        strategy=strategy, track_gap=track_gap,
        gate="static" if strategy == "elastic" else "norm")


# src/repro/analysis/entrypoints.py's configurations of each entry
GOLDEN_ENTRIES = {
    "async_tau0": _golden_async(0, "none"),
    "async_tau4": _golden_async(4, "none"),
    "async_tau4_topk_ef": _golden_async(4, "topk"),
    "async_tau4_topk_ef_densified": _golden_async(4, "topk", False),
    "async_tau4_onebit_ef": _golden_async(4, "onebit"),
    "sync": _golden_elastic("exact"),
    "topk_ef": _golden_elastic("topk_ef"),
    "onebit_ef": _golden_elastic("onebit_ef"),
    "elastic": _golden_elastic("elastic"),
    "topk_ef+gap": _golden_elastic("topk_ef", True),
}
COMPRESSED = ("async_tau4_topk_ef", "async_tau4_onebit_ef", "topk_ef",
              "onebit_ef")


def test_wire_bytes_match_the_golden_inventory():
    golden = json.loads((ROOT / "tests" / "golden" /
                         "collective_inventory.json").read_text())
    assert golden["data_parallel"] == 1 and golden["batch"] == [4, 32]
    cfg = get_config(ARCH)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, 32, 4,
                                         seed=0).batch(0), "cpu")
    port = {}
    for name, (kind, conf) in GOLDEN_ENTRIES.items():
        params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
        opt = momentum(constant(1e-2), 0.9)
        opt_state = opt.init(T.leaves(params))
        group = WorkerGroup(1)
        if kind == "async":
            state = init_async_state(conf, group, params, specs)
            step = make_async_train_step(cfg, opt, conf, group, specs)
        else:
            state = init_dist_sync_state(conf, group, params)
            step = make_elastic_train_step(cfg, opt, conf, group, specs,
                                           static_phase=0)
        group.reset_wire()
        step(params, opt_state, state, batch)
        port[name] = dict(group.wire)
    for name, inv in port.items():
        want = golden["strategies"][name]["collectives"]
        print(f"wire {name}: port "
              + ", ".join(f"{k} {v['bytes']} B in {v['count']}"
                          for k, v in sorted(inv.items()))
              + "; golden " + ", ".join(f"{k} {v['bytes']:.0f} B in "
                                        f"{v['count']}"
                                        for k, v in sorted(want.items())))
    total = {name: sum(v["bytes"] for v in inv.values())
             for name, inv in port.items()}
    for name in COMPRESSED:
        want = golden["strategies"][name]["collectives"]["all_gather"]
        assert port[name]["all_gather"]["bytes"] == want["bytes"], name
        assert total[name] < total["sync"], name
