"""The port's tensor parallelism (``--model-shards m``): the data x model
grid of ``torch.distributed`` ranks (`repro_torch.launch.mesh`), the
Megatron collectives (`repro_torch.models.actx`), the model-axis half of
`repro_torch.dist.sharding` and the launcher, on the CPU over ``gloo``,
qwen3-1.7b-smoke at batch 4 x 32 unless stated.

Tolerances:

* The specs: the port's ``param_specs`` equal the reference's for every
  config at ``model`` 2, 4 and 16, exactly.
* The forward and backward at ``m = 2`` (two ranks) against one process
  at the same params and batch: in f32 compute (both processes' compute
  dtype patched to f32) the loss within ``F32_LOSS_RTOL`` and each
  gradient leaf within ``F32_GRAD_RTOL`` relative (Frobenius): the two
  ranks' partial sums add in another order, and without qk-norm the
  random attention amplifies that to about 1e-5 (mistral-nemo-smoke,
  1.1e-5 seen).  In the bf16 compute the runs use, qwen3 only, at
  ``BF16_LOSS_RTOL`` and ``BF16_GRAD_RTOL``: each row-parallel partial
  sum is rounded to bf16 before the sum (1.05e-2 the worst leaf seen).
  mistral-nemo-smoke has no qk-norm, and its bf16 gradients differ from
  its own f32 ones by 0.6-0.9 relative in one process, so only f32 holds
  its tensor-parallel gradients to anything.
* Within the port, bitwise: ``--ranks 4 --workers 2`` against ``--ranks
  2 --workers 2`` (both ``--model-shards 2``): every loss and every leaf
  of the final checkpoint (its sidecar too), for async top-k and one-bit,
  the densified top-k (``--no-overlap``), ``topk_ef``, ``onebit_ef``,
  ``elastic --budget-b 0.1`` and a ``grad_poison`` plan under the guard; a
  checkpoint resumed under the other layout; a supervised ``kill``.  The
  fused and densified runs hold each other's losses and params within
  ``FUSED_TOL`` (the engine's own parity tolerance): they add the workers'
  payloads in another order, and over these four steps their momentum
  differed in the last bit in three leaves while the losses and params
  came out equal.  ``--sync exact --ranks 2 --model-shards 2`` holds
  the one-process exact step at ``BF16_LOSS_RTOL`` (losses) and
  ``EXACT_TOL`` absolute (params after three steps of lr 3e-3 from bf16
  gradients that differ as above; 1.13e-5 the worst entry seen).
* Against the JAX reference's ``(data 2, model 2)`` mesh (fused async
  top-k and ``topk_ef``, two steps from the reference's step-0
  checkpoint, which the port resumes under ``--ranks 4 --model-shards
  2``): losses within ``MODEL_TOL``; params within two steps of ``lr *
  0.05`` and each leaf's update within ``UPDATE_TOL`` relative; the
  momentum, ``acc`` and ``err`` leaves within ``STATE_TOL`` relative
  (Frobenius).  bf16 rounding flips top-k picks near the threshold, as
  at ``m = 1``: from the same checkpoint the accepted ``m = 1`` port
  differs from the reference's ``(data 2, model 1)`` run by up to 0.19
  (an ``acc`` leaf) and 0.072 (an update); at ``m = 2``, 0.146 (an
  ``err`` leaf) and 0.108.  Each bound is about twice the worst ``m = 1``
  value seen.
* The refusals raise before any rank starts.

Every run is a subprocess pinned to one intra-op thread; runs that do not
depend on each other start together.
"""
import dataclasses
import json
import multiprocessing
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
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import param_specs as jax_param_specs  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SyncConfig  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state)
from repro_torch.dist.train import init_dist_sync_state  # noqa: E402
from repro_torch.dist.workers import WorkerGroup  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.models import actx  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (init_params, param_specs,  # noqa: E402
                                       params_from_jax)
from repro_torch.optim import constant, momentum  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b-smoke"
LR = 3e-3                      # the launcher's default
BASE = ["--device", "cpu", "--arch", ARCH, "--seq", "32", "--batch", "4",
        "--log-every", "1", "--seed", "0", "--workers", "2",
        "--model-shards", "2"]
STEPS = 3
F32_LOSS_RTOL = 1e-6
F32_GRAD_RTOL = 5e-5
BF16_LOSS_RTOL = 2.0 ** -8
BF16_GRAD_RTOL = 3e-2
FUSED_TOL = 1e-5
EXACT_TOL = 1e-4
MODEL_TOL = 2e-2
UPDATE_TOL = 0.15
STATE_TOL = 0.4
TOPK = ["--sync", "async", "--compressor", "topk", "--tau-max", "2"]
POISON = json.dumps({"events": [{"step": 1, "kind": "grad_poison"}]})
KILL = json.dumps({"events": [{"step": 1, "kind": "kill", "on_attempt": 0}]})
# name: flags; every case runs STEPS steps and saves the last, but the
# LONG ones run 4 and save every 2 (the resume cases start from
# async_topk's step 2)
CASES = {
    "async_topk": TOPK,
    "async_onebit": ["--sync", "async", "--compressor", "onebit",
                     "--tau-max", "2"],
    "async_topk_densified": TOPK + ["--no-overlap"],
    "topk_ef": ["--sync", "topk_ef"],
    "onebit_ef": ["--sync", "onebit_ef"],
    "elastic_budget": ["--sync", "elastic", "--budget-b", "0.1"],
    "grad_poison": TOPK + ["--fault-plan", POISON],
}
LONG = ("async_topk", "async_topk_densified")
# the forward/backward cases: (arch, vocab override or 0, compute dtype)
FWD_CASES = {
    "qwen3_f32": (ARCH, 0, "f32"),
    "qwen3_bf16": (ARCH, 0, "bf16"),
    "nemo_untied_f32": ("mistral-nemo-12b-smoke", 0, "f32"),
    "qwen3_vocab509_f32": (ARCH, 509, "f32"),
    "gemma3_windows_f32": ("gemma3-27b-smoke", 0, "f32"),
}

# one process: run launch.train.main on each (argv, out) of a job file and
# write each run's exact losses
_RUNNER = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import train
    for argv, out in json.load(open(sys.argv[1])):
        hist = train.main(argv)
        with open(out, "w") as f:
            json.dump({"loss": [r["loss"] for r in hist]}, f)
""")

# one launcher run comparing its final params with the initial ones
_COMPARE_RUNNER = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.checkpoint import checkpoint_leaves, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dist.workers import WorkerGroup
    from repro_torch.launch import train
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    if __name__ == "__main__":
        argv, out, init_dir = json.loads(sys.argv[1]), sys.argv[2], \
            sys.argv[3]
        args = train._parse(argv)
        cfg = get_config(args.arch)
        defs = TF.model_defs(cfg)
        params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
        opt_state, state, _ = train._build(args, cfg, WorkerGroup(
            args.workers), params, param_specs(defs, {"model": 1}))
        init = (params, opt_state, state)
        save_checkpoint(init_dir, 0, init)
        rep = {}
        train.main(argv, report=rep, compare_to=checkpoint_leaves(init))
        json.dump({"leaf_max_abs": rep["leaf_max_abs"],
                   "leaf_l2": rep["leaf_l2"]}, open(out, "w"))
""")

# one rank (or, at m = 1, the one process) of the forward and backward
# check: the loss and every gradient leaf, gathered whole, to an .npz
_FWD_RANK = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.sharding import WorkerRows
    from repro_torch.dist.train import mean_grads
    from repro_torch.launch.mesh import close, make_host_mesh
    from repro_torch.models import actx, layers, transformer as TF
    from repro_torch.models.params import init_params, param_specs

    arch, vocab, dtype, store, rank, m, out = sys.argv[1:8]
    rank, m, vocab = int(rank), int(m), int(vocab)
    if dtype == "f32":
        layers.COMPUTE_DTYPE = TF.COMPUTE_DTYPE = torch.float32
    cfg = get_config(arch)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": m})
    if m > 1:
        layout = make_host_mesh(backend="gloo", world=m, rank=rank,
                                store_path=store, model=m)
        actx.install(actx.ModelGroup(layout))
    params = init_params(defs, torch.Generator().manual_seed(0), "cpu",
                         specs=specs, rank=rank, size=m)
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, 32, 4,
                                         seed=0).batch(0), "cpu")
    loss, _, grads = mean_grads(cfg, params, batch)
    rec = {"loss": loss.numpy()}
    for path, g, sp in zip(T.paths(grads), T.leaves(grads),
                           T.leaves(specs)):
        dim = actx.model_dim(sp)
        whole = WorkerRows(g, None, dim).gather() if dim is not None \\
            and m > 1 else g
        rec[path] = whole.numpy()
    if rank == 0:
        np.savez(out, **rec)
    if m > 1:
        close(layout)
""")

# the reference on a (data 2, model 2) host mesh: its step-0 checkpoint,
# then two steps of the fused async top-k or topk_ef step and the step-2
# checkpoint, with the launcher's settings
_REF22 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import save_checkpoint
    from repro.configs import get_config
    from repro.core.scheduler import SyncConfig
    from repro.data.pipeline import SyntheticLMDataset
    from repro.dist import sharding as SH
    from repro.dist import async_engine as JAE
    from repro.dist.train import init_dist_sync_state, make_elastic_train_step
    from repro.jax_compat import make_mesh
    from repro.models import transformer as TF
    from repro.models.params import init_params, param_specs
    from repro.optim import momentum

    kind, out, steps, arch = sys.argv[1:5]
    steps = int(steps)
    cfg = get_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"))
    flags = TF.RunFlags(remat=False)
    defs = TF.model_defs(cfg)
    pspecs = param_specs(defs, SH.axis_sizes(mesh))
    params = init_params(defs, jax.random.PRNGKey(0))
    opt = momentum(3e-3, 0.9)
    opt_state = opt.init(params)
    if kind == "async":
        acfg = JAE.AsyncConfig(tau_max=2, schedule="uniform",
                               axis_names=("data",), compressor="topk",
                               topk_ratio=1 / 16, horizon=1024, seed=0,
                               overlap=True)
        state = JAE.init_async_state(acfg, mesh, params, pspecs)
        step = JAE.make_async_train_step(cfg, opt, mesh, acfg, pspecs, flags)
    else:
        scfg = SyncConfig(strategy="topk_ef", axis_names=("data",),
                          topk_ratio=1 / 16, beta=0.9, budget_b=0.0,
                          gate="norm")
        state = init_dist_sync_state(scfg, mesh, params)
        step = make_elastic_train_step(cfg, opt, mesh, scfg, pspecs, flags)
    step = jax.jit(step)
    params = jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), pspecs,
        params, is_leaf=lambda x: isinstance(x, P))
    save_checkpoint(out, 0, (params, opt_state, state))
    data = SyntheticLMDataset(cfg.vocab_size, 32, 4, seed=0)
    losses = []
    for t in range(steps):
        params, opt_state, state, m = step(params, opt_state, state,
                                           data.batch(t))
        losses.append(float(m["loss"]))
    save_checkpoint(out, steps, (params, opt_state, state))
    json.dump(losses, open(os.path.join(out, "losses.json"), "w"))
""")
REF_STEPS = 2
REF_FLAGS = {"async": TOPK, "topk_ef": ["--sync", "topk_ef"]}


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


def _run_jobs(runs, tmp, tag):
    """Run ``[(argv, out)]`` one after another in one subprocess."""
    spec = tmp / f"{tag}.json"
    spec.write_text(json.dumps([(a, str(o)) for a, o in runs]))
    return _run([sys.executable, "-c", _RUNNER, str(spec)], tmp)


def _argv(name, ranks, ckpt):
    every = ["--steps", "4", "--ckpt-every", "2"] if name in LONG \
        else ["--steps", str(STEPS), "--ckpt-every", str(STEPS)]
    return BASE + CASES[name] + every + ["--ranks", str(ranks),
                                         "--ckpt-dir", str(ckpt)]


def _forward_case(tmp, name):
    """The one process and the two ranks of one forward/backward case."""
    arch, vocab, dtype = FWD_CASES[name]
    d = tmp / f"fwd_{name}"
    d.mkdir()
    cmds = [(d / "one.npz", 0, 1), (d / "two.npz", 0, 2),
            (d / "two.npz", 1, 2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FWD_RANK, arch, str(vocab), dtype,
         str(d / "store"), str(r), str(m), str(out)], env=_env(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for out, r, m in cmds]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    return d


def _port_like(kind, model, arch=ARCH):
    """The port's whole-layout (params, opt_state, state) of the launcher's
    two-worker ``kind`` run of ``arch`` at ``model`` shards (values
    unused)."""
    cfg = get_config(arch)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": model})
    params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    opt_state = momentum(constant(LR), 0.9).init(T.leaves(params))
    if kind == "async":
        state = init_async_state(
            AsyncConfig(tau_max=2, compressor="topk", topk_ratio=1 / 16,
                        horizon=1024), WorkerGroup(2), params, specs)
    else:
        state = init_dist_sync_state(SyncConfig(strategy="topk_ef",
                                                topk_ratio=1 / 16),
                                     WorkerGroup(2), params)
    return params, opt_state, state


def _reference_case(tmp, kind):
    """The reference's (data 2, model 2) run, then the port resumed from
    its step-0 checkpoint under 4 ranks of 2 model shards."""
    ref, port = tmp / f"ref_{kind}", tmp / f"port_{kind}"
    _run([sys.executable, "-c", _REF22, kind, str(ref), str(REF_STEPS),
          ARCH], tmp)
    # the port's sidecar for the reference's arrays: the leaves match in
    # order, dtype and shape (tests/test_torch_ckpt.py)
    path = save_checkpoint(str(port), 0, _port_like(kind, 2))
    with np.load(path) as got, np.load(ref / "step_00000000.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
    shutil.copy(ref / "step_00000000.npz", path)
    argv = (BASE[:-4] + ["--workers", "2", "--model-shards", "2"]
            + REF_FLAGS[kind] + ["--steps", str(REF_STEPS), "--ckpt-every",
                                 str(REF_STEPS), "--ranks", "4",
                                 "--ckpt-dir", str(port)])
    _run_jobs([(argv, port / "hist.json")], tmp, f"ref_{kind}")
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file: the launcher's runs in four
    processes, the supervised run, the forward/backward ranks and the
    reference cases beside them; then the two cross-layout resumes."""
    tmp = tmp_path_factory.mktemp("tp")
    out = {name: {r: tmp / name / f"r{r}" for r in (2, 4)} for name in CASES}
    for d in out.values():
        for p in d.values():
            p.mkdir(parents=True)
    jobs = [(_argv(n, r, d[r] / "ckpt"), d[r] / "hist.json")
            for n, d in out.items() for r in (4, 2)]
    exact = {m: tmp / f"exact_m{m}" for m in (1, 2)}
    for m, d in exact.items():
        argv = BASE[:-4] + ["--workers", "1", "--sync", "exact", "--steps",
                            str(STEPS), "--ckpt-every", str(STEPS),
                            "--ckpt-dir", str(d / "ckpt")]
        if m == 2:
            argv += ["--ranks", "2", "--model-shards", "2"]
        jobs.append((argv, d / "hist.json"))
    compare = tmp / "compare"
    compare_argv = _argv("topk_ef", 4, compare / "ckpt")
    compare.mkdir()
    (compare / "run.py").write_text(_COMPARE_RUNNER)
    sup = tmp / "sup"
    sup_cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
               "--backoff", "0.05", "--fault-plan", KILL, "--",
               *_argv("async_topk", 4, sup / "ckpt")]
    with ThreadPoolExecutor(8) as pool:
        futures = [pool.submit(_run_jobs, jobs[i::4], tmp, f"jobs{i}")
                   for i in range(4)]
        ref_f = {k: pool.submit(_reference_case, tmp, k) for k in REF_FLAGS}
        sup_f = pool.submit(_run, sup_cmd, tmp)
        compare_f = pool.submit(_run, [sys.executable,
                                       str(compare / "run.py"),
                                       json.dumps(compare_argv),
                                       str(compare / "out.json"),
                                       str(compare / "init")], tmp)
        fwd_f = {k: pool.submit(_forward_case, tmp, k) for k in FWD_CASES}
        for f in futures:
            f.result()
        sup_out = sup_f.result()
        compare_f.result()
        reference = {k: f.result() for k, f in ref_f.items()}
        forward = {k: f.result() for k, f in fwd_f.items()}

    # the cross-layout resumes, from the uninterrupted runs' step 2
    resumed = {}
    for src, dst in ((4, 2), (2, 4)):
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
            "compare": compare,
            "resumed": resumed, "reference": reference, "forward": forward}


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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / ref) if ref else \
        float(np.linalg.norm(a - b))


# ---------------------------------------------------------------------------
# the specs and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [2, 4, 16])
def test_param_specs_equal_the_reference(model):
    for name in JAX_REGISTRY:
        want = jax.tree.leaves(
            jax_param_specs(JTF.model_defs(jax_get_config(name)),
                            {"model": model}),
            is_leaf=lambda x: isinstance(x, P))
        got = T.leaves(param_specs(TF.model_defs(get_config(name)),
                                   {"model": model}))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            # a PartitionSpec may leave its trailing replicated dims out
            w = tuple(w) + (None,) * (len(g) - len(tuple(w)))
            assert tuple(g) == w, name


@pytest.mark.parametrize("shape,spec,m", [
    ((4, 6, 2), (None, "model", None), 2), ((8, 3), ("model", None), 4),
    ((4, 6), (None, None), 2), ((2, 16), (None, "model"), 16)])
def test_shard_leaf_round_trips(shape, spec, m):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    parts = [SH.shard_leaf(x, spec, j, m) for j in range(m)]
    dim = actx.model_dim(spec)
    for part in parts:
        assert part.shape == (x.shape if dim is None else
                              x.shape[:dim] + (x.shape[dim] // m,)
                              + x.shape[dim + 1:])
    assert torch.equal(SH.unshard_leaf(parts, spec), x)
    # the reference's arrays carried over whole, each rank keeping its slice
    carried = [params_from_jax({"w": x.numpy()}, specs={"w": spec}, rank=j,
                               size=m)["w"] for j in range(m)]
    assert all(torch.equal(c, p) and c.is_contiguous()
               for c, p in zip(carried, parts))


def test_rank_layout_is_data_major_model_minor():
    layouts = [mesh.RankLayout(4, r, "gloo", 2) for r in range(4)]
    assert [(lo.data_rank, lo.model_rank) for lo in layouts] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert layouts[3].data_peers() == [1, 3]
    assert layouts[3].model_peers() == [2, 3]
    assert [list(lo.local_workers(4)) for lo in layouts] == \
        [[0, 1], [0, 1], [2, 3], [2, 3]]
    group = WorkerGroup(2, layouts[2])
    assert group.distributed and list(group.local) == [1]
    assert not WorkerGroup(2, mesh.RankLayout(2, 1, "gloo", 2)).distributed


def test_sync_state_specs_split_the_model_dims():
    cfg = get_config(ARCH)
    specs = param_specs(TF.model_defs(cfg), {"model": 2})
    state = {"err": {}, "buf": {}, "acc": {}, "step": 0, "taus": None}
    got = SH.sync_state_specs(state, specs)
    wq = specs["layers"]["attn"]["wq"]
    assert got["err"]["layers"]["attn"]["wq"] == (None,) + tuple(wq)
    assert got["buf"]["layers"]["attn"]["wq"] == (None, None) + tuple(wq)
    assert got["acc"]["layers"]["attn"]["wq"] == (None, "model", None)
    assert got["acc"]["layers"]["attn"]["q_norm"] == (None, None, None)
    assert got["step"] is None and got["taus"] is None
    opt = SH.opt_state_specs({"count": 0, "mu": [0] * len(T.leaves(specs))},
                             specs)
    assert opt["count"] is None and opt["mu"] == T.leaves(specs)


def test_rows_reach_the_compressor_contiguous(monkeypatch):
    # a (L, d) leaf sharded on d permutes to (d, L): K1 on the card takes
    # contiguous rows only, so the rows are copied, and the residual is
    # written back into the leaf's layout; the densified round agrees
    from repro_torch.core import scheduler as S
    seen = []
    real = S.CR.topk_compress_rows

    def spy(rows, err_rows, ratio, *, out_err=None):
        seen.append(rows.is_contiguous() and (
            err_rows is None or err_rows.is_contiguous()))
        return real(rows, err_rows, ratio, out_err=out_err)

    monkeypatch.setattr(S.CR, "topk_compress_rows", spy)
    gen = torch.Generator().manual_seed(0)
    g = torch.randn((8, 6), generator=gen)
    err = torch.randn((8, 6), generator=gen)
    spec = (None, "model")
    dense, want_err = S.ef_compress_leaf(g, err, spec, "topk", 0.5)
    mine = err.clone()
    payload, got_err = S.ef_compress_leaf_compact(g, mine, spec, "topk",
                                                  0.5)
    assert seen == [True, True]
    assert got_err is mine and torch.equal(mine, want_err)
    rows = torch.zeros((6, 8)).scatter_add_(1, payload["idx"].long(),
                                            payload["vals"])
    assert torch.equal(rows.t(), dense)


# ---------------------------------------------------------------------------
# the forward and backward at m = 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_and_backward_match_one_process(runs, name):
    d = runs["forward"][name]
    f32 = FWD_CASES[name][2] == "f32"
    loss_rtol = F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL
    grad_rtol = F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL
    with np.load(d / "one.npz") as one, np.load(d / "two.npz") as two:
        assert sorted(one.files) == sorted(two.files)
        np.testing.assert_allclose(two["loss"], one["loss"], rtol=loss_rtol,
                                   atol=0)
        for key in one.files:
            assert two[key].shape == one[key].shape, key
            assert _rel(two[key], one[key]) <= grad_rtol, \
                (key, _rel(two[key], one[key]))
    if FWD_CASES[name][1]:
        # an odd vocab: embed shards on embed, and is gathered whole
        spec = param_specs(TF.model_defs(
            dataclasses.replace(get_config(ARCH), vocab_size=509)),
            {"model": 2})["embed"]
        assert actx.model_dim(spec) == 1


# ---------------------------------------------------------------------------
# bitwise within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_equal_two_bitwise(runs, name):
    d = runs["out"][name]
    four, two = _hist(d[4] / "hist.json"), _hist(d[2] / "hist.json")
    assert _bits(four["loss"]) == _bits(two["loss"])
    steps = 4 if name in LONG else STEPS
    _same_checkpoint(d[4] / "ckpt", d[2] / "ckpt", steps)
    if name == "grad_poison":
        assert np.isnan(four["loss"][1])
        assert all(np.isfinite(x) for i, x in enumerate(four["loss"])
                   if i != 1)


def test_rank_zero_compares_the_whole_final_params(runs):
    # rank 0 gathers each final leaf of the params, the optimizer state and
    # the sync state whole and reports its largest difference from the
    # leaves it was given (here the run's initial state, in the one-process
    # layout), and the difference's norm: exactly that of the run's own
    # final checkpoint, leaf by leaf (the norm within f32 summation)
    compare = runs["compare"]
    out = json.loads((compare / "out.json").read_text())
    n_params = len(T.leaves(TF.model_defs(get_config(ARCH))))
    with np.load(compare / "ckpt" / f"step_{STEPS:08d}.npz") as final, \
            np.load(compare / "init" / "step_00000000.npz") as init:
        assert sorted(final.files) == sorted(init.files)
        assert list(out["leaf_max_abs"]) == [str(i) for i in
                                              range(len(init.files))]
        assert len(init.files) > n_params
        for key, got in out["leaf_max_abs"].items():
            a, b = final[key], init[key]
            assert a.dtype == b.dtype and a.dtype.kind in "fi", key
            diff = a - b if a.dtype.kind == "f" \
                else a.astype(np.int64) - b
            want = float(np.abs(diff).max()) if diff.size else 0.0
            assert got == want, key
            assert want > 0 or int(key) >= n_params, key
            np.testing.assert_allclose(
                out["leaf_l2"][key], np.linalg.norm(diff.astype(np.float64)),
                rtol=1e-5, err_msg=key)


def test_fused_walks_the_densified_trajectory(runs):
    from repro_torch.checkpoint import load_checkpoint
    fused, dense = (runs["out"][n][4] for n in LONG)
    np.testing.assert_allclose(_hist(fused / "hist.json")["loss"],
                               _hist(dense / "hist.json")["loss"],
                               rtol=FUSED_TOL, atol=0)
    a = load_checkpoint(str(fused / "ckpt"), 4)[0]
    b = load_checkpoint(str(dense / "ckpt"), 4)[0]
    for path, x, y in zip(T.paths(a), T.leaves(a), T.leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=FUSED_TOL, err_msg=path)


def test_exact_step_over_model_shards_is_the_one_process_step(runs):
    from repro_torch.checkpoint import load_checkpoint
    got = _hist(runs["exact"][2] / "hist.json")["loss"]
    want = _hist(runs["exact"][1] / "hist.json")["loss"]
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL, atol=0)
    a = load_checkpoint(str(runs["exact"][2] / "ckpt"), STEPS)[0]
    b = load_checkpoint(str(runs["exact"][1] / "ckpt"), STEPS)[0]
    for path, x, y in zip(T.paths(a), T.leaves(a), T.leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=EXACT_TOL, err_msg=path)


@pytest.mark.parametrize("dst", [2, 4])
def test_checkpoint_resumes_under_the_other_layout(runs, dst):
    argv, hist = runs["resumed"][dst]
    want = _hist(runs["out"]["async_topk"][dst] / "hist.json")
    assert _bits(_hist(hist)["loss"]) == _bits(want["loss"][2:])
    ckpt = pathlib.Path(argv[argv.index("--ckpt-dir") + 1])
    for r in (2, 4):
        _same_checkpoint(runs["out"]["async_topk"][r] / "ckpt", ckpt, 4)


def test_supervised_kill_over_the_grid_resumes_bitwise(runs):
    sup, text = runs["sup"]
    assert "fault: SIGKILL at step 1 (attempt 0)" in text
    assert "rank 0 exited with code -9" in text
    assert "resumed from step 2" in text
    assert "[supervisor] child completed on attempt 1" in text
    printed = [line.split() for line in text.splitlines()
               if line.startswith("step ")]
    want = _hist(runs["out"]["async_topk"][4] / "hist.json")["loss"]
    assert [int(p[1]) for p in printed] == [0, 1, 2, 3]
    assert [p[3] for p in printed] == [f"{x:.6f}" for x in want]
    _same_checkpoint(runs["out"]["async_topk"][4] / "ckpt", sup / "ckpt", 4)


# ---------------------------------------------------------------------------
# against the reference's (data 2, model 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(REF_FLAGS))
def test_port_matches_the_reference_on_a_data_model_grid(runs, kind):
    ref, port = runs["reference"][kind]
    got = _hist(port / "hist.json")["loss"]
    want = json.loads((ref / "losses.json").read_text())
    assert len(got) == len(want) == REF_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL)
    n_params = len(T.leaves(_port_like(kind, 2)[0]))
    name = f"step_{REF_STEPS:08d}.npz"
    with np.load(port / name) as a, np.load(ref / name) as b, \
            np.load(ref / "step_00000000.npz") as z:
        assert sorted(a.files) == sorted(b.files)
        for i in range(n_params):
            k = str(i)
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=REF_STEPS * LR * 0.05,
                                       err_msg=f"param leaf {k}")
            moved = b[k].astype(np.float64) - z[k]
            assert np.linalg.norm(moved) > 0, k
            assert _rel(a[k].astype(np.float64) - z[k], moved) <= \
                UPDATE_TOL, (k, _rel(a[k].astype(np.float64) - z[k], moved))
        # count, momentum, then the state's leaves (acc or err, step, taus)
        for i in range(n_params, len(a.files)):
            k = str(i)
            assert a[k].shape == b[k].shape, k
            if a[k].dtype.kind == "f":
                assert _rel(a[k], b[k]) <= STATE_TOL, (k, _rel(a[k], b[k]))
            else:
                assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the refusals: each before any rank starts
# ---------------------------------------------------------------------------

@pytest.fixture
def no_rank(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a rank was started")
    monkeypatch.setattr(multiprocessing, "get_context", refuse)


def test_model_shards_must_divide_the_ranks(no_rank):
    with pytest.raises(ValueError, match="must divide --ranks"):
        train.main(BASE + ["--sync", "topk_ef", "--steps", "1", "--ranks",
                           "3"])
    with pytest.raises(ValueError, match="must divide --ranks"):
        train.main(BASE + ["--sync", "topk_ef", "--steps", "1"])


def test_heads_that_do_not_divide_are_refused(no_rank):
    # qwen3-smoke has 4 heads: at 8 model shards wq falls back to embed
    argv = BASE + ["--sync", "topk_ef", "--steps", "1", "--ranks", "8"]
    argv[argv.index("--workers") + 1] = "1"
    argv[argv.index("--model-shards") + 1] = "8"
    with pytest.raises(ValueError, match="must divide heads 4"):
        train.main(argv)


def test_checkpoint_of_another_model_shards_is_refused(tmp_path, no_rank,
                                                       monkeypatch):
    # a fused async checkpoint at m = 1 ((cap, 1, R) rings) under m = 2
    ckpt = tmp_path / "ckpt"
    params, opt_state, state = _port_like("async", 1)
    save_checkpoint(str(ckpt), 2, (params, opt_state, state))
    with pytest.raises(ValueError, match="does not match"):
        train.main(BASE + TOPK + ["--steps", "4", "--ranks", "2",
                                  "--ckpt-dir", str(ckpt)])
