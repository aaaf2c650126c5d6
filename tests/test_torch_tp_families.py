"""Tensor parallelism (``--model-shards m``) for the MoE, Mamba2 and RWKV6
stacks: expert parallelism (`repro_torch.models.moe`), Mamba2 on a rank's
heads with its scan through K10's plain version here
(`repro_torch.models.mamba2`), RWKV6 on a rank's heads
(`repro_torch.models.rwkv6`), over the data x model grid of
``torch.distributed`` ranks on the CPU over ``gloo``, each smoke config at
batch 4 x 32.  The launch helpers are `test_torch_tp`'s.

Tolerances:

* The forward and backward at ``m = 2`` (two ranks; the MoE also at ``m =
  4``, one expert a rank) against one process at the same params and
  batch, in f32 compute: the loss within ``F32_LOSS_RTOL`` and each
  gradient leaf within ``F32_GRAD_RTOL`` relative (Frobenius), as
  `test_torch_tp` holds the attention stacks (the partial sums add in
  another order; 1.2e-5 the worst leaf seen, mixtral's ``wk``).
* Within the port, bitwise: ``--ranks 4 --workers 2`` against ``--ranks
  2 --workers 2`` (both ``--model-shards 2``), async top-k, every loss and
  every leaf of the final checkpoint, per family; and the MoE at
  ``--model-shards 4`` (one expert a rank), ``--ranks 8`` against
  ``--ranks 4``.
* Against the JAX reference's ``(data 2, model 2)`` mesh (fused async
  top-k for each family, and ``topk_ef`` for the MoE; two steps from the
  reference's step-0 checkpoint, which the port resumes under ``--ranks 4
  --model-shards 2``): losses within ``LOSS_TOL``; over the whole model,
  the params' updates within ``UPDATE_TOL`` relative (Frobenius), the
  momentum within ``MOMENTUM_TOL`` and the state's float leaves (``acc``
  or ``err``) within ``STATE_TOL``; every leaf moved, and the integer
  leaves (``count``, ``step``, ``taus``) equal.  bf16 rounding flips
  top-k picks near the threshold, as at ``m = 1``.  From the same
  checkpoints, the port at ``m = 2`` differs from the reference by up to
  1.7e-3 in a loss, 0.301 in the update, 0.389 in the momentum and 0.386
  in the state (all moonshot's ``topk_ef``; at ``m = 1``, against the
  reference's ``(data 2, model 1)`` run, by up to 3.2e-3, 0.300, 0.456 and
  0.689).  Each bound is about twice the worst ``m = 2`` reading and
  stays well under 1.0, what a leaf left zero or unchanged reads: a port
  that zeroes ``acc`` / ``err`` reads 1.0 in the state and fails.  The
  whole model is the measure here, not each leaf as in `test_torch_tp`:
  at these sizes a leaf of 8 to 256 entries (Mamba2's ``d_skip``,
  RWKV6's ``bonus_u``) holds one or a few picks a row, and one flipped
  pick moves all of it (``d_skip``'s update differs by 1.11 relative at
  ``m = 1``; ``bonus_u``, whose entries move by up to 1.5 in two steps,
  by 0.27 in one entry at ``m = 2``).
* The refusals raise before any rank starts.

Every run is a subprocess pinned to one intra-op thread; runs that do not
depend on each other start together.
"""
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp import (_FWD_RANK, _REF22, F32_GRAD_RTOL,  # noqa: E402
                           F32_LOSS_RTOL, REF_FLAGS, REF_STEPS, ROOT, TOPK,
                           _bits, _env, _hist, _port_like, _rel, _run,
                           _run_jobs, _same_checkpoint, no_rank)

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

MIXTRAL, MOONSHOT = "mixtral-8x7b-smoke", "moonshot-v1-16b-a3b-smoke"
ZAMBA2, RWKV6 = "zamba2-7b-smoke", "rwkv6-1.6b-smoke"
STEPS = 3
LOSS_TOL = 7e-3
UPDATE_TOL = 0.6
MOMENTUM_TOL = 0.8
STATE_TOL = 0.8
# the forward/backward cases: (arch, model shards)
FWD_CASES = {"mixtral_m2": (MIXTRAL, 2), "zamba2_m2": (ZAMBA2, 2),
             "rwkv6_m2": (RWKV6, 2), "mixtral_m4": (MIXTRAL, 4)}
# async top-k at two layouts: name -> (arch, model shards, the two --ranks)
BITWISE = {MOONSHOT: (MOONSHOT, 2, (4, 2)), MIXTRAL: (MIXTRAL, 2, (4, 2)),
           ZAMBA2: (ZAMBA2, 2, (4, 2)), RWKV6: (RWKV6, 2, (4, 2)),
           "mixtral_m4": (MIXTRAL, 4, (8, 4))}
# the reference's (data 2, model 2) runs the port resumes
REF_CASES = ((MOONSHOT, "async"), (MOONSHOT, "topk_ef"), (ZAMBA2, "async"),
             (RWKV6, "async"))


def _base(arch, workers=2, model=2):
    return ["--device", "cpu", "--arch", arch, "--seq", "32", "--batch", "4",
            "--log-every", "1", "--seed", "0", "--workers", str(workers),
            "--model-shards", str(model)]


def _forward_case(tmp, name):
    """The one process and the ``m`` ranks of one forward/backward case."""
    arch, m = FWD_CASES[name]
    d = tmp / f"fwd_{name}"
    d.mkdir()
    cmds = [(d / "one.npz", 0, 1)] + [(d / "many.npz", r, m)
                                      for r in range(m)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FWD_RANK, arch, "0", "f32",
         str(d / "store"), str(r), str(size), str(out)], env=_env(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for out, r, size in cmds]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    return d


def _reference_case(tmp, arch, kind):
    """The reference's (data 2, model 2) run of ``arch``, then the port
    resumed from its step-0 checkpoint under 4 ranks of 2 model shards."""
    ref, port = tmp / f"ref_{arch}_{kind}", tmp / f"port_{arch}_{kind}"
    _run([sys.executable, "-c", _REF22, kind, str(ref), str(REF_STEPS),
          arch], tmp)
    path = save_checkpoint(str(port), 0, _port_like(kind, 2, arch))
    with np.load(path) as got, np.load(ref / "step_00000000.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
    shutil.copy(ref / "step_00000000.npz", path)
    argv = (_base(arch) + REF_FLAGS[kind]
            + ["--steps", str(REF_STEPS), "--ckpt-every", str(REF_STEPS),
               "--ranks", "4", "--ckpt-dir", str(port)])
    _run_jobs([(argv, port / "hist.json")], tmp, f"ref_{arch}_{kind}")
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file, started together: the forward and
    backward ranks, the launcher's runs, the reference's runs and the
    port's resumes of them."""
    tmp = tmp_path_factory.mktemp("tp_families")
    out = {}
    jobs = []
    for name, (arch, m, ranks) in BITWISE.items():
        out[name] = {}
        for r in ranks:
            p = out[name][r] = tmp / name / f"r{r}"
            p.mkdir(parents=True)
            jobs.append((_base(arch, 2, m) + TOPK + [
                "--steps", str(STEPS), "--ckpt-every", str(STEPS),
                "--ranks", str(r), "--ckpt-dir", str(p / "ckpt")],
                p / "hist.json"))
    with ThreadPoolExecutor(12) as pool:
        ref_f = {c: pool.submit(_reference_case, tmp, *c) for c in REF_CASES}
        futures = [pool.submit(_run_jobs, jobs[i::5], tmp, f"jobs{i}")
                   for i in range(5)]
        fwd_f = {k: pool.submit(_forward_case, tmp, k) for k in FWD_CASES}
        for f in futures:
            f.result()
        forward = {k: f.result() for k, f in fwd_f.items()}
        reference = {c: f.result() for c, f in ref_f.items()}
    return {"out": out, "forward": forward, "reference": reference}


# ---------------------------------------------------------------------------
# the forward and backward at m = 2 (and the MoE at m = 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_and_backward_match_one_process(runs, name):
    d = runs["forward"][name]
    with np.load(d / "one.npz") as one, np.load(d / "many.npz") as many:
        assert sorted(one.files) == sorted(many.files)
        np.testing.assert_allclose(many["loss"], one["loss"],
                                   rtol=F32_LOSS_RTOL, atol=0)
        for key in one.files:
            assert many[key].shape == one[key].shape, key
            assert _rel(many[key], one[key]) <= F32_GRAD_RTOL, \
                (key, _rel(many[key], one[key]))


# ---------------------------------------------------------------------------
# bitwise within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BITWISE))
def test_more_ranks_equal_fewer_bitwise(runs, name):
    many, few = (runs["out"][name][r] for r in BITWISE[name][2])
    a, b = _hist(many / "hist.json"), _hist(few / "hist.json")
    assert len(a["loss"]) == STEPS
    assert all(np.isfinite(x) for x in a["loss"])
    assert _bits(a["loss"]) == _bits(b["loss"])
    _same_checkpoint(many / "ckpt", few / "ckpt", STEPS)


def _whole_rel(pairs) -> float:
    """The relative Frobenius difference of ``(got, want)`` pairs taken
    together."""
    num = sum(float(np.sum((np.asarray(a, np.float64) - b) ** 2))
              for a, b in pairs)
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2))
              for _, b in pairs)
    return (num / den) ** 0.5


# ---------------------------------------------------------------------------
# against the reference's (data 2, model 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", REF_CASES)
def test_port_matches_the_reference_on_a_data_model_grid(runs, arch, kind):
    ref, port = runs["reference"][(arch, kind)]
    got = _hist(port / "hist.json")["loss"]
    want = json.loads((ref / "losses.json").read_text())
    assert len(got) == len(want) == REF_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    n_params = len(T.leaves(_port_like(kind, 2, arch)[0]))
    name = f"step_{REF_STEPS:08d}.npz"
    with np.load(port / name) as a, np.load(ref / name) as b, \
            np.load(ref / "step_00000000.npz") as z:
        assert sorted(a.files) == sorted(b.files)
        updates, floats = [], []
        for i in range(len(a.files)):
            k = str(i)
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if i < n_params:
                moved = b[k].astype(np.float64) - z[k]
                assert np.linalg.norm(moved) > 0, k
                updates.append((a[k].astype(np.float64) - z[k], moved))
            elif a[k].dtype.kind == "f":
                floats.append((a[k], b[k]))
            else:
                assert np.array_equal(a[k], b[k]), k
    # the count, then the momentum (one leaf a param), then the state
    moms, state = floats[:n_params], floats[n_params:]
    assert len(moms) == n_params and state
    rels = (_whole_rel(updates), _whole_rel(moms), _whole_rel(state))
    assert rels[0] <= UPDATE_TOL, rels
    assert rels[1] <= MOMENTUM_TOL, rels
    assert rels[2] <= STATE_TOL, rels


# ---------------------------------------------------------------------------
# the refusals: each before any rank starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,m,what,why", [
    # 4 experts (and heads); 4 ssm heads; RWKV6's 8 heads of 16 channels:
    # at 16 shards the reference would cut dinner (128) inside a head
    (MIXTRAL, 8, "experts 4", "layers/moe/w_gate"),
    (ZAMBA2, 8, "heads 4", "layers/mamba/a_log"),
    (RWKV6, 16, "heads 8", "cut an RWKV6 head")])
def test_shards_that_cut_experts_or_heads_are_refused(no_rank, arch, m,
                                                      what, why):
    argv = _base(arch, 1, m) + ["--sync", "topk_ef", "--steps", "1",
                                "--ranks", str(m)]
    with pytest.raises(ValueError, match=f"must divide .*{what}.*{why}"):
        train.main(argv)
    # the largest m each runs at: the experts, or the heads, one a rank
    TF.check_tensor_parallel(get_config(arch), m // 2)
