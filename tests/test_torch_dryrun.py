"""The port's dry run (`repro_torch.launch.dryrun`), its layout pieces
(`launch/mesh.make_production_mesh`, the FSDP ``param_specs``,
`dist/sharding.make_act_rules`, `data/pipeline.make_batch_specs`) and
sequence parallelism (`models/actx` ``gather_seq`` / ``scatter_seq``),
against the JAX reference, on the CPU.

Tolerances:

* ``input_specs``' shapes, ``should_skip``, ``pick_optimizer``,
  ``use_fsdp``, rank 0's shard shapes under the (16, 16) specs (FSDP on
  and off) and the activation rules (sequence parallelism on and off, on
  both production meshes; the reference's built on a ``jax.sharding.
  AbstractMesh``): exactly the reference's.
* A dry-run record of ``qwen3-1.7b-smoke`` ``train_4k`` on a one-device
  layout: the reference's record keys; its FLOPs (FlopCounterMode: the
  products, forward and backward) within ``FLOPS_BAND`` of the
  reference's jitted step's ``cost_analysis()["flops"]`` on one device
  (every scan unrolled, ``remat=False``: the port keeps the activations).
  XLA also counts the elementwise work (softmax, norms, the optimizer);
  the port read 0.922 of it on this sandbox's CPU.
* On two gloo ranks (one launch, f32 compute): the sequence-parallel
  step's loss and gradients against the ``--model-shards 2`` step's at
  ``test_torch_tp``'s ``F32_LOSS_RTOL`` / ``F32_GRAD_RTOL``; its
  reduce-scatter plus all-gather bytes equal the all-reduce's, less the
  norm scales' gradient sums sequence parallelism adds (each rank's
  norm acts on its own positions).  In the same ranks, against one
  process at the same tolerances: the kv projections of fewer kv heads
  than ranks (qwen3 smoke with 1 kv head) and the MoE with fewer experts
  than ranks (mixtral smoke with 3 experts, sharded on ``ff``); and the
  dense serving steps under the model group (prefill and 3 greedy decode
  steps of qwen3, its 1-kv-head form, zamba2 and rwkv6): every token
  equal, the last logits within ``F32_GRAD_RTOL``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

jax.devices()        # the backend first: the reference's dry run sets
_xla = os.environ.get("XLA_FLAGS")   # XLA_FLAGS when it is imported
from repro.launch import dryrun as JDR  # noqa: E402
if _xla is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import param_specs as jparam_specs  # noqa: E402

from test_torch_tp import F32_GRAD_RTOL, F32_LOSS_RTOL, ROOT, _env, _rel  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, REGISTRY, get_config  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (count_params, param_specs,  # noqa: E402
                                       shard_shape)

# the port's FLOPs over the reference's cost_analysis (read 0.922)
FLOPS_BAND = (0.88, 1.0)
ARCHS = list(REGISTRY)


# ---------------------------------------------------------------------------
# inputs and the reference's choices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("qwen3-1.7b", "train_4k"), ("internvl2-2b", "prefill_32k"),
    ("musicgen-large", "train_4k"), ("rwkv6-1.6b", "decode_32k"),
])
def test_input_specs_shapes_match_the_reference(arch, shape):
    want = JDR.input_specs(jget(arch), J_SHAPES[shape],
                           JTF.RunFlags(remat=False))
    got = DR.input_specs(get_config(arch), INPUT_SHAPES[shape])
    assert {k: tuple(v.shape) for k, v in got["batch"].items()} \
        == {k: tuple(v.shape) for k, v in want["batch"].items()}
    assert all(v.device.type == "meta" for v in got["batch"].values())
    if "cache" in want:
        # the reference's stacked state tree against the port's: the same
        # state shapes (the reference adds a scalar ``pos`` leaf; the
        # port's is an int)
        wshapes = sorted(tuple(x.shape) for x in jax.tree.leaves(
            want["cache"]) if x.shape)
        gshapes = sorted(tuple(x.shape) for x in
                         T.leaves(got["cache"]["state"]))
        assert gshapes == wshapes
    else:
        assert "cache" not in got


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_optimizer_and_fsdp_choices_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for name in INPUT_SHAPES:
        assert (DR.should_skip(cfg, INPUT_SHAPES[name]) is None) \
            == (JDR.should_skip(jcfg, J_SHAPES[name]) is None), name
    assert DR.pick_optimizer(cfg)[1] == JDR.pick_optimizer(jcfg)[1]
    assert DR.use_fsdp(cfg) == JDR.use_fsdp(jcfg)


def _jshard(shape, spec, sizes):
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for n, s in zip(shape, spec):
        names = () if s is None else ((s,) if isinstance(s, str) else s)
        div = 1
        for a in names:
            div *= sizes[a]
        out.append(n // div)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_shards_match_the_reference_specs(arch):
    sizes = {"data": 16, "model": 16}
    defs, jdefs = TF.model_defs(get_config(arch)), \
        JTF.model_defs(jget(arch))
    for fsdp in ((), ("data",)):
        got = [shard_shape(d.shape, sp, sizes) for d, sp in zip(
            T.leaves(defs), T.leaves(param_specs(defs, sizes, fsdp)))]
        want = [_jshard(d.shape, sp, sizes) for d, sp in zip(
            jax.tree.leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes")),
            jax.tree.leaves(jparam_specs(jdefs, sizes, fsdp),
                            is_leaf=lambda x: isinstance(x, P)))]
        assert got == want, fsdp


@pytest.mark.parametrize("arch", ARCHS)
def test_act_rules_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        jmesh = AbstractMesh(mesh.shape, mesh.axis_names)
        for sp in (False, True):
            for batch_axes in (True, False):
                kw = dict(batch_size=256, seq_len=4096,
                          sequence_parallel=sp, batch_axes=batch_axes)
                want = JSH.make_act_rules(jcfg, jmesh, **kw)
                got = SH.make_act_rules(cfg, mesh, **kw)
                assert got == {k: tuple(v.spec) + (None,) * (
                    len(got[k]) - len(tuple(v.spec)))
                    for k, v in want.items()}, (multi, sp, batch_axes)
    assert make_production_mesh().sizes == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)


# ---------------------------------------------------------------------------
# a record against the reference's cost analysis
# ---------------------------------------------------------------------------

def _reference_flops(arch, shape):
    from repro.data.pipeline import make_batch_specs
    from repro.dist.train import make_train_step
    from repro.models.params import abstract_params
    from repro.models.scan_utils import set_cost_unroll
    from repro.optim import momentum
    cfg = jget(arch)
    opt = momentum(1e-2, 0.9)
    ab = abstract_params(JTF.model_defs(cfg))
    step = make_train_step(cfg, opt, JTF.RunFlags(remat=False))
    set_cost_unroll(True)
    try:
        compiled = jax.jit(step).lower(
            ab, jax.eval_shape(opt.init, ab),
            make_batch_specs(cfg, J_SHAPES[shape])).compile()
    finally:
        set_cost_unroll(False)
    return float(JDR._cost_analysis(compiled)["flops"])


def test_record_has_the_reference_keys_and_its_flops(monkeypatch):
    arch, shape = "qwen3-1.7b-smoke", "train_4k"
    # the record on one device, as the reference's cost analysis below
    monkeypatch.setattr(DR, "make_production_mesh", lambda multi_pod: (
        ProductionMesh((1, 1), ("data", "model"))))
    rec = DR.run_one(arch, shape, False)
    assert rec["status"] == "ok"
    for key in ("arch", "shape", "mesh", "sync", "params", "active_params",
                "sequence_parallel", "status", "lower_s", "compile_s",
                "memory", "cost_analysis_raw", "costs"):
        assert key in rec, key
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_per_device_gb"):
        assert key in rec["memory"], key
    # params and momentum, f32, updated in place
    n = count_params(TF.model_defs(get_config(arch)))
    assert rec["memory"]["argument_bytes"] == 2 * 4 * n
    assert rec["memory"]["alias_bytes"] == 2 * 4 * n
    want = _reference_flops(arch, shape)
    ratio = rec["cost_analysis_raw"]["flops"] / want
    print(f"port FLOPs {rec['cost_analysis_raw']['flops']:.6e}, reference "
          f"cost_analysis {want:.6e}: {ratio:.4f}")
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1]
    assert rec["roofline"]["bound_s"] > 0


def test_full_attention_long_context_is_skipped():
    rec = DR.run_one("qwen3-1.7b", "long_500k", False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def test_production_layout_traces_a_model_sharded_rank():
    # the smoke's 4 heads at a (4, 4) layout: the recording model group
    # counts the Megatron sums, the worker group the gradient mean
    mesh = ProductionMesh((4, 4), ("data", "model"))
    rec = DR.trace_cell(get_config("qwen3-1.7b-smoke"), mesh,
                        INPUT_SHAPES["train_4k"])
    axes = rec["collectives_by_axis"]
    assert set(axes) == {"data", "model"}
    assert axes["data"]["psum"]["bytes"] == rec["memory"][
        "argument_bytes"] + 8     # the gradients (params' bytes) + the loss
    assert rec["roofline"]["links"]["model"] == "nvlink"


# ---------------------------------------------------------------------------
# two gloo ranks: sequence parallelism, the fallbacks, serving
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.sharding import WorkerRows
    from repro_torch.dist.train import (make_decode_step, make_prefill_step,
                                        mean_grads)
    from repro_torch.launch.mesh import close, make_host_mesh
    from repro_torch.models import actx, layers, transformer as TF
    from repro_torch.models.params import init_params, param_specs

    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    m = 2
    layers.COMPUTE_DTYPE = TF.COMPUTE_DTYPE = torch.float32
    layout = make_host_mesh(backend="gloo", world=m, rank=rank,
                            store_path=store, model=m)
    wire = {}
    def count(kind, n):
        wire[kind] = wire.get(kind, 0) + n
    group = actx.ModelGroup(layout, count)
    SP = {"residual": (None, "model", None)}
    rec, bytes_ = {}, {}

    def params_of(cfg, sharded):
        defs = TF.model_defs(cfg)
        size = m if sharded else 1
        specs = param_specs(defs, {"model": size})
        return init_params(defs, torch.Generator().manual_seed(0), "cpu",
                           specs=specs, rank=rank if sharded else 0,
                           size=size), specs

    def grads(tag, cfg, sharded, rules=None):
        params, specs = params_of(cfg, sharded)
        batch = to_device(SyntheticLMDataset(cfg.vocab_size, 32, 4,
                                             seed=0).batch(0), "cpu")
        actx.install(group if sharded else None)
        wire.clear()
        with actx.rules(rules):
            loss, _, g = mean_grads(cfg, params, batch)
        bytes_[tag] = dict(wire)
        rec[f"{tag}/loss"] = loss.numpy()
        for path, leaf, sp in zip(T.paths(g), T.leaves(g), T.leaves(specs)):
            dim = actx.model_dim(sp)
            whole = WorkerRows(leaf, None, dim).gather() \\
                if sharded and dim is not None else leaf
            rec[f"{tag}/{path}"] = whole.numpy()
        actx.install(None)

    def serve(tag, cfg, sharded):
        params, _ = params_of(cfg, sharded)
        actx.install(group if sharded else None)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, size=(2, 16)))
        prefill, decode = make_prefill_step(cfg, 24), make_decode_step(cfg)
        with torch.no_grad():
            tok, cache = prefill(params, {"tokens": tokens})
            toks = [tok]
            for _ in range(3):
                tok, cache = decode(params, cache, toks[-1][:, None].long())
                toks.append(tok)
            logits, _ = TF.decode_step(cfg, params, cache,
                                       toks[-1][:, None].long())
            start = TF.logits_vocab_start(cfg)
            if start is not None:
                logits = group.gather_dim(logits, 2)
        rec[f"{tag}/tokens"] = torch.stack(toks, 1).numpy()
        rec[f"{tag}/logits"] = logits.numpy()
        actx.install(None)

    qwen3 = get_config("qwen3-1.7b-smoke")
    kv1 = dataclasses.replace(qwen3, n_kv_heads=1)
    moe3 = dataclasses.replace(get_config("mixtral-8x7b-smoke"),
                               n_experts=3)
    grads("tp", qwen3, True)
    grads("sp", qwen3, True, SP)
    for tag, cfg in (("kv1", kv1), ("moe3", moe3)):
        grads(f"{tag}_tp", cfg, True)
        grads(f"{tag}_one", cfg, False)
    for tag, name in (("qwen3", None), ("kv1", None),
                      ("zamba2", "zamba2-7b-smoke"),
                      ("rwkv6", "rwkv6-1.6b-smoke")):
        cfg = kv1 if tag == "kv1" else get_config(name or
                                                  "qwen3-1.7b-smoke")
        serve(f"serve_{tag}_tp", cfg, True)
        serve(f"serve_{tag}_one", cfg, False)
    if rank == 0:
        np.savez(out + ".npz", **rec)
        json.dump(bytes_, open(out + ".json", "w"))
    close(layout)
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    out = tmp / "out"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(tmp / "store"), str(r), str(out)],
        env=_env(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    import json
    with np.load(str(out) + ".npz") as f:
        rec = {k: f[k] for k in f.files}
    return rec, json.loads((tmp / "out.json").read_text())


def _same_grads(rec, a, b):
    keys = [k[len(a) + 1:] for k in rec if k.startswith(a + "/")]
    assert keys and sorted(keys) == sorted(
        k[len(b) + 1:] for k in rec if k.startswith(b + "/"))
    np.testing.assert_allclose(rec[f"{a}/loss"], rec[f"{b}/loss"],
                               rtol=F32_LOSS_RTOL, atol=0)
    for k in keys:
        if k != "loss":
            assert rec[f"{a}/{k}"].shape == rec[f"{b}/{k}"].shape, k
            assert _rel(rec[f"{a}/{k}"], rec[f"{b}/{k}"]) <= F32_GRAD_RTOL, \
                (k, _rel(rec[f"{a}/{k}"], rec[f"{b}/{k}"]))


def test_sequence_parallel_step_equals_the_model_sharded_step(ranks):
    rec, wire = ranks
    _same_grads(rec, "sp", "tp")
    sp, tp = wire["sp"], wire["tp"]
    cfg = get_config("qwen3-1.7b-smoke")
    # each layer's two norm scales and the final norm, f32, summed over
    # the group (twice the payload) under sequence parallelism only
    norms = 2 * 4 * cfg.d_model * (2 * cfg.n_layers + 1)
    assert sp["model_reduce_scatter"] > 0
    rs_ag = sp["model_reduce_scatter"] + sp["model_all_gather"] \
        - tp["model_all_gather"]
    assert rs_ag == tp["model_psum"] - (sp["model_psum"] - norms)
    print(f"sequence parallelism: reduce-scatter {sp['model_reduce_scatter']}"
          f" B + all-gather {rs_ag - sp['model_reduce_scatter']} B; the "
          f"model-sharded step's activation all-reduce "
          f"{tp['model_psum'] - sp['model_psum'] + norms} B")


@pytest.mark.parametrize("tag", ["kv1", "moe3"])
def test_fallback_shards_equal_one_process(ranks, tag):
    _same_grads(ranks[0], f"{tag}_tp", f"{tag}_one")


@pytest.mark.parametrize("tag", ["qwen3", "kv1", "zamba2", "rwkv6"])
def test_serving_over_model_shards_equals_one_process(ranks, tag):
    rec = ranks[0]
    got, want = rec[f"serve_{tag}_tp/tokens"], rec[f"serve_{tag}_one/tokens"]
    np.testing.assert_array_equal(got, want)
    assert _rel(rec[f"serve_{tag}_tp/logits"],
                rec[f"serve_{tag}_one/logits"]) <= F32_GRAD_RTOL


def test_kv_heads_fewer_than_ranks_fall_back():
    cfg = dataclasses.replace(get_config("qwen3-1.7b-smoke"), n_kv_heads=1)
    TF.check_tensor_parallel(cfg, 2)
    assert TF.kv_fallback(cfg, 2) and TF.local_kv_heads(cfg, 2) == 1
    for name in ("qwen3-1.7b", "mixtral-8x7b", "grok-1-314b",
                 "mistral-nemo-12b", "internvl2-2b"):
        TF.check_tensor_parallel(get_config(name), 16)
