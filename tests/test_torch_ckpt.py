"""Checkpoints of the port (`repro_torch.checkpoint`) and the trainer's
resume (`repro_torch.launch.train --ckpt-dir`), on the CPU.

Every comparison here is bitwise (tolerance 0):

* the round trip of every state the launcher saves — exact, ``topk_ef``,
  ``onebit_ef``, ``elastic``, async fused and densified — with bf16
  leaves, Python ints and the numpy tau table, restored in place (every
  ``like`` tensor keeps its storage) and into a new tree;
* the torn-checkpoint rules: a checkpoint without a readable sidecar is
  skipped with a warning, an orphan sidecar is invisible, a failed
  ``.npz`` write leaves no ``.npz``; the resume check's message;
* the ``.npz`` arrays, leaf for leaf, against those of the checkpoint that
  the reference's ``save_checkpoint`` writes of the same state, built by
  the reference's own init functions and filled by key path;
* ``launch.train`` run 4 steps with ``--ckpt-every 2``, then resumed to 8,
  against an uninterrupted 8-step run: the losses and every leaf of the
  final checkpoint, for async top-k at ``tau_max`` 2 ``roundrobin`` and
  ``--sync topk_ef``.
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.scheduler import SyncConfig as JSyncConfig  # noqa: E402
from repro.dist import async_engine as JAE  # noqa: E402
from repro.dist import sharding as SH  # noqa: E402
from repro.dist.train import init_dist_sync_state as jax_sync_init  # noqa: E402
from repro.jax_compat import make_mesh  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import param_specs as jax_param_specs  # noqa: E402
from repro.optim import momentum as jax_momentum  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import ckpt as C  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SyncConfig  # noqa: E402
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state)
from repro_torch.dist.train import init_dist_sync_state  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import init_params, param_specs  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

ARCH = "qwen3-1.7b-smoke"


def _fill(tree, gen):
    """Random values in every float tensor (in place), so a restore that
    drops or swaps a leaf shows."""
    for x in T.leaves(tree) if isinstance(tree, dict) else tree:
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=gen))
    return tree


def _launcher_state(kind: str, n_workers: int = 2):
    """(params, opt_state, sync_state) as the launcher builds it for
    ``kind``, filled with random values."""
    cfg = get_config(ARCH)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    gen = torch.Generator().manual_seed(1)
    params = init_params(defs, gen, "cpu")
    opt_state = momentum(constant(1e-2), 0.9).init(T.leaves(params))
    opt_state["count"] = 7
    if kind == "exact":
        state = {"step": 0}
    elif kind.startswith("async"):
        acfg = AsyncConfig(tau_max=2, compressor="topk",
                           overlap=kind == "async_fused")
        state = init_async_state(acfg, n_workers, params, specs)
        state["step"] = 5
    else:
        state = init_dist_sync_state(SyncConfig(strategy=kind), n_workers,
                                     params)
        state["step"] = 3
    for part in (opt_state["mu"], state.get("acc"), state.get("buf"),
                 state.get("err"), state.get("residual")):
        if part is not None:
            _fill(part, gen)
    return params, opt_state, state


def _zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return type(tree)(0) if tree is not None else None


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return []


def _same(a, b, where="tree"):
    """Bitwise equality of two trees: the same containers, leaf kinds,
    dtypes and bytes."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert a.shape == b.shape, where
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    else:
        assert type(a) is type(b) and a == b, where


KINDS = ("exact", "topk_ef", "onebit_ef", "elastic", "async_fused",
         "async_densified")


@pytest.mark.parametrize("kind", KINDS)
def test_launcher_state_round_trip_in_place(tmp_path, kind):
    params, opt_state, state = _launcher_state(kind)
    serving = {"embed": params["embed"].to(torch.bfloat16),
               "scale": torch.tensor(0.5, dtype=torch.bfloat16)}
    saved = (params, opt_state, state, serving)
    save_checkpoint(str(tmp_path), 6, saved)
    assert latest_step(str(tmp_path)) == 6
    like = _zeros_like(saved)
    ptrs = [x.data_ptr() for x in _tensors(like)]
    out = load_checkpoint(str(tmp_path), 6, like=like)
    _same(out, saved)
    assert [x.data_ptr() for x in _tensors(out)] == ptrs
    fresh = load_checkpoint(str(tmp_path), 6)
    _same(fresh, saved)
    assert isinstance(fresh[1]["count"], int)
    assert isinstance(fresh[2]["step"], int)


def test_latest_step_skips_torn_checkpoint(tmp_path):
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 4, tree)
    save_checkpoint(str(tmp_path), 8, tree)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert latest_step(str(tmp_path)) == 8
    (tmp_path / "step_00000008.npz.treedef").unlink()
    with pytest.warns(UserWarning, match="torn write"):
        assert latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError, match="latest_step"):
        load_checkpoint(str(tmp_path), 8)
    _same(load_checkpoint(str(tmp_path), 4), tree)
    (tmp_path / "step_00000004.npz.treedef").write_bytes(b"\x00garbage")
    with pytest.warns(UserWarning, match="torn write"):
        assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "nope")) is None


def test_orphan_sidecar_is_invisible(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(2)})
    (tmp_path / "step_00000003.npz").unlink()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert latest_step(str(tmp_path)) is None


def test_failed_npz_write_leaves_no_npz(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 2, {"w": torch.ones(4)})
    calls = []

    def failing(out, arr, allow_pickle=False):
        calls.append(arr.shape)
        raise OSError("disk full")

    monkeypatch.setattr(C.np.lib.format, "write_array", failing)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(tmp_path), 4, {"w": torch.ones(4)})
    assert calls
    names = sorted(os.listdir(tmp_path))
    # the sidecar landed first and stays an orphan; no .npz, no temp file
    assert names == ["step_00000002.npz", "step_00000002.npz.treedef",
                     "step_00000004.npz.treedef"]
    assert latest_step(str(tmp_path)) == 2


def test_in_place_load_checks_structure_before_writing(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3), "b": 2})
    like = {"a": torch.zeros(4), "b": 0}
    with pytest.raises(ValueError, match="float32"):
        load_checkpoint(str(tmp_path), 1, like=like)
    assert torch.equal(like["a"], torch.zeros(4)) and like["b"] == 0
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(str(tmp_path), 1, like={"a": torch.zeros(3)})


def _argv(ckpt_dir, steps, *extra):
    return ["--device", "cpu", "--arch", ARCH, "--seq", "32", "--batch", "4",
            "--workers", "2", "--steps", str(steps), "--log-every", "100",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2", *extra]


def test_resume_check_message(tmp_path):
    async_args = ("--sync", "async", "--compressor", "topk")
    train.main(_argv(tmp_path, 2, *async_args, "--tau-max", "2"))
    with pytest.raises(ValueError, match="does not match the current "
                       "--sync configuration"):
        train.main(_argv(tmp_path, 4, *async_args, "--tau-max", "1"))


# ---------------------------------------------------------------------------
# leaf for leaf against the reference's checkpoint of the same state
# ---------------------------------------------------------------------------

def _key_name(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _port_value(port, path):
    """The port's leaf at the reference's key path (the port keeps the
    momentum leaves as a list in sorted-key order)."""
    node, params_paths = port, T.paths(port[0])
    keys = [_key_name(k) for k in path]
    if keys[:2] == ["1", "mu"]:
        return port[1]["mu"][params_paths.index("/".join(keys[2:]))]
    for k in keys:
        node = node[int(k)] if isinstance(node, (tuple, list)) else node[k]
    return node


@pytest.mark.parametrize("kind", ("exact", "topk_ef", "elastic",
                                  "async_fused", "async_densified"))
def test_npz_matches_reference_checkpoint(tmp_path, kind):
    port = _launcher_state(kind, n_workers=1)
    port_path = save_checkpoint(str(tmp_path / "port"), 6, port)

    cfg = jax_get_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    defs = JTF.model_defs(cfg)
    jparams = jax_init_params(defs, jax.random.PRNGKey(0))
    jopt = jax_momentum(1e-2, 0.9).init(jparams)
    if kind == "exact":
        jstate = {"step": jnp.zeros((), jnp.int32)}
    elif kind.startswith("async"):
        acfg = JAE.AsyncConfig(tau_max=2, compressor="topk",
                               axis_names=("data",),
                               overlap=kind == "async_fused")
        jstate = JAE.init_async_state(
            acfg, mesh, jparams, jax_param_specs(defs, SH.axis_sizes(mesh)))
    else:
        jstate = jax_sync_init(JSyncConfig(strategy=kind,
                                           axis_names=("data",)),
                               mesh, jparams)
    ref_tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(
            _port_value(port, path)).astype(np.asarray(a).dtype).reshape(
                np.shape(a)),
        (jparams, jopt, jstate))
    ref_path = jax_save(str(tmp_path / "ref"), 6, ref_tree)
    with np.load(port_path) as got, np.load(ref_path) as want:
        missing = sorted(set(want.files) ^ set(got.files), key=int)
        assert not missing, f"leaves without a counterpart: {missing}"
        for key in want.files:
            a, b = got[key], want[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), f"leaf {key}"


# ---------------------------------------------------------------------------
# the launcher: resumed == uninterrupted, bitwise
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "async_topk_roundrobin": ("--sync", "async", "--compressor", "topk",
                              "--tau-max", "2", "--async-schedule",
                              "roundrobin"),
    "topk_ef": ("--sync", "topk_ef"),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resumed_run_is_bitwise_uninterrupted(tmp_path, case, capsys):
    extra = RESUME_CASES[case]
    whole = train.main(_argv(tmp_path / "whole", 8, *extra))
    first = train.main(_argv(tmp_path / "cut", 4, *extra))
    capsys.readouterr()
    rest = train.main(_argv(tmp_path / "cut", 8, *extra))
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["step"] for r in first + rest] == list(range(8))
    assert [r["loss"] for r in first + rest] == [r["loss"] for r in whole]
    a = load_checkpoint(str(tmp_path / "whole"), 8)
    b = load_checkpoint(str(tmp_path / "cut"), 8)
    _same(b, a)
