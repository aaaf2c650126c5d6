"""Checkpoints of nested state: one ``.npz`` of the leaves plus a JSON
structure sidecar (counterpart of ``repro.checkpoint.ckpt``).

Files: ``step_%08d.npz`` holds the leaves under the keys ``"0"`` ...
``"n-1"`` in the reference's leaf order (tuple elements and list items in
order, dict keys sorted, ``None`` holding no leaf), so its arrays are those
of the reference's checkpoint of the same state.  The sidecar
``step_%08d.npz.treedef`` is the port's own: JSON naming every container
(tuple, list, dict and its keys, ``None``) and every leaf's kind (torch
tensor, numpy array, Python int or float), dtype and shape.  Python
ints are written as 0-d int32, as the reference holds its counters;
bfloat16 tensors, which numpy cannot hold, as their ``uint16`` bits, the
dtype recorded in the sidecar.

Crash ordering, as the reference's: the sidecar is replaced into place
*before* the ``.npz``, each written to a ``tempfile.mkstemp`` file first and
moved with ``os.replace``.  A kill between the two leaves a sidecar without
arrays, which :func:`latest_step` (keyed on the ``.npz``) never sees; an
``.npz`` whose sidecar is missing or unreadable is skipped with a warning.

Memory: the ``.npz`` is written leaf by leaf (``zipfile`` and
``np.lib.format.write_array``, the format ``np.savez`` writes), so the host
holds one leaf at a time.  With ``like=``, :func:`load_checkpoint` restores
in place into the tensors and arrays of ``like``, leaf by leaf, after
checking the whole structure against the sidecar, so no second copy of
the state is allocated on the device.

Workers over ranks: a tree may hold `repro_torch.dist.sharding.WorkerRows`
leaves (a rank's rows of a per-worker leaf, and under ``--model-shards m``
its model slice of a sharded leaf: ``sharding.gather_state``,
``sharding.shard_view``).  Such a leaf is written whole, gathered over the
ranks when the writer reaches it, so every rank calls
:func:`save_checkpoint` with the same tree and one of them (``write``)
writes the file a one-process run would write (with ``m > 1``, the file
of the reference's ``--model-shards m`` run).  A restore into one scatters
each rank's part in place, each rank reading the file itself, so a
checkpoint resumes under any layout of the same ``m``.
:func:`check_checkpoint` checks a checkpoint against a state without
reading its arrays.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.dist.sharding import WorkerRows

FORMAT = "repro_torch.checkpoint/1"


def _atomic_replace(dirname: str, path: str, write_fn) -> None:
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _describe(tree, leaves: list):
    """Sidecar node of ``tree``; appends its leaves to ``leaves`` in the
    reference's order."""
    if tree is None:
        return {"kind": "none"}
    if isinstance(tree, tuple):
        return {"kind": "tuple",
                "items": [_describe(x, leaves) for x in tree]}
    if isinstance(tree, list):
        return {"kind": "list", "items": [_describe(x, leaves) for x in tree]}
    if isinstance(tree, dict):
        keys = sorted(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpoint dict keys must be str: {keys}")
        return {"kind": "dict", "keys": keys,
                "items": [_describe(tree[k], leaves) for k in keys]}
    leaves.append(tree)
    if isinstance(tree, (torch.Tensor, WorkerRows)):
        return {"kind": "tensor", "dtype": str(tree.dtype).split(".")[-1],
                "shape": list(tree.shape)}
    if isinstance(tree, np.ndarray):
        return {"kind": "ndarray", "dtype": tree.dtype.str,
                "shape": list(tree.shape)}
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return {"kind": type(tree).__name__}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree)}")


def checkpoint_leaves(tree) -> list:
    """``tree``'s leaves in the order :func:`save_checkpoint` writes them:
    leaf ``i`` is the ``.npz``'s array ``"i"``."""
    leaves: list = []
    _describe(tree, leaves)
    return leaves


def _host_array(leaf) -> np.ndarray:
    """One leaf as the numpy array written to the ``.npz`` (a
    :class:`WorkerRows` is gathered over the ranks first)."""
    if isinstance(leaf, WorkerRows):
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    if isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf, np.float64)


def _write_npz(f, arrays) -> None:
    """``np.savez``'s format, one leaf in host memory at a time."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, arr in enumerate(arrays):
            with zf.open(f"{i}.npy", "w", force_zip64=True) as out:
                np.lib.format.write_array(
                    out, np.require(arr, requirements="C"),
                    allow_pickle=False)
            del arr


def _host_arrays(tree):
    """``tree``'s sidecar node, its leaf count and a generator of its
    leaves' host arrays in the reference's order, one leaf at a time,
    gathering per-worker leaves over the ranks.  Every rank must consume
    the generator whole, in the same order: :func:`_drain` takes part in
    the gathers of the leaves left."""
    leaves: list = []
    node = _describe(tree, leaves)
    return node, len(leaves), (_host_array(leaf) for leaf in leaves)


def _drain(arrays) -> None:
    for _ in arrays:
        pass


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    write: bool = True) -> str | None:
    """Write ``tree`` as checkpoint ``step``; returns the ``.npz`` path.
    With ``write=False`` (the ranks that do not write) it only takes part
    in gathering the tree's :class:`WorkerRows` leaves, and returns
    ``None``."""
    node, n_leaves, arrays = _host_arrays(tree)
    if not write:
        _drain(arrays)
        return None
    sidecar = json.dumps({"format": FORMAT, "n_leaves": n_leaves,
                          "tree": node}).encode()
    path = _path(ckpt_dir, step)
    try:
        os.makedirs(ckpt_dir, exist_ok=True)
        # sidecar FIRST: once the .npz lands, its manifest already exists
        _atomic_replace(ckpt_dir, path + ".treedef",
                        lambda f: f.write(sidecar))
        _atomic_replace(ckpt_dir, path, lambda f: _write_npz(f, arrays))
    except OSError:
        # the other ranks wait in the remaining leaves' gathers
        _drain(arrays)
        raise
    return path


def _read_sidecar(path: str) -> dict:
    with open(path + ".treedef", "rb") as f:
        meta = json.loads(f.read().decode())
    if meta.get("format") != FORMAT:
        raise ValueError(f"unknown checkpoint format {meta.get('format')!r}")
    return meta


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step whose checkpoint is actually loadable.  Checkpoints
    missing a readable sidecar (torn write, lost file) are skipped with a
    warning instead of poisoning the resume."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in sorted(os.listdir(ckpt_dir)):
        if not (f.startswith("step_") and f.endswith(".npz")):
            continue
        step = int(f[len("step_"):-len(".npz")])
        try:
            _read_sidecar(os.path.join(ckpt_dir, f))
            steps.append(step)
        except Exception:
            warnings.warn(
                f"skipping checkpoint {f}: missing/unreadable treedef "
                f"sidecar (torn write?)", stacklevel=2)
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _check_like(node: dict, like, where: str) -> None:
    """Raise ``ValueError`` unless ``like`` has the sidecar's structure,
    leaf kinds, shapes and dtypes."""
    kind = node["kind"]
    kinds = {"none": type(None), "tuple": tuple, "list": list, "dict": dict,
             "tensor": (torch.Tensor, WorkerRows), "ndarray": np.ndarray,
             "int": int, "float": float}
    if not isinstance(like, kinds[kind]) or isinstance(like, bool):
        raise ValueError(f"{where}: checkpoint holds a {kind}, the state a "
                         f"{type(like).__name__}")
    if kind == "dict":
        if sorted(like) != node["keys"]:
            raise ValueError(f"{where}: checkpoint keys {node['keys']}, the "
                             f"state's {sorted(like)}")
        for key, child in zip(node["keys"], node["items"]):
            _check_like(child, like[key], f"{where}/{key}")
    elif kind in ("tuple", "list"):
        if len(like) != len(node["items"]):
            raise ValueError(f"{where}: checkpoint holds "
                             f"{len(node['items'])} items, the state "
                             f"{len(like)}")
        for i, (child, x) in enumerate(zip(node["items"], like)):
            _check_like(child, x, f"{where}/{i}")
    elif kind in ("tensor", "ndarray"):
        dtype = (str(like.dtype).split(".")[-1] if kind == "tensor"
                 else like.dtype.str)
        if list(like.shape) != node["shape"] or dtype != node["dtype"]:
            raise ValueError(f"{where}: checkpoint leaf {node['dtype']} "
                             f"{tuple(node['shape'])}, the state's {dtype} "
                             f"{tuple(like.shape)}")


def _leaf_from(node: dict, arr: np.ndarray, like, device):
    kind = node["kind"]
    if kind == "tensor":
        if node["dtype"] == "bfloat16":
            src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(arr)
        if isinstance(like, WorkerRows):
            like.scatter(src)
        elif like is not None:
            like.copy_(src)
        else:
            return src.to(device) if device is not None else src
        return like
    if kind == "ndarray":
        if like is not None:
            np.copyto(like, arr)
            return like
        return np.array(arr)
    return {"int": int, "float": float}[kind](arr[()])


def _rebuild(node: dict, like, take, device):
    kind = node["kind"]
    if kind == "none":
        return None
    if kind in ("tuple", "list"):
        items = [_rebuild(child, None if like is None else like[i], take,
                          device) for i, child in enumerate(node["items"])]
        if kind == "list":
            if like is not None:
                like[:] = items
                return like
            return items
        return tuple(items)
    if kind == "dict":
        out = {key: _rebuild(child, None if like is None else like[key],
                             take, device)
               for key, child in zip(node["keys"], node["items"])}
        if like is not None:
            like.update(out)
            return like
        return out
    return _leaf_from(node, take(), like, device)


def check_checkpoint(ckpt_dir: str, step: int, like) -> None:
    """Raise ``ValueError`` unless checkpoint ``step``'s sidecar has
    ``like``'s structure, leaf kinds, shapes and dtypes (``like``'s tensors
    may be on the ``meta`` device)."""
    meta = _read_sidecar(_path(ckpt_dir, step))
    _check_like(meta["tree"], like, f"step_{step:08d}")


def load_checkpoint(ckpt_dir: str, step: int, like=None, device=None):
    """Restore checkpoint ``step``.

    Without ``like``: a new tree with the saved structure; tensors on
    ``device`` (default the CPU), numpy arrays, Python ints and floats.
    With ``like`` (the state the caller already holds): the sidecar's
    structure, leaf kinds, shapes and dtypes are checked against it first
    (``ValueError`` on a mismatch, before anything is written), then every
    tensor and array of ``like`` is overwritten in place, leaf by leaf, and
    lists and dicts are updated in place; the restored tree is returned
    (Python numbers and tuples cannot change in place)."""
    path = _path(ckpt_dir, step)
    try:
        meta = _read_sidecar(path)
    except Exception as e:
        raise FileNotFoundError(
            f"checkpoint {path} has no readable treedef sidecar ({e}); "
            f"resume via latest_step() to skip torn checkpoints") from e
    if like is not None:
        _check_like(meta["tree"], like, f"step_{step:08d}")
    with np.load(path, allow_pickle=False) as data, torch.no_grad():
        if len(data.files) != meta["n_leaves"]:
            raise ValueError(f"checkpoint {path}: {len(data.files)} arrays, "
                             f"its sidecar {meta['n_leaves']}")
        counter = iter(range(meta["n_leaves"]))
        return _rebuild(meta["tree"], like, lambda: data[str(next(counter))],
                        device)
