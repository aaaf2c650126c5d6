"""Where each entry of the params, optimizer, sync and async state lives
when the workers are laid over ranks and the model over model shards
(counterpart of the per-worker and model-axis halves of
``repro.dist.sharding``).

Per-worker entries (:data:`PER_WORKER_STATE_KEYS`, and the delay rings of
:data:`PER_WORKER_RING_KEYS`) hold one row per worker: a rank holds the
``(p / N, ...)`` rows of its data rank's workers.  Under ``--model-shards
m`` a rank also holds only its model shard of every leaf the reference's
spec shards (:func:`shard_leaf`): the params and the momentum by the param
spec, ``err`` and ``residual`` by the param spec on their trailing dims,
``buf`` likewise behind its ring dim, and the ``acc`` rings on their row
dim M (:func:`sync_state_specs`).  Every other entry (``taus``, ``step``,
the replicated leaves) is a replica, the same on every rank.  One process
(or a one-process checkpoint) holds the whole layout.

:func:`gather_state`, :func:`shard_view` and :func:`opt_state_specs` give
a rank's trees in the whole layout, each split leaf as a
:class:`WorkerRows` that is gathered or scattered one leaf at a time, on
the host, when a checkpoint is written or read (`repro_torch.checkpoint`);
:func:`scatter_state` and :func:`local_tree` take a restored whole layout
back into the rank's trees.  The FSDP specs and the activation rules of
the reference are GSPMD's: the port's execution is explicit
(`repro_torch.models.actx`) and needs no rules.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.dist.workers import WorkerGroup
from repro_torch.models import actx

# entries with a leading worker dim; RING keys carry a delay-ring dim of
# size tau_max + 1 between the worker dim and the param dims
PER_WORKER_STATE_KEYS = ("err", "residual")
PER_WORKER_RING_KEYS = ("buf",)
PER_WORKER_KEYS = PER_WORKER_STATE_KEYS + PER_WORKER_RING_KEYS
# entries of (cap, M, R) rows, M the product of a leaf's model dims
ROW_KEYS = ("acc",)


def shard_leaf(x: torch.Tensor, spec, rank: int, size: int) -> torch.Tensor:
    """Model rank ``rank``'s slice (a view) of the whole leaf ``x`` of
    ``size`` shards by ``spec``; ``x`` itself when the spec replicates
    it."""
    dim = actx.model_dim(spec)
    if dim is None or size == 1:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


def unshard_leaf(parts, spec) -> torch.Tensor:
    """The whole leaf of every model rank's slice, in model order (one
    replica when the spec replicates it)."""
    dim = actx.model_dim(spec)
    return parts[0] if dim is None else torch.cat(list(parts), dim)


def opt_state_specs(opt_state: dict, specs) -> dict:
    """Specs of an optimizer state: the entries that hold one leaf per
    param (momentum's ``mu``, Adam's ``m`` and ``v``, in leaf order) take
    the param specs; the rest (``count``) are replicated (``None``)."""
    flat = T.leaves(specs)
    return {key: (list(flat) if isinstance(val, list)
                  and len(val) == len(flat) else None)
            for key, val in opt_state.items()}


def sync_state_specs(state: dict, specs) -> dict:
    """Specs of a sync or async state's split entries (the rest are
    replicated, ``None``): ``err`` / ``residual`` the param spec behind
    their worker dim, ``buf`` behind its worker and ring dims, ``acc`` its
    row dim M when the leaf is model-sharded."""
    out = {}
    for key, val in state.items():
        if key in PER_WORKER_STATE_KEYS:
            out[key] = T.tree_map(lambda s: (None,) + tuple(s), specs)
        elif key in PER_WORKER_RING_KEYS:
            out[key] = T.tree_map(lambda s: (None, None) + tuple(s), specs)
        elif key in ROW_KEYS:
            out[key] = T.tree_map(
                lambda s: (None, "model" if actx.model_dim(s) is not None
                           else None, None), specs)
        else:
            out[key] = None
    return out


class WorkerRows:
    """A rank's part ``local`` of one leaf split over the data group (its
    workers' rows of dim 0, with ``group``) and over the model group (its
    slice of dim ``model_dim``), standing for the whole leaf: ``shape`` and
    ``dtype`` are the whole leaf's, :meth:`gather` assembles it (every rank
    must call it, in the same leaf order) and :meth:`scatter` takes this
    rank's part of it."""

    def __init__(self, local: torch.Tensor, group: WorkerGroup | None,
                 model_dim: int | None = None):
        self.local, self.group, self.model_dim = local, group, model_dim
        self.model = actx.current() if model_dim is not None else None

    @property
    def shape(self) -> tuple:
        shape = list(self.local.shape)
        if self.group is not None:
            shape[0] = self.group.n
        if self.model is not None:
            shape[self.model_dim] *= self.model.size
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def gather(self) -> torch.Tensor:
        """The whole leaf in host memory, on every rank."""
        host, x = torch.device("cpu"), self.local
        if self.model is not None:
            # nccl gathers on the card (where the data ranks' gather then
            # runs); gloo straight into host memory
            x = self.model.gather_dim(
                x, self.model_dim,
                x.device if self.model.backend == "nccl" else host,
                counted=False)
        if self.group is not None and self.group.distributed:
            return self.group.gather_rows(x, host)
        return x.to(host)

    def scatter(self, whole: torch.Tensor) -> None:
        """Copy this rank's part of the whole leaf into ``local``, in
        place."""
        if self.group is not None and self.group.distributed:
            whole = whole[self.group.local.start:self.group.local.stop]
        if self.model is not None:
            whole = shard_leaf(whole, (None,) * self.model_dim + ("model",),
                               self.model.rank, self.model.size)
        self.local.copy_(whole)


def _view(tree, specs, group):
    """``tree`` (dicts, lists and tuples of leaves) with each tensor whose
    spec (``specs``, a tree like ``tree``; ``None`` replicates a whole
    subtree) shards a dim over ``model``, and each tensor when ``group``
    splits it over the data ranks, as a :class:`WorkerRows`."""
    if isinstance(tree, dict):
        return {k: _view(v, None if specs is None else specs[k], group)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_view(v, None if specs is None else specs[i],
                                group) for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    dim = None if specs is None else actx.model_dim(specs)
    return tree if dim is None and group is None \
        else WorkerRows(tree, group, dim)


def shard_view(tree, specs):
    """A rank's params (``specs`` the param specs) or optimizer state
    (``specs`` from :func:`opt_state_specs`) in the whole layout: its
    model-sharded leaves as :class:`WorkerRows`.  Without a model group the
    tree is returned as it is."""
    return tree if actx.current() is None else _view(tree, specs, None)


def gather_state(state: dict, group: WorkerGroup, specs=None) -> dict:
    """The rank's sync/async ``state`` in the whole layout: per-worker
    leaves as :class:`WorkerRows` over the data ranks, and (under a model
    group, with the param ``specs``) every model-sharded leaf as one over
    the model group; the replicas as they are.  One process holds the
    whole layout already: its state is returned as it is."""
    model = actx.current() is not None and specs is not None
    if not group.distributed and not model:
        return state
    state_specs = sync_state_specs(state, specs) if model else {}
    out = {}
    for key, val in state.items():
        rows = group if key in PER_WORKER_KEYS and group.distributed \
            else None
        sp = state_specs.get(key)
        out[key] = val if rows is None and sp is None \
            else _view(val, sp, rows)
    return out


def scatter_state(whole: dict, state: dict) -> dict:
    """Take ``whole`` (:func:`gather_state`'s dict after a restore, whose
    :class:`WorkerRows` were restored into the rank's rows in place) back
    into ``state``: the replicas, which a restore may replace (the ``step``
    int).  Returns ``state``."""
    for key, val in whole.items():
        if key not in PER_WORKER_KEYS + ROW_KEYS:
            state[key] = val
    return state


def local_tree(tree):
    """A restored :func:`shard_view` with every :class:`WorkerRows` (each
    restored in place) replaced by its rank's tensor."""
    if isinstance(tree, WorkerRows):
        return tree.local
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    return tree
