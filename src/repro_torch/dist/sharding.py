"""Where each entry of the sync and async state lives when the workers are
laid over ranks (counterpart of the per-worker half of
``repro.dist.sharding``).

Per-worker entries (:data:`PER_WORKER_STATE_KEYS`, and the delay rings of
:data:`PER_WORKER_RING_KEYS`) hold one row per worker: a rank holds the
``(p / N, ...)`` rows of its own workers.  Every other entry (``acc``,
``taus``, ``step``) is a replica, the same on every rank.  One process (or
a one-process checkpoint) holds the whole ``(p, ...)`` layout.

:func:`gather_state` gives a rank's state in the whole layout, each
per-worker leaf as a :class:`WorkerRows` that is gathered or scattered one
leaf at a time, on the host, when a checkpoint is written or read
(`repro_torch.checkpoint`); :func:`scatter_state` takes a restored whole
layout back into the rank's state.  The ``PartitionSpec`` and activation
rule builders of the reference are GSPMD's and wait for the
tensor-parallel slice.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.dist.workers import WorkerGroup

# entries with a leading worker dim; RING keys carry a delay-ring dim of
# size tau_max + 1 between the worker dim and the param dims
PER_WORKER_STATE_KEYS = ("err", "residual")
PER_WORKER_RING_KEYS = ("buf",)
PER_WORKER_KEYS = PER_WORKER_STATE_KEYS + PER_WORKER_RING_KEYS


class WorkerRows:
    """A rank's rows ``local`` of one per-worker leaf, standing for the
    whole ``(p, ...)`` leaf: ``shape`` and ``dtype`` are the whole leaf's,
    :meth:`gather` assembles it (every rank must call it, in the same leaf
    order) and :meth:`scatter` takes this rank's rows of it."""

    def __init__(self, local: torch.Tensor, group: WorkerGroup):
        self.local, self.group = local, group

    @property
    def shape(self) -> tuple:
        return (self.group.n,) + tuple(self.local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def gather(self) -> torch.Tensor:
        """The whole leaf in host memory, on every rank."""
        return self.group.gather_rows(self.local, torch.device("cpu"))

    def scatter(self, whole: torch.Tensor) -> None:
        """Copy this rank's rows of the whole leaf into ``local``, in
        place."""
        self.local.copy_(whole[self.group.local.start:self.group.local.stop])


def gather_state(state: dict, group: WorkerGroup) -> dict:
    """The rank's sync/async ``state`` in the whole layout: per-worker
    leaves as :class:`WorkerRows`, the replicas as they are.  One process
    holds the whole layout already: its state is returned as it is."""
    if not group.distributed:
        return state
    return {key: (T.tree_map(lambda x: WorkerRows(x, group), val)
                  if key in PER_WORKER_KEYS else val)
            for key, val in state.items()}


def scatter_state(whole: dict, state: dict) -> dict:
    """Take ``whole`` (:func:`gather_state`'s dict after a restore, whose
    :class:`WorkerRows` were restored into the rank's rows in place) back
    into ``state``: the replicas, which a restore may replace (the ``step``
    int).  Returns ``state``."""
    for key, val in whole.items():
        if key not in PER_WORKER_KEYS:
            state[key] = val
    return state
