"""Bounded-staleness serving replica: params behind a `core.delivery`
version ring (counterpart of ``repro.serve.replica``).

The trainer *publishes* each new parameter version into a ring of capacity
``tau_serve + 1`` (`tree_ring_put`, overwrite semantics) and the replica
*serves* from a slot at most ``tau_serve`` versions behind: the ring only
ever holds the last ``tau_serve + 1`` versions, and `refresh` clamps the
serving version into that window, so ``staleness <= tau_serve`` is an
invariant.  Which version inside the window is served comes from the
oblivious staleness schedules of `delivery.make_tau_schedule` (DROPPED
means the refresh was missed: maximal allowed lag).  Each ring keeps its
leaf's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.delivery import (DROPPED, make_tau_schedule,
                                       tree_ring_init, tree_ring_put,
                                       tree_ring_read)


def _all_finite(leaves) -> bool:
    return all(bool(torch.all(torch.isfinite(a))) for a in leaves)


class ParamReplica:
    """Version ring of parameter snapshots with a hard staleness cap."""

    def __init__(self, params, tau_serve: int, *, schedule: str = "uniform",
                 horizon: int = 1024, seed: int = 0):
        if tau_serve < 0:
            raise ValueError(f"tau_serve must be >= 0, got {tau_serve}")
        leaves, self._treedef = T.flatten(params)
        if not _all_finite(leaves):
            raise ValueError("replica bootstrap params contain non-finite "
                             "leaves: nothing safe to serve")
        self.tau_serve = tau_serve
        self.capacity = tau_serve + 1
        # version 0 = the params the replica was brought up with
        self.rings = tree_ring_put(tree_ring_init(self.capacity, leaves),
                                   0, leaves)
        self.latest_version = 0
        self.serving_version = 0
        lags = make_tau_schedule(schedule, 1, horizon, tau_serve, seed)[:, 0]
        # DROPPED refresh = the replica missed the round: maximal legal lag
        self._lags = np.where(lags == DROPPED, tau_serve, lags)
        self._refreshes = 0
        self.refused = 0

    @property
    def staleness(self) -> int:
        return self.latest_version - self.serving_version

    def publish(self, params, version: int | None = None) -> int | None:
        """Trainer side: install a new version (defaults to latest + 1),
        overwriting ring slot ``version % capacity``.  A version with
        non-finite leaves is **refused** (returns None, bumps
        :attr:`refused`) and the ring is untouched."""
        leaves = T.leaves(params)
        if not _all_finite(leaves):
            self.refused += 1
            return None
        v = self.latest_version + 1 if version is None else version
        if v != self.latest_version + 1:
            raise ValueError(
                f"publish must advance by 1: {self.latest_version} -> {v}")
        self.rings = tree_ring_put(self.rings, v % self.capacity, leaves)
        self.latest_version = v
        self.serving_version = max(self.serving_version,
                                   self.latest_version - self.tau_serve)
        return v

    def refresh(self) -> int:
        """Replica side: pick the serving version for the next requests,
        clamped into ``[latest - tau_serve, latest]``; serving never moves
        backwards."""
        lag = int(self._lags[self._refreshes % len(self._lags)])
        self._refreshes += 1
        want = self.latest_version - min(lag, self.tau_serve)
        self.serving_version = max(self.serving_version, want, 0)
        return self.serving_version

    def serving_params(self):
        """The snapshot for ``serving_version`` (views into the ring)."""
        assert 0 <= self.staleness <= self.tau_serve, (
            self.latest_version, self.serving_version)
        return T.unflatten(self._treedef, tree_ring_read(
            self.rings, self.serving_version % self.capacity))
