"""Emulated-asynchrony trainer: bounded-staleness SGD on the real models
(counterpart of ``repro.dist.async_engine``).

Semantics (the bounded-delay model of §B.4): every step, every worker
computes a gradient at the *current* parameters and sends it with a delay
``tau(t, w)`` from the pre-drawn oblivious-adversary table
(`repro_torch.core.delivery.make_tau_schedule`); the shared model applies,
at step ``t``, exactly the messages whose delivery lands at ``t``.  A
gradient produced at ``s`` and applied at ``s + tau`` was computed at the
``tau``-steps-old iterate, so no parameter history is kept.  Gradients can
be sparsified (top-k / one-bit, with or without error feedback); DROPPED
(crashed) messages deliver nothing.

The ``p`` workers run in this process (`repro_torch.dist.workers`), one
after another over contiguous batch shards.  A step is two halves:

* :meth:`AsyncTrainStep.worker_grads` — the gradient half: a generator
  that yields each worker's ``(loss, grads)`` at the current params;
* :meth:`AsyncTrainStep.deliver` — the delivery/update half: it consumes
  those gradients one worker at a time (compressing each into its wire
  payload and updating its EF residual in place, so at most one worker's
  dense gradient is alive at once), routes every message, and applies the
  optimizer.  A test can feed it gradients from elsewhere.

Delivery follows ``AsyncConfig.overlap``:

* **fused** (``overlap`` with a compressor, the default): each worker's
  compact payload (top-k ``(vals, idx)`` or one-bit ``(pos, means)``) is
  gathered in worker order and deposited ONCE into the dense
  delivery-indexed accumulator ring ``acc`` (cap, M, R) per leaf at slot
  ``(t + tau) % cap`` by the deposit kernels; delivery takes slot
  ``t % cap`` (the prior deliveries) before the deposit and again after it
  (the ``tau == 0`` self-deliveries).
* **densified** (no compressor, or ``overlap=False``): per-worker rings
  ``buf`` (n, cap, *leaf) of dense payloads, deposit at ``(t + tau) % cap``
  and take at ``t % cap``, then the mean over workers.

Both deliver the same mass per step, so their trajectories agree; with
``tau_max = 0`` and no compressor the engine is the exact step bit for bit.
State (``acc``, ``buf``, ``err``, parameters and momentum) is updated in
place, as the reference donates it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import delivery as DLV
from repro_torch.core.scheduler import (_from_rows, ef_compress_leaf,
                                        ef_compress_leaf_compact,
                                        leaf_rows_geometry)
from repro_torch.dist.train import (guarded_update, tree_all_finite,
                                    worker_grads)
from repro_torch.dist.workers import all_gather, pmean
from repro_torch.kernels.cr_reduce import ops as CR


@dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the emulated-asynchrony engine (the reference's, less the
    mesh axis names and the kernel dispatch switch: the device of the
    tensors picks kernel or plain version)."""

    tau_max: int = 0              # staleness bound (0 == synchronous)
    schedule: str = "uniform"     # delivery.TAU_SCHEDULES
    compressor: str = "none"      # none | topk | onebit
    error_feedback: bool = True   # EF residuals (only with a compressor)
    topk_ratio: float = 1.0 / 64.0
    horizon: int = 1024           # tau schedule table length
    seed: int = 0                 # schedule RNG (oblivious adversary)
    track_gap: bool = True        # stale_gap2 metric (keeps the fresh mean)
    crash_subst: bool = False     # renormalize dead-worker mass
    skip_nonfinite: bool = False  # drop NaN/Inf gradients + skip the step
    overlap: bool = True          # fused compress-then-deposit delivery

    @property
    def capacity(self) -> int:
        return self.tau_max + 1

    @property
    def has_err(self) -> bool:
        return self.compressor != "none" and self.error_feedback

    @property
    def fused(self) -> bool:
        return self.overlap and self.compressor != "none"


def init_async_state(acfg: AsyncConfig, n_workers: int, params_like,
                     specs=None) -> dict:
    """State consumed by :class:`AsyncTrainStep`: ``step`` (int),
    ``taus`` ((horizon, n) int32 numpy, on the host: the adversary is
    oblivious, so routing never waits on the device), ``acc`` (fused: a
    tree of (cap, M, R) f32 rings; needs ``specs`` for the row geometry)
    or ``buf`` (densified: (n, cap, *leaf) f32), and ``err`` ((n, *leaf)
    f32 EF residuals) when compressing with error feedback."""
    if acfg.schedule not in DLV.TAU_SCHEDULES:
        raise ValueError(f"unknown schedule {acfg.schedule!r}")
    state = {"step": 0,
             "taus": DLV.make_tau_schedule(acfg.schedule, n_workers,
                                           acfg.horizon, acfg.tau_max,
                                           acfg.seed)}
    cap = acfg.capacity
    if acfg.fused:
        if specs is None:
            raise ValueError("the fused (overlap) path sizes its delivery "
                             "rings from the param specs — pass specs, or "
                             "set overlap=False")
        state["acc"] = T.tree_map(
            lambda a, sp: torch.zeros(
                (cap,) + leaf_rows_geometry(tuple(a.shape), sp)[:2],
                dtype=torch.float32, device=a.device), params_like, specs)
    else:
        state["buf"] = T.tree_map(
            lambda a: torch.zeros((n_workers, cap, *a.shape),
                                  dtype=torch.float32, device=a.device),
            params_like)
    if acfg.has_err:
        state["err"] = T.tree_map(
            lambda a: torch.zeros((n_workers, *a.shape), dtype=torch.float32,
                                  device=a.device), params_like)
    return state


def crash_subst_scale(taus: np.ndarray, step: int, cap: int) -> np.float32:
    """``n / delivered(t)`` (0 when nothing lands), in float32: how many
    messages land at ``step`` read off the tau table."""
    horizon, n = taus.shape
    cnt = np.float32(0.0)
    for d in range(cap):
        src = step - d
        cnt = np.float32(cnt + np.float32(
            np.sum((taus[src % horizon] == d) & (src >= 0))))
    return np.float32(np.float32(n) / cnt) if cnt > 0 else np.float32(0.0)


class AsyncTrainStep:
    """Bounded-staleness step ``(params, opt_state, state, batch) ->
    (params, opt_state, state, metrics)``.  Metrics: ``loss`` (mean over
    workers), ``stale_gap2`` (||applied - fresh mean gradient||^2; 0 when
    ``track_gap`` is off), ``mean_tau`` and ``nonfinite``."""

    def __init__(self, cfg: ArchConfig, opt, acfg: AsyncConfig,
                 n_workers: int, specs):
        self.cfg, self.opt, self.acfg = cfg, opt, acfg
        self.n, self.specs = n_workers, specs
        self._geoms = None

    def worker_grads(self, params, batch: dict):
        """Gradient half: yield ``(loss, grads)`` per worker, in order."""
        yield from worker_grads(self.cfg, params, batch, self.n)

    def __call__(self, params, opt_state, state: dict, batch: dict):
        return self.deliver(params, opt_state, state,
                            self.worker_grads(params, batch))

    # ------------------------------------------------------------------
    def deliver(self, params, opt_state, state: dict, worker_grads):
        """Delivery/update half over an iterable of per-worker
        ``(loss, grads)``."""
        acfg, n, cap = self.acfg, self.n, self.acfg.capacity
        step, tab = state["step"], state["taus"]
        tau = tab[step % tab.shape[0]]
        alive = (tau >= 0).astype(np.float32)
        d_eff = np.clip(tau, 0, acfg.tau_max)
        flat_p, _ = T.flatten(params)
        flat_s = T.leaves(self.specs)
        device = flat_p[0].device
        errs = T.leaves(state["err"]) if acfg.has_err else None
        if self._geoms is None:
            self._geoms = [leaf_rows_geometry(tuple(p.shape), sp)
                           for p, sp in zip(flat_p, flat_s)]

        losses, bad, fresh = [], [], None
        payloads = [[] for _ in flat_p]
        stale = [None] * len(flat_p)
        bufs = None if acfg.fused else T.leaves(state["buf"])
        for w, (loss, grads) in enumerate(worker_grads):
            flat_g = T.leaves(grads)
            del grads
            losses.append(loss)
            if acfg.skip_nonfinite:
                finite = tree_all_finite(flat_g)
                flat_g = [torch.where(finite, g, torch.zeros_like(g))
                          for g in flat_g]
                bad.append(1.0 - finite.float())
            if acfg.track_gap:
                fresh = ([g.float() for g in flat_g] if fresh is None else
                         [f + g for f, g in zip(fresh, flat_g)])
            for i, g in enumerate(flat_g):
                err = errs[i][w] if acfg.has_err else None
                if acfg.fused:
                    payload, _ = ef_compress_leaf_compact(
                        g, err, flat_s[i], acfg.compressor, acfg.topk_ratio)
                    payloads[i].append(payload)
                else:
                    stale[i] = self._densified_leaf(
                        bufs[i][w], g, err, flat_s[i], step,
                        int(d_eff[w]), float(alive[w]), stale[i])
                flat_g[i] = None
            del flat_g
        if len(losses) != n:
            raise ValueError(f"got gradients of {len(losses)} workers, "
                             f"expected {n}")

        if acfg.fused:
            synced = self._fused_delivery(state, payloads, step, tab)
        else:
            synced = [s / n for s in stale]
            if acfg.crash_subst:
                s = float(crash_subst_scale(tab, step, cap))
                synced = [x * s for x in synced]
        del payloads, stale

        gap2 = torch.zeros((), device=device)
        if acfg.track_gap:
            for i in range(len(synced)):
                gap2 = gap2 + torch.sum(torch.square(synced[i]
                                                     - fresh[i] / n))
                fresh[i] = None
        _, opt_state, _ = guarded_update(self.opt, synced, opt_state, flat_p,
                                         skip_nonfinite=acfg.skip_nonfinite)
        state["step"] = step + 1
        metrics = {
            "loss": pmean(losses),
            "stale_gap2": gap2,
            "mean_tau": float(d_eff.astype(np.float32).sum(dtype=np.float32)
                              / np.float32(n)),
            "nonfinite": (pmean(bad) if bad
                          else torch.zeros((), device=device)),
        }
        return params, opt_state, state, metrics

    # ------------------------------------------------------------------
    def _densified_leaf(self, ring, g, err, spec, step, d, alive, stale):
        """One worker's dense delivery for one leaf: take the prior slot,
        deposit the fresh payload ``d`` steps ahead, take the own slot."""
        acfg, cap = self.acfg, self.acfg.capacity
        prior, _ = DLV.ring_take(ring, step % cap)
        if acfg.compressor != "none":
            payload, new_err = ef_compress_leaf(g, err, spec, acfg.compressor,
                                                acfg.topk_ratio)
            if err is not None:
                err.copy_(new_err)
            del new_err
        else:
            payload = g.float()
        DLV.ring_deposit(ring, (step + d) % cap, payload * alive)
        own, _ = DLV.ring_take(ring, step % cap)
        mine = prior + own
        return mine if stale is None else stale + mine

    def _fused_delivery(self, state, payloads, step, tab):
        """Deposit every gathered message into its slot and take slot
        ``t % cap``; returns the applied mean per leaf."""
        acfg, n, cap = self.acfg, self.n, self.acfg.capacity
        accs = T.leaves(state["acc"])
        device = accs[0].device
        w_live, slots = DLV.delivery_plan(tab, step, cap)
        w_live = torch.as_tensor(w_live).to(device)
        slots = torch.as_tensor(slots).to(device)
        scale = np.float32(1.0) / np.float32(n)
        if acfg.crash_subst:
            scale = np.float32(scale * crash_subst_scale(tab, step, cap))
        now = step % cap
        synced = []
        for i, acc in enumerate(accs):
            prior = acc[now].clone()
            acc[now].zero_()
            gathered = {key: all_gather([p[key] for p in payloads[i]])
                        for key in payloads[i][0]}
            payloads[i] = None
            if acfg.compressor == "topk":
                CR.topk_deposit(acc, gathered["vals"], gathered["idx"],
                                slots, w_live)
            else:
                CR.onebit_deposit(acc, gathered["pos"], gathered["means"],
                                  slots, w_live)
            del gathered
            delivered = prior.add_(acc[now])
            acc[now].zero_()
            _, _, perm, tshape = self._geoms[i]
            synced.append(_from_rows(delivered.mul_(float(scale)), perm,
                                     tshape))
        return synced


def make_async_train_step(cfg: ArchConfig, opt, acfg: AsyncConfig,
                          n_workers: int, specs):
    """The bounded-staleness step over ``n_workers`` in-process workers."""
    return AsyncTrainStep(cfg, opt, acfg, n_workers, specs)
