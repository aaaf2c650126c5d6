"""Host-side fault injectors: drive a `FaultPlan` through the port's
launchers (counterpart of ``repro.faults.inject``).

`TrainFaultInjector` sits in `repro_torch.launch.train`'s step loop: it
poisons batches (via the ``loss_scale`` channel that
`repro_torch.dist.train.loss_fn` multiplies in), raises scheduled
checkpoint-IO errors, and SIGKILLs the process at kill events — but only on
the event's designated launch attempt, so a supervisor restart replays the
surviving schedule instead of dying on the same step forever.

`ServeFaultInjector` sits in `ContinuousScheduler.step` (the ``on_tick``
hook): it NaN-poisons an active request's KV (`StepEngine.poison_kv`,
exercising the quarantine path) and temporarily exhausts the page pool
(exercising retry-after backpressure).  Both injectors are pure functions
of (plan, attempt/tick), so a seeded plan replays identically.
"""
from __future__ import annotations

import os
import signal

from repro_torch.faults.plan import FaultPlan


class TrainFaultInjector:
    """Applies a plan's training-side events inside `launch.train`."""

    def __init__(self, plan: FaultPlan, attempt: int = 0):
        self.plan = plan
        self.attempt = attempt
        self.poisoned_steps = 0
        self.ckpt_errors = 0

    @property
    def has_poison(self) -> bool:
        return self.plan.has_poison

    def loss_scale(self, step: int) -> float:
        """1.0 normally; NaN (or +inf when ``param > 0``) on a
        ``grad_poison`` step — scaling the loss poisons every gradient
        leaf without touching the model code."""
        evs = self.plan.at(step, "grad_poison")
        if not evs:
            return 1.0
        self.poisoned_steps += 1
        return float("inf") if evs[0].param > 0 else float("nan")

    def check_ckpt_io(self, step: int) -> None:
        """Raise the scheduled checkpoint-IO error (callers catch OSError,
        print it and keep training — checkpointing is best-effort)."""
        if self.plan.at(step, "ckpt_io"):
            self.ckpt_errors += 1
            raise OSError(f"injected checkpoint IO failure at step {step}")

    def maybe_kill(self, step: int) -> None:
        """SIGKILL after step ``step`` if a kill event for this attempt is
        scheduled.  SIGKILL (not an exception) on purpose: no atexit, no
        flushing — the hardest crash the supervisor must survive.  Under
        ``--ranks`` the launcher calls it on rank 0 only; ``grad_poison``
        reaches every rank through the ``loss_scale`` rows its workers
        hold."""
        for ev in self.plan.at(step, "kill"):
            if ev.on_attempt == self.attempt:
                print(f"fault: SIGKILL at step {step} "
                      f"(attempt {self.attempt})", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)


class ServeFaultInjector:
    """Applies a plan's serve-side events through the scheduler's
    ``on_tick`` hook (called once per decode tick, before admission)."""

    def __init__(self, plan: FaultPlan, engine):
        self.plan = plan
        self.engine = engine
        self.poisoned = 0
        self.exhausted = 0
        self._holds: list = []        # (release_tick, hold_rid)

    def on_tick(self, sched) -> None:
        tick = sched.clock
        # release expired page holds first so capacity comes back
        keep = []
        for release, rid in self._holds:
            if tick >= release:
                self.engine.alloc.free(rid)
            else:
                keep.append((release, rid))
        self._holds = keep

        for ev in self.plan.at(tick, "page_exhaust"):
            want = int(ev.param) if ev.param > 0 else self.engine.alloc.n_free
            n = min(want, self.engine.alloc.n_free)
            if n > 0:
                rid = f"__fault_{tick}_{self.exhausted}__"
                self.engine.alloc.alloc(rid, n)
                self._holds.append((tick + max(ev.duration, 1), rid))
                self.exhausted += 1

        if self.plan.at(tick, "logit_poison") and sched._live:
            rid = min(sched._live)    # deterministic victim
            self.engine.poison_kv(rid)
            self.poisoned += 1

    def release_all(self) -> None:
        """Free any page holds still live (end-of-run cleanup)."""
        for _, rid in self._holds:
            self.engine.alloc.free(rid)
        self._holds = []
