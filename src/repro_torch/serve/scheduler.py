"""Continuous-batching request pump (counterpart of
``repro.serve.scheduler``).

Static batching decodes a fixed batch until its *longest* request finishes.
The continuous scheduler instead re-decides membership every decode step:

    evict finished requests  ->  admit from the queue while a slot AND the
    pages fit  ->  one engine step for whatever is active.

The pump is blind to the model: it talks to anything with the
`StepEngine` verb surface (``can_admit`` / ``start`` / ``step`` /
``finish`` / ``slot_of``), so a fake engine can check that it never
over-admits, never double-finishes and never leaks a page.

Time is the virtual step clock (1 tick = 1 decode step): arrivals, queueing
delay and per-request latency are measured in steps, so traces replay
deterministically and latency percentiles are machine-independent.

Tokens never return to the host during the run: the pump keeps the
engine's per-step (R,) device tensors plus (step, slot) coordinates per
request, and ``drain`` fetches everything at once at the end.

Graceful degradation: a full queue rejects ``submit`` and advertises
``retry_after``; ``run()`` re-enqueues rejected arrivals that many ticks
later.  With ``quarantine=True`` and an engine exposing
``nonfinite_rids()``, a request whose decode hit non-finite logits is
evicted and requeued once (from scratch, its pages freed); a second
offense marks its completion ``failed``.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int                  # tokens to generate (incl. prefill's)
    arrival: int = 0              # virtual step of arrival


@dataclass
class Completion:
    rid: int
    admitted: int                 # step admitted (prefill step)
    finished: int                 # step the last token was emitted
    tokens: np.ndarray | None = None
    failed: bool = False          # quarantined twice; tokens stay None


class ContinuousScheduler:
    """Bounded-admission continuous-batching pump over a `StepEngine`."""

    def __init__(self, engine, *, queue_limit: int = 64,
                 quarantine: bool = False, on_tick=None):
        self.engine = engine
        self.queue_limit = queue_limit
        self.quarantine = quarantine
        self.on_tick = on_tick        # fault-injection hook
        self.queue: deque = deque()
        self.clock = 0
        self.submitted = 0
        self.rejected = 0
        self.resubmitted = 0
        self.quarantined = 0
        self.failed = 0
        self.retry_after = 1          # backpressure hint for rejected submits
        self._emitted: dict = {}      # rid -> tokens emitted so far
        self._live: dict = {}         # rid -> Request (admitted, not done)
        self._first_tok: dict = {}    # rid -> (1,) device tensor
        self._coords: dict = {}       # rid -> list of (step_idx, slot)
        self._step_log: list = []     # per engine step: (R,) device tokens
        self._qcount: dict = {}       # rid -> times quarantined
        self.completions: dict = {}   # rid -> Completion
        self.latencies: list = []     # (finished - arrival) per request

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; False (rejected) when the queue is full.  A
        rejection updates :attr:`retry_after`: the current backlog, bounded
        to stay responsive."""
        self.submitted += 1
        if len(self.queue) >= self.queue_limit:
            self.rejected += 1
            self.retry_after = max(1, min(len(self.queue), 8))
            return False
        self.queue.append(req)
        return True

    def _admit(self) -> None:
        while self.queue:
            req = self.queue[0]
            if not self.engine.can_admit(len(req.prompt), req.max_new):
                break                 # FIFO: no skip-ahead past the head
            self.queue.popleft()
            tok = self.engine.start(req.rid, req.prompt, req.max_new)
            self._live[req.rid] = req
            self._emitted[req.rid] = 1          # prefill emits token 1
            self._first_tok[req.rid] = tok
            self._coords[req.rid] = []
            self.completions[req.rid] = Completion(
                rid=req.rid, admitted=self.clock, finished=-1)
            if self._emitted[req.rid] >= req.max_new:
                self._finish(req.rid)

    def _finish(self, rid) -> None:
        self.engine.finish(rid)
        req = self._live.pop(rid)
        self.completions[rid].finished = self.clock
        self.latencies.append(self.clock - req.arrival)

    def _quarantine(self, rid) -> None:
        """Evict a poisoned request; requeue once (at the queue head), fail
        it on the second offense."""
        self.engine.finish(rid)       # frees the poisoned KV pages
        req = self._live.pop(rid)
        del self._emitted[rid], self._first_tok[rid], self._coords[rid]
        if self._qcount.get(rid, 0) >= 1:
            comp = self.completions[rid]
            comp.finished = self.clock
            comp.failed = True
            self.failed += 1
            return
        del self.completions[rid]     # readmission rebuilds it
        self._qcount[rid] = 1
        self.quarantined += 1
        self.queue.appendleft(req)

    # -- the pump ----------------------------------------------------------
    def step(self) -> None:
        """One tick: admit, then one decode step for the active set."""
        if self.on_tick is not None:
            self.on_tick(self)
        self._admit()
        if self._live:
            toks = self.engine.step()
            bad = ()
            if self.quarantine and hasattr(self.engine, "nonfinite_rids"):
                bad = tuple(self.engine.nonfinite_rids())
            for rid in bad:
                if rid in self._live:
                    self._quarantine(rid)
            idx = len(self._step_log)
            self._step_log.append(toks)
            for rid, req in list(self._live.items()):
                self._coords[rid].append((idx, self.engine.slot_of(rid)))
                self._emitted[rid] += 1
                if self._emitted[rid] >= req.max_new:
                    self._finish(rid)
        self.clock += 1

    def run(self, trace: list[Request], *, max_steps: int = 100_000) -> dict:
        """Replay an arrival trace to completion; returns rid -> tokens.

        Rejected arrivals come back ``retry_after`` ticks later (original
        arrival kept, so their latency includes the backpressure wait)."""
        pending = [(r.arrival, i, r)
                   for i, r in enumerate(
                       sorted(trace, key=lambda r: (r.arrival, r.rid)))]
        heapq.heapify(pending)
        seq = len(pending)
        while pending or self.queue or self._live:
            while pending and pending[0][0] <= self.clock:
                _, _, req = heapq.heappop(pending)
                if not self.submit(req):
                    self.resubmitted += 1
                    heapq.heappush(
                        pending, (self.clock + self.retry_after, seq, req))
                    seq += 1
            self.step()
            if self.clock > max_steps:
                raise RuntimeError(
                    f"scheduler did not drain in {max_steps} steps")
        return self.drain()

    def drain(self) -> dict:
        """Materialize every request's tokens with ONE device-to-host
        fetch for the whole run: the per-step token tensors and every
        request's first token are concatenated on the device and copied
        once.  Failed (twice-quarantined) requests keep ``tokens=None`` and
        are left out of the result."""
        rids = list(self._first_tok)
        parts = ([torch.as_tensor(t).reshape(-1) for t in self._step_log]
                 + [torch.as_tensor(self._first_tok[r]).reshape(-1)
                    for r in rids])
        host = (torch.cat(parts).cpu().numpy() if parts
                else np.zeros((0,), np.int32))
        n_steps = len(self._step_log)
        width = (host.shape[0] - len(rids)) // max(n_steps, 1)
        all_tok = host[:n_steps * width].reshape(n_steps, width)
        firsts = dict(zip(rids, host[n_steps * width:]))
        out = {}
        for rid, comp in self.completions.items():
            if comp.failed:
                continue
            rest = np.array([all_tok[i, s] for i, s in self._coords[rid]],
                            np.int32)
            comp.tokens = np.concatenate(
                [np.asarray([firsts[rid]], np.int32), rest])
            out[rid] = comp.tokens
        return out

    # -- metrics -----------------------------------------------------------
    def latency_percentiles(self) -> tuple[float, float]:
        if not self.latencies:
            return 0.0, 0.0
        arr = np.asarray(self.latencies, np.float64)
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))

    def stats(self) -> dict:
        """Backpressure/fault accounting.  ``rejected_frac`` is rejections
        over submit attempts (retries count as attempts)."""
        p50, p99 = self.latency_percentiles()
        return {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "resubmitted": self.resubmitted,
            "quarantined": self.quarantined,
            "failed": self.failed,
            "rejected_frac": self.rejected / max(self.submitted, 1),
            "p50": p50,
            "p99": p99,
        }
