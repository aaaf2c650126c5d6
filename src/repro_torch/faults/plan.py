"""`FaultPlan`: a seeded, replayable schedule of injected faults
(counterpart of ``repro.faults.plan``; its JSON text and its seeded draws
are the reference's, byte for byte).

The paper treats faults as *relaxations* of consistency — stale, dropped
and crashed gradients are all legal as long as Def. 1's bound holds.  A
`FaultPlan` is the runtime counterpart of the simulator's oblivious
adversary: a plain list of ``(step, kind, ...)`` events drawn up-front
(either hand-written or from :meth:`FaultPlan.random` with a seed), JSON
round-trippable so the *same* faults can be replayed against the live
system and against the reference.

Event kinds:

  ==============  =====================================================
  ``kill``        SIGKILL the training process after step ``step``
                  (fires only on attempt ``on_attempt`` so a supervisor
                  restart does not re-trigger it forever)
  ``grad_poison`` the step-``step`` batch produces NaN gradients
                  (``param`` > 0 poisons with +inf instead)
  ``ckpt_io``     the checkpoint save at step ``step`` raises OSError
  ``crash``       worker ``worker`` stops delivering (DROPPED tau rows)
                  from ``step`` for ``duration`` steps (0 = forever)
  ``rejoin``      worker ``worker`` resumes delivering from ``step``
  ``delay``       worker ``worker`` straggles at ``tau_max`` for
                  ``duration`` steps
  ``drop``        worker ``worker``'s deposits are dropped for
                  ``duration`` steps
  ``logit_poison``  serve: NaN-poison an active request's KV at tick
                  ``step`` (quarantine path)
  ``page_exhaust``  serve: grab ``param`` pages from the pool at tick
                  ``step`` for ``duration`` ticks (backpressure path)
  ==============  =====================================================

Tau-shaped kinds (``crash``/``rejoin``/``delay``/``drop``) are applied to
a pre-drawn `repro_torch.core.delivery.make_tau_schedule` table with
:meth:`FaultPlan.apply_to_taus` — the async engine then runs them with no
new code, and the delivery-ring conservation tests keep holding because
the overrides only ever write legal values (``[0, tau_max]`` or DROPPED).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core.delivery import DROPPED

#: kinds that rewrite the async engine's tau table
TAU_KINDS = ("crash", "rejoin", "delay", "drop")
#: kinds the serving-side injector understands
SERVE_KINDS = ("logit_poison", "page_exhaust")
FAULT_KINDS = ("kill", "grad_poison", "ckpt_io") + TAU_KINDS + SERVE_KINDS


@dataclass(frozen=True)
class FaultEvent:
    step: int                     # training step / serve tick it fires at
    kind: str                     # one of FAULT_KINDS
    worker: int = -1              # TAU_KINDS: which worker (-1 = last)
    duration: int = 1             # TAU_KINDS/page_exhaust: steps it lasts
    param: float = 0.0            # kind-specific knob (see module doc)
    on_attempt: int = 0           # kill: only fire on this launch attempt

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.duration < 0:
            raise ValueError(f"duration must be >= 0, got {self.duration}")


@dataclass(frozen=True)
class FaultPlan:
    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            e if isinstance(e, FaultEvent) else FaultEvent(**e)
            for e in self.events))

    # -- queries -----------------------------------------------------------
    def at(self, step: int, kind: str | None = None) -> list[FaultEvent]:
        return [e for e in self.events
                if e.step == step and (kind is None or e.kind == kind)]

    def kinds(self) -> set:
        return {e.kind for e in self.events}

    @property
    def has_poison(self) -> bool:
        return any(e.kind == "grad_poison" for e in self.events)

    @property
    def has_tau_events(self) -> bool:
        return any(e.kind in TAU_KINDS for e in self.events)

    @property
    def max_step(self) -> int:
        return max((e.step for e in self.events), default=0)

    # -- (de)serialization (replayability) ---------------------------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [asdict(e) for e in self.events]},
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        return cls(events=tuple(FaultEvent(**e) for e in obj["events"]),
                   seed=int(obj.get("seed", 0)))

    @classmethod
    def load(cls, path_or_json: str) -> "FaultPlan":
        """Accepts a file path or inline JSON (starts with ``{``)."""
        text = path_or_json
        if not path_or_json.lstrip().startswith("{"):
            with open(path_or_json) as f:
                text = f.read()
        return cls.from_json(text)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    # -- generation --------------------------------------------------------
    @classmethod
    def random(cls, seed: int, steps: int, workers: int, *,
               n_events: int = 4, kinds=TAU_KINDS + ("grad_poison",),
               tau_max: int = 4) -> "FaultPlan":
        """Seeded random plan: ``n_events`` events over ``steps`` steps.
        The draw is a pure function of the arguments, so the same seed
        replays the same faults anywhere."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            events.append(FaultEvent(
                step=int(rng.integers(0, max(steps, 1))), kind=kind,
                worker=int(rng.integers(0, max(workers, 1))),
                duration=int(rng.integers(1, max(steps // 4, 2))),
                param=float(rng.uniform())))
        return cls(events=tuple(sorted(events, key=lambda e: e.step)),
                   seed=seed)

    # -- tau-table rewriting (crash / rejoin / delay / drop) ---------------
    def apply_to_taus(self, taus: np.ndarray, tau_max: int) -> np.ndarray:
        """Rewrite a (T, p) delay table per this plan's TAU_KINDS events.

        ``crash`` marks the worker dead from ``step`` (for ``duration``
        steps; 0 = until a later ``rejoin``), ``rejoin`` revives it (the
        original scheduled delays resume), ``delay`` pins it at
        ``tau_max``, ``drop`` discards its deposits for the window.
        Events apply in step order, so crash→rejoin windows compose.
        """
        taus = np.array(taus, np.int32, copy=True)
        t_len, p = taus.shape
        alive = np.ones_like(taus, bool)
        for ev in sorted((e for e in self.events if e.kind in TAU_KINDS),
                         key=lambda e: e.step):
            w = ev.worker % p
            s = min(ev.step, t_len)
            end = t_len if ev.duration == 0 else min(s + ev.duration, t_len)
            if ev.kind == "crash":
                alive[s:end, w] = False
            elif ev.kind == "rejoin":
                alive[s:, w] = True
            elif ev.kind == "delay":
                taus[s:end, w] = np.where(taus[s:end, w] == DROPPED,
                                          DROPPED, tau_max)
            elif ev.kind == "drop":
                alive[s:end, w] = False
        return np.where(alive, taus, DROPPED).astype(np.int32)


def _main():
    """Tiny plan-authoring CLI (see README ``--fault-plan`` usage):

      python -m repro_torch.faults.plan --out plan.json --kill-at 6 \\
          --crash 1@4:0 --rejoin 1@9 --poison-at 3 --ckpt-io-at 8
    """
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-at", type=int, action="append", default=[])
    ap.add_argument("--kill-attempt", type=int, default=0)
    ap.add_argument("--poison-at", type=int, action="append", default=[])
    ap.add_argument("--ckpt-io-at", type=int, action="append", default=[])
    ap.add_argument("--crash", action="append", default=[],
                    metavar="W@S[:D]", help="worker W crashes at step S "
                    "for D steps (D=0 or omitted: until rejoin)")
    ap.add_argument("--rejoin", action="append", default=[], metavar="W@S")
    ap.add_argument("--delay", action="append", default=[],
                    metavar="W@S[:D]")
    ap.add_argument("--drop", action="append", default=[], metavar="W@S[:D]")
    args = ap.parse_args()

    def windowed(spec: str, kind: str) -> FaultEvent:
        w, rest = spec.split("@")
        s, _, d = rest.partition(":")
        return FaultEvent(step=int(s), kind=kind, worker=int(w),
                          duration=int(d) if d else 0)

    events = [FaultEvent(step=s, kind="kill", on_attempt=args.kill_attempt)
              for s in args.kill_at]
    events += [FaultEvent(step=s, kind="grad_poison")
               for s in args.poison_at]
    events += [FaultEvent(step=s, kind="ckpt_io") for s in args.ckpt_io_at]
    for flag, kind in (("crash", "crash"), ("rejoin", "rejoin"),
                       ("delay", "delay"), ("drop", "drop")):
        events += [windowed(spec, kind) for spec in getattr(args, flag)]
    plan = FaultPlan(events=tuple(sorted(events, key=lambda e: e.step)),
                     seed=args.seed)
    if args.out:
        plan.save(args.out)
        print(f"wrote {len(plan.events)} events to {args.out}")
    else:
        print(plan.to_json())


if __name__ == "__main__":
    _main()
