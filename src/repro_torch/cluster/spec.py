"""`ClusterSpec`: a seeded, replayable description of a worker fleet
(counterpart of ``repro.cluster.spec``; plain Python and numpy, so a
spec's JSON is text-equal to the reference's).

The paper abstracts *where* staleness comes from (Def. 1 only bounds the
perturbation); Keuper & Pfreundt's ASGD analysis shows the wall-clock win
of relaxing consistency is a function of the cluster's compute/communication
rate ratio.  A `ClusterSpec` pins that ratio down: per-worker sustained
compute rates, HBM and link bandwidths, link latencies, a learner apply
cost, and a seeded trace of straggler/preemption events.  Like
`faults.FaultPlan` it is JSON round-trippable, so the same cluster shape
can be replayed against the event loop (`cluster.perf`), the co-simulation
(`cluster.cosim`) and a future real deployment.

Trace event kinds:

  ==============  ====================================================
  ``straggle``    worker ``worker``'s compute rate is divided by
                  ``factor`` from ``step`` for ``duration`` steps
                  (0 = until the end of the run)
  ``preempt``     worker ``worker`` is evicted from ``step`` for
                  ``duration`` steps; its in-flight gradient is lost
                  (DROPPED rows in the emitted tau table)
  ``netdeg``      worker ``worker``'s link bandwidth is divided by
                  ``factor`` for the window (congestion / flaky NIC)
  ==============  ====================================================
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np

TRACE_KINDS = ("straggle", "preempt", "netdeg")


@dataclass(frozen=True)
class TraceEvent:
    step: int                 # cluster step the event fires at
    kind: str                 # one of TRACE_KINDS
    worker: int               # which worker (modulo p)
    duration: int = 1         # steps it lasts (0 = until end of run)
    factor: float = 4.0       # straggle/netdeg slowdown divisor

    def __post_init__(self):
        if self.kind not in TRACE_KINDS:
            raise ValueError(
                f"unknown trace kind {self.kind!r}; one of {TRACE_KINDS}")
        if self.step < 0:
            raise ValueError(f"event step must be >= 0, got {self.step}")
        if self.duration < 0:
            raise ValueError(f"duration must be >= 0, got {self.duration}")
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")


@dataclass(frozen=True)
class ClusterSpec:
    """A fleet of ``p`` workers feeding one learner.

    Rates are *per worker*; scalars broadcast.  ``flops_per_s`` is the
    sustained model-flops rate, ``hbm_bytes_per_s`` bounds the memory
    roofline term, ``link_bytes_per_s``/``link_latency_s`` price the
    gradient wire, ``apply_s`` is the learner's fixed per-step apply cost.
    """
    name: str = "custom"
    p: int = 4
    flops_per_s: tuple = (197e12,)
    hbm_bytes_per_s: tuple = (819e9,)
    link_bytes_per_s: tuple = (50e9,)
    link_latency_s: tuple = (1e-5,)
    apply_s: float = 1e-4
    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        for f in ("flops_per_s", "hbm_bytes_per_s", "link_bytes_per_s",
                  "link_latency_s"):
            v = getattr(self, f)
            if np.isscalar(v):
                v = (float(v),)
            v = tuple(float(x) for x in v)
            if len(v) not in (1, self.p):
                raise ValueError(
                    f"{f} must have 1 or p={self.p} entries, got {len(v)}")
            object.__setattr__(self, f, v)
        object.__setattr__(self, "events", tuple(
            e if isinstance(e, TraceEvent) else TraceEvent(**e)
            for e in self.events))

    # -- per-worker vectors ------------------------------------------------
    def _vec(self, field: str) -> np.ndarray:
        v = np.asarray(getattr(self, field), np.float64)
        return np.broadcast_to(v, (self.p,)).copy()

    @property
    def rates(self) -> np.ndarray:
        return self._vec("flops_per_s")

    @property
    def hbm(self) -> np.ndarray:
        return self._vec("hbm_bytes_per_s")

    @property
    def bandwidth(self) -> np.ndarray:
        return self._vec("link_bytes_per_s")

    @property
    def latency(self) -> np.ndarray:
        return self._vec("link_latency_s")

    # -- (de)serialization (replayability, FaultPlan idiom) ----------------
    def to_json(self) -> str:
        d = asdict(self)
        d["events"] = [asdict(e) for e in self.events]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        obj = json.loads(text)
        obj["events"] = tuple(TraceEvent(**e) for e in obj.get("events", ()))
        for f in ("flops_per_s", "hbm_bytes_per_s", "link_bytes_per_s",
                  "link_latency_s"):
            if f in obj:
                obj[f] = tuple(obj[f])
        return cls(**obj)

    @classmethod
    def load(cls, path_or_json: str) -> "ClusterSpec":
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
    def random(cls, seed: int, p: int, steps: int, *,
               n_events: int = 4, kinds=TRACE_KINDS,
               base: "ClusterSpec | None" = None) -> "ClusterSpec":
        """Seeded random trace over a (possibly preset) base fleet.  The
        draw is a pure function of the arguments, so the same seed replays
        the same cluster anywhere."""
        rng = np.random.default_rng(seed)
        base = base or cls(name=f"random{seed}", p=p)
        events = []
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            events.append(TraceEvent(
                step=int(rng.integers(0, max(steps, 1))), kind=kind,
                worker=int(rng.integers(0, max(p, 1))),
                duration=int(rng.integers(1, max(steps // 4, 2))),
                factor=float(rng.uniform(2.0, 16.0))))
        return cls(**{**asdict(base), "name": f"random{seed}", "p": p,
                      "seed": seed,
                      "events": tuple(sorted(events, key=lambda e: e.step))})


# -- named presets (the shapes the co-sim bench sweeps) --------------------

def preset(name: str, p: int = 4, steps: int = 400) -> ClusterSpec:
    """Named cluster shapes.

    ``uniform``         well-provisioned homogeneous pod (fat links, no
                        trace events) — steps and seconds rank the same
    ``straggler_heavy`` commodity fleet: one worker's link is permanently
                        degraded 8x and compute-straggle bursts rotate
                        through the fleet — the shape where a relaxed
                        strategy wins wall-clock while losing the steps
                        race (a *permanent* compute straggler would bound
                        every strategy equally through the delivery gate;
                        jitter + congested wire is what relaxation buys)
    ``preemptible``     spot-instance flavor: periodic preemption windows
                        (DROPPED tau rows) plus mild transient straggles
    """
    base = dict(p=p, flops_per_s=(2e9,), hbm_bytes_per_s=(8e9,),
                link_bytes_per_s=(1e8,), link_latency_s=(1e-3,),
                apply_s=2e-3)
    if name == "uniform":
        return ClusterSpec(name=name, **{**base,
                                         "link_bytes_per_s": (2e9,)})
    if name == "straggler_heavy":
        events = [TraceEvent(step=0, kind="netdeg", worker=p - 1,
                             duration=0, factor=16.0)]
        stride = max(steps // 50, 6)
        for k in range(steps // stride):
            events.append(TraceEvent(
                step=k * stride + 1, kind="straggle", worker=k % p,
                duration=2, factor=6.0))
        return ClusterSpec(
            name=name,
            events=tuple(sorted(events, key=lambda e: e.step)), **base)
    if name == "preemptible":
        events = []
        stride = max(steps // 4, 8)
        for k in range(1, 4):
            events.append(TraceEvent(
                step=k * stride, kind="preempt",
                worker=k % p, duration=max(stride // 3, 2)))
        events.append(TraceEvent(step=stride // 2, kind="straggle",
                                 worker=0, duration=stride, factor=3.0))
        return ClusterSpec(name=name, events=tuple(events), **base)
    raise ValueError(f"unknown cluster preset {name!r}; "
                     f"one of uniform/straggler_heavy/preemptible")


PRESETS = ("uniform", "straggler_heavy", "preemptible")
