"""Trace-driven cluster performance model + co-simulation (counterpart of
``repro.cluster``).

`spec`  — `ClusterSpec`/`TraceEvent`: JSON-round-trippable fleet shapes
          with seeded straggler/preemption/congestion traces.
`perf`  — the discrete-event loop on a torch device: measured
          ``tau(t, worker)`` tables (DROPPED where preempted) + learner
          wall-clock curves, and the analytic roofline record.
`cosim` — joins the event loop with `core.sim_engine.simulate_grid` to
          rank (strategy, tau_max, compressor) by time-to-loss.
"""
from .cosim import (Candidate, CosimResult, DEFAULT_CANDIDATES,
                    load_wire_bytes, rank_candidates, winners)
from .perf import (ClusterRun, analytic_record, durations_table,
                   simulate_cluster, trace_tables)
from .spec import PRESETS, ClusterSpec, TraceEvent, preset

__all__ = [
    "Candidate", "ClusterRun", "ClusterSpec", "CosimResult",
    "DEFAULT_CANDIDATES", "PRESETS", "TraceEvent", "analytic_record",
    "durations_table", "load_wire_bytes", "preset", "rank_candidates",
    "simulate_cluster", "trace_tables", "winners",
]
