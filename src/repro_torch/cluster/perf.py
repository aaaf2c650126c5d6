"""Discrete-event cluster performance model (counterpart of
``repro.cluster.perf``).

Def. 1 of the paper bounds *what* staleness may do to the iterate; this
module prices *where it comes from and what it costs*.  A `ClusterSpec`
(rates, bandwidths, trace events) plus a per-strategy cost point (flops and
bytes on the wire per step) is advanced step by step under the
bounded-staleness discipline:

  begin(t, w) = max(finish(t-1, w), A(t-1-tau_max))          worker gate
  finish(t,w) = begin(t, w) + d_w(t)                         message done
  A(t)        = max(A(t-1) + apply_s, max_w finish(t-tau_max, w))

The learner gate makes the staleness bound structural: step ``t`` cannot
close until every alive worker's step ``t - tau_max`` message has landed,
so the measured ``tau(t, worker)`` table always satisfies ``0 <= tau <=
tau_max`` (the invariant `core.delivery`'s rings pin), with `DROPPED` rows
exactly where the trace preempts a worker.  ``A`` is the learner's
cumulative wall clock, which co-simulation reads time-to-loss off.  With
``tau_max = 0`` the recurrence is bulk-synchronous SGD.

Where the reference traces one ``lax.scan``, the port runs an eager loop
over the steps on a torch device (the card unless the caller asks for the
CPU).  Its body is f32 adds, maxes and selects only, so the finish times
and the learner clock are bitwise the reference's on any device; the
durations and the tau table are computed on the host in f64, as there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.delivery import DROPPED, validate_tau_table

from .spec import ClusterSpec


def trace_tables(spec: ClusterSpec, t_len: int):
    """Expand the spec's trace events into (rates, bandwidth, alive) tables
    of shape ``(t_len, p)``: host-side, pre-drawn (oblivious adversary,
    as `sim_types.make_schedule`)."""
    rates = np.tile(spec.rates, (t_len, 1))
    bw = np.tile(spec.bandwidth, (t_len, 1))
    alive = np.ones((t_len, spec.p), bool)
    for ev in spec.events:
        w = ev.worker % spec.p
        s = min(ev.step, t_len)
        end = t_len if ev.duration == 0 else min(s + ev.duration, t_len)
        if ev.kind == "straggle":
            rates[s:end, w] /= ev.factor
        elif ev.kind == "netdeg":
            bw[s:end, w] /= ev.factor
        elif ev.kind == "preempt":
            alive[s:end, w] = False
    return rates, bw, alive


def durations_table(spec: ClusterSpec, t_len: int, flops: float,
                    wire_bytes: float, hbm_bytes: float = 0.0):
    """Per-(step, worker) message durations in seconds: the roofline max of
    compute and HBM terms, plus the wire term.  Returns ``(d, alive)``."""
    rates, bw, alive = trace_tables(spec, t_len)
    t_work = np.maximum(flops / rates, hbm_bytes / spec.hbm[None, :])
    d = t_work + wire_bytes / bw + spec.latency[None, :]
    return d.astype(np.float32), alive


def event_loop(d: torch.Tensor, alive: torch.Tensor, apply_s: torch.Tensor,
               tau_max: int):
    """The recurrence above on ``d``'s device: d (T, p) f32 durations,
    alive (T, p) bool, apply_s a 0-dim f32.  Returns (finishes (T, p),
    closes (T,)) f32 on that device; no step waits on the host.

    The reference's ring of the last ``tau_max + 1`` gated finish rows
    becomes each step's row maximum (``gate[s]``, a dead worker's entry 0,
    which never gates since A is nonnegative and nondecreasing), read
    ``tau_max`` steps later; the history of A is ``closes`` itself."""
    t_len, p = d.shape
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    fins = torch.empty((t_len, p), dtype=torch.float32, device=d.device)
    closes = torch.empty((t_len,), dtype=torch.float32, device=d.device)
    gate = torch.empty((t_len,), dtype=torch.float32, device=d.device)
    fin = torch.zeros((p,), dtype=torch.float32, device=d.device)
    for t in range(t_len):
        a_prev = closes[t - 1] if t >= 1 else zero             # A(t-1)
        a_old = closes[t - 1 - tau_max] if t >= 1 + tau_max else zero
        fin = torch.where(alive[t], torch.maximum(fin, a_old) + d[t], a_prev)
        fins[t] = fin
        gate[t] = torch.where(alive[t], fin, zero).amax()
        closes[t] = torch.maximum(a_prev + apply_s,
                                  gate[t - tau_max] if t >= tau_max else zero)
    return fins, closes


@dataclass(frozen=True)
class ClusterRun:
    """One event-loop rollout: measured staleness + wall clock, and the
    device the loop ran on with its host seconds (upload to download)."""
    spec: ClusterSpec
    tau_max: int
    taus: np.ndarray       # (T, p) int32, DROPPED where preempted
    closes: np.ndarray     # (T,) cumulative learner wall-clock A(t)
    finishes: np.ndarray   # (T, p) message finish times
    durations: np.ndarray  # (T, p) message durations
    device: str = "cuda"
    loop_s: float = 0.0

    @property
    def total_s(self) -> float:
        return float(self.closes[-1])

    def time_at(self, step: int) -> float:
        """Wall-clock seconds when learner step ``step`` closes."""
        return float(self.closes[min(max(step, 0), len(self.closes) - 1)])

    def tau_histogram(self) -> dict:
        vals, counts = np.unique(self.taus, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}


def simulate_cluster(spec: ClusterSpec, t_len: int, tau_max: int,
                     flops_per_step: float, wire_bytes: float,
                     hbm_bytes: float = 0.0, device="cuda") -> ClusterRun:
    """Advance the cluster ``t_len`` steps on ``device`` and extract the
    measured tau table.  The rollout is extended by ``tau_max`` extra steps
    so every message produced inside the horizon has its delivery window
    closed."""
    t_ext = t_len + tau_max
    dev = torch.device(device)
    d, alive = durations_table(spec, t_ext, flops_per_step, wire_bytes,
                               hbm_bytes)
    t0 = time.perf_counter()
    fins, closes = event_loop(
        torch.from_numpy(d).to(dev), torch.from_numpy(alive).to(dev),
        torch.tensor(np.float32(spec.apply_s), device=dev), tau_max)
    fins = fins.cpu().numpy().astype(np.float64)
    closes = closes.cpu().numpy().astype(np.float64)
    loop_s = time.perf_counter() - t0
    if tau_max == 0:
        taus = np.zeros((t_len, spec.p), np.int32)
    else:
        # tau(s, w) = #{k in [0, tau_max) : A(s+k) < finish(s, w)}; the
        # learner gate guarantees A(s+tau_max) >= finish(s, w), so the
        # count never exceeds tau_max.
        win = np.lib.stride_tricks.sliding_window_view(
            closes, tau_max)[:t_len]                       # (T, tau_max)
        taus = (win[:, :, None] < fins[:t_len, None, :]).sum(axis=1)
    taus = np.where(alive[:t_len], taus, DROPPED).astype(np.int32)
    validate_tau_table(taus, tau_max)
    return ClusterRun(spec=spec, tau_max=tau_max, taus=taus,
                      closes=closes[:t_len], finishes=fins[:t_len],
                      durations=np.asarray(d[:t_len], np.float64),
                      device=str(dev), loop_s=loop_s)


# -- analytic roofline terms (bench_roofline fallback) ---------------------

def analytic_record(arch: str, shape_name: str, *, chips: int = 256) -> dict:
    """First-order cost point for (arch, shape), shaped like a
    ``launch.dryrun`` artifact: flops from the parameter-count model, HBM
    bytes from weight + activation traffic, collective bytes from a ring
    all-reduce of bf16 gradients."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n = cfg.active_param_count()
    tokens = shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len)
    flops = (6.0 if shape.kind == "train" else 2.0) * n * tokens
    # weights are streamed once per pass (forward, backward and the
    # optimizer for train) for batched passes, but re-read per token when
    # decoding
    passes = 3.0 if shape.kind == "train" else 1.0
    weight_bytes = 2.0 * n * passes * (tokens if shape.kind == "decode"
                                       else 1.0)
    act_bytes = 12.0 * tokens * cfg.d_model * cfg.n_layers
    kv_bytes = (4.0 * shape.global_batch * shape.seq_len * cfg.d_model
                if shape.kind == "decode" else 0.0)
    coll = 4.0 * n if shape.kind == "train" else 0.0
    mem_gb = (2.0 * cfg.param_count() + kv_bytes) / chips / 2**30
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": "single", "source": "cluster-model",
        "costs": {
            "flops": flops / chips,
            "bytes": (weight_bytes + act_bytes + kv_bytes) / chips,
            "collectives": {"all-reduce": coll / chips,
                            "total": coll / chips},
        },
        "memory": {"peak_per_device_gb": round(mem_gb, 4)},
    }
