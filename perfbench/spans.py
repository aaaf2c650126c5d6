"""Device time under the program's spans (`repro_torch.trace`), read from
the span a `perfbench.harness.TraceContext` traced with the host's
operations.

A kernel that the program launches outside any PyTorch operation (the
port's CUDA kernels, launched through ``ctypes``) is linked to no host
operation in the profiler's tree, so a range's device time in
``TraceContext.ranges`` leaves it out.  Here each device operation is
paired with the runtime call that enqueued it instead, by order alone.
The port runs on one stream, which runs what it is given in order, so the
n-th kernel launch call (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
enqueued the n-th kernel, and so for copies and fills.  Times do not pair
them: the profiler's device clock drifts from the host's, on the card by
over 30 ms a second of trace, more than the device lags the host.

Now and then the profiler keeps a device operation whose call lies before
the traced steps (the warm-up step's last ones), or loses one at the
span's edge.  Where a kind's counts differ, the surplus is taken from the
head or the tail of its list, split as makes the two merged sequences of
kinds (calls in host order, operations in device order) agree.  Where no
split makes them agree, something was lost inside the trace, every pairing
after it is off by one, and the trace is not paired.  A loss inside the
trace that leaves the kinds in step (an operation of the same kind as its
neighbours) cannot be seen here: correlation ids would show it, and
``TraceContext`` keeps none.  A device operation counts for a span when its
call starts inside one of the span's host intervals, whichever thread made
it (autograd launches the backward from its own).
"""
from __future__ import annotations

import bisect
import itertools

CALLS = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
         "copy": ("cudaMemcpy", "cuMemcpy"),
         "fill": ("cudaMemset", "cuMemset")}
# a trace whose counts differ by more than this is not paired
MAX_SURPLUS = 16


def _call_kind(name: str):
    for kind, prefixes in CALLS.items():
        if name.startswith(prefixes):
            return kind
    return None


def _op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def intervals(ctx, name: str) -> list:
    """The host intervals (start us, end us) of the spans named ``name``."""
    return sorted((s, e) for n, s, e in ctx._host_span[1] if n == name)


def inside(t: float, spans: list) -> bool:
    """Whether ``t`` lies in one of ``spans``: sorted, disjoint (start,
    end) intervals."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and t <= spans[i][1]


def _trim(items: list, cut: dict) -> list:
    """``items`` ((key, kind, ...), in order) without the first ``h`` and
    the last ``t`` of each kind, ``cut[kind] == (h, t)``."""
    count = {kind: 0 for kind in CALLS}
    total = {kind: 0 for kind in CALLS}
    for it in items:
        total[it[1]] += 1
    out = []
    for it in items:
        k = it[1]
        h, t = cut.get(k, (0, 0))
        if h <= count[k] < total[k] - t:
            out.append(it)
        count[k] += 1
    return out


def pairs(ctx):
    """``(call start us, device us)`` of each device operation of the span
    traced with the host's operations; ``None`` where the counts differ by
    more than ``MAX_SURPLUS``, or no cut at the head or the tail makes the
    merged sequences of kinds agree."""
    ops, host = ctx._host_span
    calls = sorted((s, k) for n, s, _ in host
                   if (k := _call_kind(n)) is not None)
    ran = sorted((s, _op_kind(n), d) for n, s, d in ops)
    surplus = {k: sum(o[1] == k for o in ran) - sum(c[1] == k for c in calls)
               for k in CALLS}
    if sum(map(abs, surplus.values())) > MAX_SURPLUS:
        return None
    # every split of each kind's surplus between head and tail, all at the
    # head first
    for heads in itertools.product(*(range(abs(m), -1, -1)
                                     for m in surplus.values())):
        cut_calls, cut_ops = {}, {}
        for (k, m), h in zip(surplus.items(), heads):
            (cut_ops if m > 0 else cut_calls)[k] = (h, abs(m) - h)
        c, o = _trim(calls, cut_calls), _trim(ran, cut_ops)
        if all(a[1] == b[1] for a, b in zip(c, o)):
            break
    else:
        return None
    out = []
    for kind in CALLS:
        out += zip((x[0] for x in c if x[1] == kind),
                   (x[2] for x in o if x[1] == kind))
    return out


def device_seconds(ctx, name: str):
    """Device seconds a traced span spent on the operations enqueued inside
    the spans named ``name``; ``None`` where the program has no such span,
    or the trace cannot be paired."""
    spans = intervals(ctx, name)
    if not spans:
        return None
    paired = pairs(ctx)
    if paired is None:
        return None
    return sum(d for t, d in paired if inside(t, spans)) * 1e-6
