"""The readers of the metrics taken from the program's own spans, on a
small hand-made context: the arithmetic of each, what each reads where the
program has no spans, and the device-time readers on the edges of a trace
that the profiler leaves now and then."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, peaks  # noqa: E402
from perfbench.counts import kernel_bytes  # noqa: E402

STEPS = 2
LEAVES = [1 << 20, 4096]
TRAFFIC = {"workers": 2, "topk_ratio": 1 / 16, "sync": "async",
           "error_feedback": True}
# K1's bytes a step: 2 workers x (12 B an entry + 8 B a kept entry), at
# k = 65,536 and 256
K1_BYTES = 2 * (12 * (1 << 20) + 8 * 65536) + 2 * (12 * 4096 + 8 * 256)

# one step's host events (name, start us, end us) as the span traced with
# the host's operations holds them, each runtime call with the device
# microseconds of the operation it enqueues
TIMELINE = [
    ("bench.step", 0.0, 11450.0, None),
    ("cudaLaunchKernel", 5.0, 6.0, 1.0),        # before the model: not its
    ("step.forward", 10.0, 100.0, None),
    ("cudaLaunchKernel", 20.0, 21.0, 2.0),
    ("cuLaunchKernelEx", 30.0, 31.0, 3.0),
    ("cudaMemcpyAsync", 50.0, 51.0, 10.0),      # a copy, not a launch
    ("step.backward", 100.0, 300.0, None),
    ("cudaLaunchKernel", 150.0, 151.0, 4.0),
    # autograd's own thread: its op lies inside step.backward's host
    # interval but is no child of it, and its launch counts by its time
    ("autograd::engine::evaluate_function: MulBackward0", 240.0, 260.0,
     None),
    ("cudaLaunchKernel", 245.0, 246.0, 5.0),
    ("cudaLaunchKernelExC", 299.0, 300.0, 6.0),
    ("step.compress", 300.0, 400.0, None),
    ("cuLaunchKernel", 350.0, 351.0, 7000.0),   # the port's own kernels
    ("cuLaunchKernelEx", 360.0, 361.0, 3000.0),
    ("cudaMemsetAsync", 370.0, 371.0, 250.0),
    ("step.deliver", 400.0, 11000.0, None),
    # a copy from pageable memory, which waits for the stream to drain
    ("wait.delivery_plan", 410.0, 10700.0, None),
    ("cudaMemcpyAsync", 412.0, 413.0, 1.0),
    ("cudaStreamSynchronize", 414.0, 10690.0, None),
    ("wait.delivery_plan", 10700.0, 10760.0, None),
    ("cudaMemcpyAsync", 10702.0, 10703.0, 1.0),
    ("cudaStreamSynchronize", 10704.0, 10750.0, None),
    ("cudaMemcpyAsync", 10800.0, 10801.0, 500.0),
    ("cuLaunchKernelEx", 10810.0, 10811.0, 1500.0),
    ("step.gap", 11000.0, 11100.0, None),
    ("cudaLaunchKernel", 11010.0, 11011.0, 800.0),
    ("step.update", 11100.0, 11400.0, None),
    ("cudaLaunchKernel", 11200.0, 11201.0, 900.0),
    ("cudaLaunchKernel", 11210.0, 11211.0, 1100.0),
    ("cudaDeviceSynchronize", 11500.0, 15610.0, None),
]
HOST = [(n, s, e) for n, s, e, _ in TIMELINE]


def _device(timeline, free=0.0):
    """The device's operations (name, start us, duration us): one stream,
    busy until ``free``, runs each call's operation in call order, 5 us
    after the call at the earliest; a synchronize returns after everything
    before it ran."""
    ops = []
    for n, s, e, us in timeline:
        if n.endswith("Synchronize"):
            assert e >= free, (n, s)
        if us is None:
            continue
        name = ("Memcpy HtoD" if n.startswith("cudaMemcpy") else
                "Memset (Device)" if n.startswith("cudaMemset") else
                f"kernel_{s:g}")
        start = max(s + 5.0, free)
        ops.append((name, start, us))
        free = start + us
    return ops


DEVICE = _device(TIMELINE)
# the ranges' device time in the profiler's tree, which misses the port's
# own kernels: not read
RANGES = {"bench.step": 0.05, "step.compress": 1e-6}
COMPRESS_US = 7000 + 3000 + 250

READS = {
    "compress_ms_per_step": COMPRESS_US * 1e-3 / STEPS,
    "deliver_ms_per_step": (1 + 1 + 500 + 1500) * 1e-3 / STEPS,
    "gap_ms_per_step": 800 * 1e-3 / STEPS,
    "update_ms_per_step": (900 + 1100) * 1e-3 / STEPS,
    "compress_roofline_pct": 100.0 * K1_BYTES * STEPS
    / peaks.HBM_BYTES_PER_S / (COMPRESS_US * 1e-6),
    "model_launches_per_step": 5 / STEPS,
    "host_waits_per_step": 2 / STEPS,
    "host_wait_ms_per_step": (10290.0 + 60.0) * 1e-3 / STEPS,
}
DEVICE_TIME = ["compress_ms_per_step", "compress_roofline_pct",
               "deliver_ms_per_step", "gap_ms_per_step",
               "update_ms_per_step"]


def _ctx(host=HOST, ranges=RANGES, device=DEVICE):
    return SimpleNamespace(steps=STEPS, ranges=ranges,
                           _host_span=(device, host), leaf_sizes=LEAVES,
                           traffic=TRAFFIC, peaks=peaks,
                           kernel_bytes=kernel_bytes)


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_the_spans(name):
    got = harness.load_metric(name).read(_ctx())
    assert got == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_nothing_without_the_programs_spans(name):
    """A program without spans (the benchmark's own ranges and a model's
    range only) gives every reader nothing to read, and none raises."""
    host = [h for h in HOST if not h[0].startswith(("step.", "wait."))]
    ranges = {"bench.step": 0.05, "moe_dispatch": 0.001}
    assert harness.load_metric(name).read(_ctx(host, ranges)) is None


# what the profiler does to a trace now and then: an operation of the
# warm-up step kept before the traced steps' first, an operation lost at the
# span's head or tail, and a device clock that drifts from the host's, so
# that operations seem to start before their calls
EDGES = {
    "extra_op_at_head": (HOST, [("kernel_warmup", 1.0, 40.0)]
                         + _device(TIMELINE, free=41.0)),
    "op_lost_at_head": (HOST, DEVICE[1:]),
    "op_lost_at_tail": (HOST + [("cudaLaunchKernel", 11420.0, 11421.0)],
                        DEVICE),
    "clock_drift": (HOST, [(n, 0.5 * s, d) for n, s, d in DEVICE]),
}


@pytest.mark.parametrize("name", DEVICE_TIME)
@pytest.mark.parametrize("case", sorted(EDGES))
def test_device_time_pairs_by_order_at_the_edges(name, case):
    """Each device operation keeps its own call: by order, whatever the
    device clock says, with a surplus at the head or the tail left out."""
    host, device = EDGES[case]
    got = harness.load_metric(name).read(_ctx(host, device=device))
    assert got == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("name", DEVICE_TIME)
def test_device_time_reads_nothing_where_counts_differ_widely(name):
    """A trace that lost more calls than ``spans.MAX_SURPLUS`` is not
    paired, and the device-time readers read nothing."""
    from perfbench import spans
    extra = [("kernel_warmup", float(i), 0.5)
             for i in range(spans.MAX_SURPLUS + 1)]
    device = extra + _device(TIMELINE, free=spans.MAX_SURPLUS + 1.0)
    assert harness.load_metric(name).read(_ctx(device=device)) is None


@pytest.mark.parametrize("name", DEVICE_TIME)
def test_device_time_reads_nothing_after_a_loss_inside_the_trace(name):
    """A kernel lost in the middle of the trace (backward's, at 245 us)
    leaves the calls and operations out of step whichever end the surplus
    call is cut from, so every later pairing would be off by one: the
    device-time readers read nothing."""
    device = [d for d in DEVICE if d[0] != "kernel_245"]
    assert len(device) == len(DEVICE) - 1
    assert harness.load_metric(name).read(_ctx(device=device)) is None


@pytest.mark.parametrize("name", ["host_waits_per_step",
                                  "host_wait_ms_per_step"])
def test_a_program_with_spans_and_no_waits_reads_zero(name):
    host = [h for h in HOST if not h[0].startswith("wait.")]
    assert harness.load_metric(name).read(_ctx(host)) == 0.0
