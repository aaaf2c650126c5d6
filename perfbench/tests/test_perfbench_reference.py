"""The plain reference against the program's CPU step at the small
configurations, the control and the faults: a run whose timed path is
broken underneath comes out not correct."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, smoke  # noqa: E402
from perfbench.reference import model  # noqa: E402

CPU = torch.device("cpu")
SEED = 3_000_000_007
CASES = [("qwen3-async-topk", "qwen3-1.7b"),
         ("mixtral-topk-ef", "mixtral-8x7b"),
         ("mixtral-topk-ef", "moonshot-v1-16b-a3b"),
         ("qwen3-async-topk", "moonshot-v1-16b-a3b")]


def readings(cell, seed=SEED, **fault):
    dm, tr = harness.arch.dims(cell["config_file"]), cell["traffic_file"]
    stream = harness.MarkovStream(dm["vocab_size"], tr["seq"], tr["batch"],
                                  seed, tr["order_states"])
    return stream, harness.reference_readings(cell, seed, stream, CPU,
                                              **fault)


@pytest.mark.parametrize("cell,port", CASES)
def test_reference_leaves_are_the_programs(cell, port):
    from repro_torch import tree as T
    from repro_torch.models import transformer as TF

    for c in (harness.load_cell(cell), smoke.smoke_cell(cell, port)):
        defs = TF.model_defs(harness.port_arch(c["config_file"]))
        want = model.leaf_shapes(harness.arch.dims(c["config_file"]))
        got = dict(zip(T.paths(defs),
                       (tuple(d.shape) for d in T.leaves(defs))))
        assert list(got) == list(want) and got == want


@pytest.mark.parametrize("cell,port", CASES)
def test_program_within_limits_of_reference(cell, port):
    c = smoke.smoke_cell(cell, port)
    stream, want = readings(c)
    prog = harness.Program(c, SEED, CPU)
    got = harness.host_readings(
        harness.setup_steps(prog, stream,
                            harness.checked_steps(c["traffic_file"])),
        prog.paths)
    gaps = harness.compare(got, want)
    assert got["losses"][0] == want["losses"][0]
    for k, limit in c["limits"].items():
        assert gaps[k] <= limit, (k, gaps[k])
    assert gaps["left_out"] == []


@pytest.mark.parametrize("cell,port", CASES[:2])
def test_control_fails(cell, port):
    """The reference in float8 operands, put in the program's place."""
    c = smoke.smoke_cell(cell, port)
    _, want = readings(c)
    _, got = readings(c, quant=model.fp8)
    gaps = harness.compare(got, want)
    assert any(gaps[k] > v for k, v in c["limits"].items()), gaps


def test_slot_kept_fails():
    """The reference with its delay ring's slot not cleared after a take,
    put in the program's place."""
    c = smoke.smoke_cell(*CASES[0])
    assert harness.checked_steps(c["traffic_file"]) == 6
    _, want = readings(c)
    _, got = readings(c, keep_slot=True)
    gaps = harness.compare(got, want)
    assert any(gaps[k] > v for k, v in c["limits"].items()), gaps


def _unchanged(monkeypatch):
    from repro_torch.dist import train
    monkeypatch.setattr(train, "apply_updates", lambda params, updates:
                        params)


def _half_batch(monkeypatch):
    from repro_torch.dist.workers import WorkerGroup, shard_batch

    def half(self, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        shards = shard_batch({k: v[:rows] for k, v in batch.items()},
                             self.n)
        return [shards[w] for w in self.local]
    monkeypatch.setattr(WorkerGroup, "shard_batch", half)


def _no_exchange(monkeypatch):
    from repro_torch.dist.workers import WorkerGroup
    monkeypatch.setattr(WorkerGroup, "all_gather",
                        lambda self, items: torch.stack(items[:1]))


def _altered_payload(monkeypatch):
    """Each compressed message's values doubled where K1 makes them."""
    from repro_torch.kernels.cr_reduce import ops
    compress = ops.topk_compress_rows

    def doubled(rows, err_rows, ratio, **kw):
        vals, idx, err = compress(rows, err_rows, ratio, **kw)
        return vals * 2, idx, err
    monkeypatch.setattr(ops, "topk_compress_rows", doubled)


def _slot_kept(monkeypatch):
    """The delay ring's slot not cleared after its take: what a step
    deposits into the slot it takes stays there, and is taken again a
    turn of the ring later."""
    from repro_torch.dist.async_engine import AsyncTrainStep
    from repro_torch.kernels.cr_reduce import ops
    deliver, deposit = AsyncTrainStep._fused_delivery, ops.topk_deposit
    now, kept = [0], []

    def recorded(acc, *args):
        deposit(acc, *args)
        kept.append((acc, acc[now[0]].clone()))

    def keep(self, state, payloads, step, tab):
        now[0] = step % self.acfg.capacity
        kept.clear()
        out = deliver(self, state, payloads, step, tab)
        for acc, fresh in kept:
            acc[now[0]].copy_(fresh)
        return out
    monkeypatch.setattr(ops, "topk_deposit", recorded)
    monkeypatch.setattr(AsyncTrainStep, "_fused_delivery", keep)


FAULTS = [_unchanged, _half_batch, _no_exchange, _altered_payload]
BROKEN = [(c, p, f) for c, p in CASES[:2] for f in FAULTS] \
    + [(*CASES[0], _slot_kept)]


@pytest.mark.parametrize(
    "cell,port,fault", BROKEN,
    ids=lambda x: x.__name__.strip("_") if callable(x) else x)
def test_broken_step_is_not_correct(cell, port, fault, monkeypatch):
    c = smoke.smoke_cell(cell, port)
    fault(monkeypatch)
    out = harness.run_cell(c, SEED, 0.05, False, CPU, time.perf_counter())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,port", CASES[:2])
def test_sound_run_is_correct(cell, port):
    c = smoke.smoke_cell(cell, port)
    out = harness.run_cell(c, SEED, 0.05, False, CPU, time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert list(out)[-2:] == ["checks", "_extra"]
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p90",
                                   "peak_mem_gib", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,port", CASES[:2])
def test_traced_run_is_correct(cell, port):
    """A traced run: the device-only span and the span with the host's
    operations, then the same comparison; on the CPU no device operation
    is seen, so only the window's metrics are read."""
    import json
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, layer = harness.cell_metrics(spec, cell)
    c = smoke.smoke_cell(cell, port)
    out = harness.run_cell(c, SEED, 0.05, True, CPU, time.perf_counter(),
                           metric_names=layer)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) <= set(layer) and "mfu" in out["metrics"]
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["_extra"]["host_ms"]["call"]) == out["attempted"]
