"""The port's spans (`repro_torch.trace`) in its two training steps, on
the CPU at the smoke size (qwen3-1.7b-smoke, 2 workers, batch 4 x 32).

* With no profiler recording, ``span`` hands back one shared null context
  and a whole step dispatches no record-function op.
* Under ``torch.profiler`` a fused top-k async step and a ``topk_ef``
  synchronous step record exactly the expected ``step.*`` and ``wait.*``
  spans, and the ``step.*`` spans never overlap one another.
* Every device->host read the audit's ``StepRecorder`` detects in an async
  step with ``skip_nonfinite`` lies inside a ``wait.*`` span.
* Four steps give bitwise the same losses and parameters with the
  profiler on and off.
"""
import collections
import contextlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.analysis import audit  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import SyncConfig  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLMDataset,  # noqa: E402
                                       to_device)
from repro_torch.dist.async_engine import (AsyncConfig,  # noqa: E402
                                           init_async_state,
                                           make_async_train_step)
from repro_torch.dist.train import (init_dist_sync_state,  # noqa: E402
                                    make_elastic_train_step)
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import init_params, param_specs  # noqa: E402
from repro_torch.optim import momentum  # noqa: E402

WORKERS, BATCH, SEQ = 2, 4, 32
ENTER = "profiler._record_function_enter_new"
EXIT = "profiler._record_function_exit"

# the spans of one step: forward and backward a worker, one compress a
# worker, one delivery, the gap passes and one update; the waits: RoPE's
# base copied to the device twice an attention layer (2 layers) a worker,
# and the async delivery plan's two copies
ROPE = {"wait.rope_theta": 2 * 2 * WORKERS}
EXPECTED = {
    "async": {"step.forward": 2, "step.backward": 2, "step.gap": 3,
              "step.compress": 2, "step.deliver": 1, "step.update": 1,
              "wait.delivery_plan": 2, **ROPE},
    "topk_ef": {"step.forward": 2, "step.backward": 2, "step.compress": 2,
                "step.deliver": 1, "step.gap": 1, "step.update": 1, **ROPE},
}


def _build(kind: str, skip_nonfinite: bool = False):
    """``(step, params, opt_state, state, batches)`` of a fresh smoke run
    (the same weights and batches every call)."""
    cfg = get_config("qwen3-1.7b-smoke")
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    opt = momentum(1e-2, 0.9)
    opt_state = opt.init(T.leaves(params))
    if kind == "async":
        acfg = AsyncConfig(tau_max=2, compressor="topk", topk_ratio=1 / 8,
                           horizon=64, seed=3,
                           skip_nonfinite=skip_nonfinite)
        state = init_async_state(acfg, WORKERS, params, specs)
        step = make_async_train_step(cfg, opt, acfg, WORKERS, specs)
    else:
        scfg = SyncConfig(strategy="topk_ef", topk_ratio=1 / 8)
        state = init_dist_sync_state(scfg, WORKERS, params)
        step = make_elastic_train_step(cfg, opt, scfg, WORKERS, specs)
    data = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH, seed=0)
    batches = [to_device(data.batch(t), "cpu") for t in range(4)]
    return step, params, opt_state, state, batches


def _run(step, params, opt_state, state, batches):
    losses = []
    for b in batches:
        params, opt_state, state, metrics = step(params, opt_state, state, b)
        losses.append(metrics["loss"])
    return params, opt_state, state, losses


def _profiled_step(kind: str):
    """The host events of one step after a warm-up step."""
    step, params, opt_state, state, batches = _build(kind)
    params, opt_state, state, _ = _run(step, params, opt_state, state,
                                       batches[:1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, params, opt_state, state, batches[1:2])
    return prof.events()


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = trace.span("step.forward")
    assert off is trace.span("wait.delivery_plan")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:                      # reentrant: nothing is entered
        pass


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_no_record_function_op_runs_without_a_profiler(kind):
    """A whole step dispatches no record-function op with no profiler,
    and one a span with one (the recorder sees the op either way)."""
    step, params, opt_state, state, batches = _build(kind)
    _run(step, params, opt_state, state, batches[:1])
    got = audit.record_step(step, (params, opt_state, state, batches[1]),
                            "cpu")
    assert not [n for n, _ in got["ops"] if n.startswith("profiler.")]
    with profile(activities=[ProfilerActivity.CPU]):
        got = audit.record_step(step, (params, opt_state, state,
                                       batches[2]), "cpu")
    enters = sum(n.startswith(ENTER) for n, _ in got["ops"])
    assert enters == sum(EXPECTED[kind].values())


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_step_records_its_spans(kind):
    events = _profiled_step(kind)
    spans = [e for e in events if e.name.startswith(("step.", "wait."))]
    assert all(getattr(e, "is_user_annotation", True) for e in spans)
    assert collections.Counter(e.name for e in spans) == EXPECTED[kind]
    phases = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in spans if e.name.startswith("step."))
    for (_, end, a), (start, _, b) in zip(phases, phases[1:]):
        assert end <= start, f"{a} overlaps {b}"
    # every wait lies inside the phase it interrupts
    within = {"wait.rope_theta": "step.forward",
              "wait.delivery_plan": "step.deliver"}
    for e in spans:
        if e.name.startswith("wait."):
            assert any(s <= e.time_range.start and e.time_range.end <= t
                       for s, t, n in phases if n == within[e.name])


class _SpanRecorder(audit.StepRecorder):
    """The audit's recorder, which also keeps the record-function ranges
    open at each device->host read it detects."""

    reads: list = []

    def __init__(self):
        super().__init__()
        self._open = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(ENTER):
            self._open.append(args[0])
        elif name.startswith(EXIT):
            self._open.pop()
        return super().__torch_dispatch__(func, types, args, kwargs)

    def hit(self, name):
        super().hit(name)
        self.reads.append((name, tuple(self._open)))


def test_every_host_read_of_the_step_is_a_named_wait(monkeypatch):
    step, params, opt_state, state, batches = _build("async",
                                                     skip_nonfinite=True)
    _run(step, params, opt_state, state, batches[:1])
    reads = []
    monkeypatch.setattr(_SpanRecorder, "reads", reads)
    monkeypatch.setattr(audit, "StepRecorder", _SpanRecorder)
    with profile(activities=[ProfilerActivity.CPU]):
        got = audit.record_step(step, (params, opt_state, state,
                                       batches[1]), "cpu")
    # each worker's finiteness read and the update's guard
    assert got["hits"] == {"aten._local_scalar_dense": WORKERS + 1}
    assert len(reads) == WORKERS + 1
    for name, open_ in reads:
        assert open_ and open_[-1].startswith("wait."), (name, open_)
    assert [o[-1] for _, o in reads] == ["wait.finite"] * (WORKERS + 1)


@pytest.mark.parametrize("kind", sorted(EXPECTED))
def test_profiler_on_and_off_give_the_same_bits(kind):
    runs = []
    for on in (False, True):
        step, params, opt_state, state, batches = _build(kind)
        with (profile(activities=[ProfilerActivity.CPU]) if on
              else contextlib.nullcontext()):
            params, _, _, losses = _run(step, params, opt_state, state,
                                        batches)
        runs.append((torch.stack(losses), T.leaves(params)))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    assert len(p0) == len(p1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
