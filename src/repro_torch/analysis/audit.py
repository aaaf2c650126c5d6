"""Step auditor: run every registered entry point and check what ships
(counterpart of ``repro.analysis.audit``).

Four checks over `repro_torch.analysis.entrypoints`' registry, each the
port's counterpart of one of the reference's jaxpr checks:

  * **collective inventory** — one step of each entry with its
    `WorkerGroup` (the data-parallel workers' collectives): the group's
    ``wire`` counter gives ``{kind: {count, bytes}}`` and ``wire_bytes``
    by the reference's byte model (a sum counts twice its payload, a
    gather its output).  The compressed sync strategies (``topk_ef``,
    ``onebit_ef``) must put strictly fewer bytes on the wire than the
    dense ``sync`` baseline (:func:`wire_comparison`, as the
    reference's).
  * **host-sync detector** (counterpart of ``find_callbacks``) — a
    ``TorchDispatchMode`` over one step records each device->host read:
    ``aten._local_scalar_dense`` (``.item()``, ``bool()`` / ``float()`` of
    a tensor), a ``_to_copy`` / ``copy_`` from a device to the CPU and
    ``nonzero`` (its size is read on the host); ``Tensor.cpu``,
    ``.numpy`` and ``.tolist`` are recorded where they are called (on the
    CPU they dispatch nothing).  On a card the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` are counted too
    (``info["cuda_syncs"]``).  Each recorded op is a
    ``host-sync-in-hot-path`` finding naming the entry and the op; reads
    the port makes on purpose are baselined with their reason.
  * **in-place realization** (counterpart of the donation audit) — for an
    entry with a contract (``donate``), a fresh build is stepped once and
    every tensor leaf of each contracted argument must keep its
    ``untyped_storage().data_ptr()`` across the step and come back in the
    step's outputs; otherwise ``donation-unrealized``.  ``--no-compile``
    skips these runs.
  * **retrace hazard** (counterpart of ``jaxpr_hash``) — sha1, cut to 16
    hex digits, of the sequence of (aten op, input shapes and dtypes) the
    dispatch mode records over one step.  A second build of the entry,
    and its ``variant`` where the registry gives one, must hash the same:
    a different sequence is a program that depends on its configuration's
    values, which a CUDA graph of the step could not capture.

Every build is stepped once before the step that is recorded, so the
recorded step is a steady one, as a CUDA graph is captured after a warm-up:
on a card the kernel wrappers allocate their scratch at the first call of
a row geometry (K1's zeroed rows), which a second build, or an entry run
after another of the same geometry, would not repeat.

Each entry's ``info`` also carries the launch counts of the kernel
wrappers its first step made (on a card, the wrappers' own counters; on
the CPU, the calls of their plain versions), the op count and hash, and
the recorded host reads.  An entry that cannot be built or run is an
``entrypoint-broken`` finding, as in the reference.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as T
from repro_torch.analysis.findings import Finding, Report

#: compressed sync strategies that must strictly beat the dense baseline
MUST_BEAT_SYNC = ("topk_ef", "onebit_ef")

#: each kernel wrapper's plain version: (ops module, its name there)
PLAIN_VERSIONS = {
    "topk_ef": ("repro_torch.kernels.topk_ef.ops", "topk_ef_plain"),
    "topk_cr_deposit": ("repro_torch.kernels.cr_reduce.ops",
                        "topk_cr_deposit_plain"),
    "onebit_cr_deposit": ("repro_torch.kernels.cr_reduce.ops",
                          "onebit_cr_deposit_plain"),
    "topk_cr_reduce": ("repro_torch.kernels.cr_reduce.ops",
                       "topk_cr_reduce_plain"),
    "onebit_cr_reduce": ("repro_torch.kernels.cr_reduce.ops",
                         "onebit_cr_reduce_plain"),
    "delivery_step": ("repro_torch.kernels.sim_step.ops",
                      "delivery_step_plain"),
    "sync_step": ("repro_torch.kernels.sim_step.ops", "sync_step_plain"),
    "onebit_ef": ("repro_torch.kernels.onebit_ef.ops", "onebit_ef_plain"),
    "swa_decode_attention": ("repro_torch.kernels.swa_attention.ops",
                             "swa_decode_plain"),
    "ssd_chunked": ("repro_torch.kernels.ssd.ops", "ssd_plain"),
}
# Tensor methods whose host read dispatches nothing on a CPU tensor
_HOST_METHODS = ("cpu", "numpy", "tolist")


def _f(rule, where, detail):
    return Finding(pass_name="audit", rule=rule, where=where, detail=detail)


# ---------------------------------------------------------------------------
# recording one step
# ---------------------------------------------------------------------------

class StepRecorder(TorchDispatchMode):
    """Records every aten op with its input shapes and dtypes, and each
    device->host read (``hits``: op name -> count)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.hits: dict = {}
        self._quiet = 0           # inside a recorded Tensor method

    def hit(self, name: str) -> None:
        self.hits[name] = self.hits.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        self.ops.append((name, tuple(
            (tuple(t.shape), str(t.dtype))
            for t in T.tensors((args, kwargs)))))
        if not self._quiet:
            if name.startswith("aten._local_scalar_dense"):
                self.hit("aten._local_scalar_dense")
            elif name.startswith("aten.nonzero.") or name == "aten.nonzero":
                self.hit("aten.nonzero")
            elif name.startswith("aten._to_copy"):
                dst = kwargs.get("device")
                if dst is not None and torch.device(dst).type == "cpu" \
                        and args[0].device.type != "cpu":
                    self.hit("aten._to_copy (device to host)")
            elif name.startswith("aten.copy_"):
                if args[0].device.type == "cpu" \
                        and args[1].device.type != "cpu":
                    self.hit("aten.copy_ (device to host)")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _host_methods(rec: StepRecorder):
    """Record ``Tensor.cpu`` / ``.numpy`` / ``.tolist`` calls (their
    ``_to_copy`` not counted again)."""
    saved = {m: torch.Tensor.__dict__.get(m) for m in _HOST_METHODS}
    base = {m: getattr(torch.Tensor, m) for m in _HOST_METHODS}

    def wrap(m):
        def method(self, *a, **k):
            rec.hit(f"Tensor.{m}")
            rec._quiet += 1
            try:
                return base[m](self, *a, **k)
            finally:
                rec._quiet -= 1
        return method

    for m in _HOST_METHODS:
        setattr(torch.Tensor, m, wrap(m))
    try:
        yield
    finally:
        for m, old in saved.items():
            if old is None:
                delattr(torch.Tensor, m)
            else:
                setattr(torch.Tensor, m, old)


@contextlib.contextmanager
def kernel_counts(device_type: str, out: dict):
    """Fill ``out`` with the kernel wrappers' launches inside the block:
    on ``cuda`` their own counters' increase, elsewhere the calls of their
    plain versions (patched in the ops modules for the block)."""
    from repro_torch.kernels import all_kernels
    if device_type == "cuda":
        kernels = all_kernels()
        before = {k.name: k.launches for k in kernels}
        try:
            yield
        finally:
            for k in kernels:
                out[k.name] = k.launches - before[k.name]
        return
    patched = []
    for name, (mod_name, attr) in PLAIN_VERSIONS.items():
        mod = importlib.import_module(mod_name)
        plain = getattr(mod, attr)
        out[name] = 0

        def counted(*a, _plain=plain, _name=name, **k):
            out[_name] += 1
            return _plain(*a, **k)

        setattr(mod, attr, counted)
        patched.append((mod, attr, plain))
    try:
        yield
    finally:
        for mod, attr, plain in patched:
            setattr(mod, attr, plain)


def op_hash(ops) -> str:
    """sha1 (16 hex digits) of an op sequence."""
    return hashlib.sha1(repr(ops).encode()).hexdigest()[:16]


def record_step(fn, args, device_type: str) -> dict:
    """Run ``fn(*args)`` once under the recorder: ``{"ops", "hits",
    "kernels", "cuda_syncs", "out"}``."""
    rec, kernels = StepRecorder(), {}
    cuda_syncs = None
    with contextlib.ExitStack() as stack:
        if device_type == "cuda":
            caught = stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, old)
        stack.enter_context(kernel_counts(device_type, kernels))
        stack.enter_context(_host_methods(rec))
        stack.enter_context(rec)
        out = fn(*args)
    if device_type == "cuda":
        torch.cuda.synchronize()
        cuda_syncs = sum("synchroniz" in str(w.message) for w in caught)
    return {"ops": rec.ops, "hits": rec.hits, "kernels": kernels,
            "cuda_syncs": cuda_syncs, "out": out}


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def inplace_check(entry) -> list:
    """The argument indices of ``entry``'s contract whose leaves the step
    did not update in place: a leaf of the argument moved to other
    storage, or the step handed back other storage for it."""
    fn, args = entry.build()
    before = {i: [_ptr(t) for t in T.tensors(args[i])] for i in entry.donate}
    out = fn(*args)
    returned = {_ptr(t) for t in T.tensors(out)}
    return [i for i, ptrs in before.items()
            if [_ptr(t) for t in T.tensors(args[i])] != ptrs
            or not set(ptrs) <= returned]


# ---------------------------------------------------------------------------
# per-entry audits
# ---------------------------------------------------------------------------

def _device_type(args) -> str:
    for t in T.tensors(args):
        return t.device.type
    return "cpu"


def audit_entry(entry, *, compile_donation: bool = True) -> tuple:
    """(findings, info) for one registry entry."""
    findings: list = []
    fn, args = entry.build()
    device_type = _device_type(args)
    group = getattr(fn, "group", None)
    fn(*args)                                   # the warm-up step
    if group is not None:
        group.reset_wire()
    got = record_step(fn, args, device_type)
    inv = {k: dict(v) for k, v in (group.wire if group else {}).items()}
    inv["wire_bytes"] = group.wire_bytes() if group else 0
    info = {"collectives": inv, "op_hash": op_hash(got["ops"]),
            "ops": len(got["ops"]), "host_syncs": got["hits"],
            "cuda_syncs": got["cuda_syncs"], "kernels": got["kernels"]}
    del got

    for name in sorted(info["host_syncs"]):
        findings.append(_f("host-sync-in-hot-path", entry.name,
                           f"device->host read '{name}' inside a per-step "
                           f"program"))

    # retrace: a second build, and the registry's must-not-retrace variant
    fn2, args2 = entry.build()
    fn2(*args2)
    if op_hash(record_step(fn2, args2, device_type)["ops"]) \
            != info["op_hash"]:
        findings.append(_f("retrace-hazard", entry.name,
                           "two builds of the same config run different op "
                           "sequences (a nondeterministic build)"))
    del fn2, args2
    if entry.variant is not None:
        fn_v, args_v = entry.variant()
        fn_v(*args_v)
        hv = op_hash(record_step(fn_v, args_v, device_type)["ops"])
        info["variant_op_hash"] = hv
        if hv != info["op_hash"]:
            findings.append(_f(
                "retrace-hazard", entry.name,
                "a config variant that must share the program runs a "
                "different op sequence (per-config recapture hazard)"))
        del fn_v, args_v

    if compile_donation and entry.donate:
        bad = inplace_check(entry)
        info["in_place"] = not bad
        if bad:
            findings.append(_f(
                "donation-unrealized", entry.name,
                f"in-place contract {entry.donate} declared but argument(s) "
                f"{tuple(bad)} were not updated in place"))
    return findings, info


# ---------------------------------------------------------------------------
# cross-entry checks
# ---------------------------------------------------------------------------

def wire_comparison(inventories: dict) -> tuple:
    """Strategy-tagged wire bytes + the compressed-beats-dense findings."""
    findings = []
    by_strategy = {}
    for name, info in inventories.items():
        strat = info.get("strategy")
        if strat:
            by_strategy[strat] = info["collectives"]["wire_bytes"]
    sync = by_strategy.get("sync")
    if sync is not None:
        for strat in MUST_BEAT_SYNC:
            b = by_strategy.get(strat)
            if b is not None and not b < sync:
                findings.append(_f(
                    "compressed-not-better", f"strategy/{strat}",
                    f"bytes-on-wire {b:.0f} >= dense sync baseline "
                    f"{sync:.0f} — the communication reduction is gone"))
        if sync <= 0:
            findings.append(_f("empty-baseline", "strategy/sync",
                               "dense sync baseline traces to zero wire "
                               "bytes — inventory is not seeing the "
                               "collectives"))
    return findings, by_strategy


def run(registry=None, *, groups=None, compile_donation: bool = True,
        data_parallel: int = 1, device="cuda") -> Report:
    """Audit every (selected) entry point on ``device``; returns a Report
    whose ``info["audit"]`` carries the full per-entry inventory."""
    from repro_torch.analysis import entrypoints as EP

    if registry is None:
        registry = EP.make_registry(data_parallel, device)
    rep = Report()
    inventories: dict = {}
    for entry in registry:
        if groups and entry.group not in groups:
            continue
        try:
            findings, info = audit_entry(
                entry, compile_donation=compile_donation)
        except Exception as e:  # noqa: BLE001 — an unbuildable entry is a finding
            rep.findings.append(_f(
                "entrypoint-broken", entry.name,
                f"{type(e).__name__} while building or running: {e}"))
            continue
        info["strategy"] = entry.strategy
        info["group"] = entry.group
        inventories[entry.name] = info
        rep.findings += findings
    cross, by_strategy = wire_comparison(inventories)
    rep.findings += cross
    rep.info["audit"] = {
        "entries": inventories,
        "bytes_on_wire_by_strategy": by_strategy,
        "data_parallel": data_parallel,
        "device": str(device),
    }
    return rep
