"""Named spans for the profiler.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records (``torch.profiler.profile``, or the autograd profiler),
and one shared null context otherwise, so that a program run without a
profiler enters no record-function op.

The training steps name their phases ``step.forward``, ``step.backward``,
``step.compress``, ``step.deliver``, ``step.gap`` and ``step.update``
(never overlapping one another), and each place where the step's host
thread waits for the device ``wait.<site>``; the models keep their own
ranges (``moe_dispatch``, ``wkv6_chunked``, ``shared_attention``,
``attend_full``).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range while a profiler
    records; the shared null context when none does."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
