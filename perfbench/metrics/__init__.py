"""One reader a per-layer metric, ``<metric>.py``: ``LAYER``, ``UNIT``,
``MOVES`` and ``read(ctx)`` of a `perfbench.harness.TraceContext`, which
returns the metric's number, or ``None`` where the span has nothing for
it."""
