"""Analysis passes of the port (counterpart of ``repro.analysis``).

  * `repro_torch.analysis.rings` — exhaustive bounded model checker for the
    delivery-ring and version-ring index arithmetic, with the port's own
    ring ops (`repro_torch.core.delivery`) and `ParamReplica` as the ground
    truth: exactly-once delivery, no slot aliasing at capacity
    tau_max + 1, crash/rejoin mass conservation, serving staleness <=
    tau_serve.
  * `repro_torch.analysis.lint` — AST rules over the port's hot paths.
  * `repro_torch.analysis.entrypoints` and `repro_torch.analysis.audit` —
    every per-step program at smoke scale, run once each: the wire
    inventory, device->host reads, the in-place contract and an
    op-sequence hash.
  * `repro_torch.analysis.findings` — findings, fingerprints and the
    baseline file format shared with the reference; the port's baseline
    is ``baseline.json`` here (``python -m repro_torch.analysis``).
"""
from repro_torch.analysis.findings import Finding, Report  # noqa: F401
