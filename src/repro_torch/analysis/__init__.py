"""Analysis passes of the port (counterpart of ``repro.analysis``).

  * `repro_torch.analysis.rings` — exhaustive bounded model checker for the
    delivery-ring and version-ring index arithmetic, with the port's own
    ring ops (`repro_torch.core.delivery`) and `ParamReplica` as the ground
    truth: exactly-once delivery, no slot aliasing at capacity
    tau_max + 1, crash/rejoin mass conservation, serving staleness <=
    tau_serve.
  * `repro_torch.analysis.findings` — findings, fingerprints and the
    baseline file format shared with the reference.
"""
from repro_torch.analysis.findings import Finding, Report  # noqa: F401
