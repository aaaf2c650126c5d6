"""Deterministic fault injection for training and serving (counterpart of
``repro.faults``).

`repro_torch.faults.plan` is the seeded, replayable `FaultPlan` DSL
(worker crash/rejoin, NaN/Inf gradient poisoning, delayed/dropped ring
deposits, checkpoint-IO errors, SIGKILLs, serve-side logit poisoning and
page-pool exhaustion); `repro_torch.faults.inject` holds the host-side
injectors that drive a plan through `launch.train` and `launch.serve`.  The
supervisor that restarts killed runs lives in
`repro_torch.launch.supervisor`.
"""
from repro_torch.faults.plan import (FAULT_KINDS, SERVE_KINDS, TAU_KINDS,
                                     FaultEvent, FaultPlan)
from repro_torch.faults.inject import ServeFaultInjector, TrainFaultInjector

__all__ = [
    "FAULT_KINDS", "SERVE_KINDS", "TAU_KINDS", "FaultEvent", "FaultPlan",
    "ServeFaultInjector", "TrainFaultInjector",
]
