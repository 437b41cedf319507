"""Structured fault injection (counterpart of ``repro.resilience``).

``faults`` is the chaos harness: a seeded ``FaultPlan`` drives injectors
through the Trainer's ``fault_hook`` / ``batch_hook``, the DCL engine's
``step_hook`` / ``admit_hook`` and ``ops.dispatch_hook_scope``.  The
recovery lives where the state lives (the Trainer, ``checkpoint``, the
engine's ladder); this package only breaks things, on schedule.
"""
from .faults import (FAULT_KINDS, ChaosHooks, DataPipelineHiccup,
                     DeviceLost, FaultEvent, FaultInjected, FaultPlan,
                     KernelDispatchFault, corrupt_checkpoint,
                     dump_telemetry)

__all__ = [
    "FAULT_KINDS", "ChaosHooks", "DataPipelineHiccup", "DeviceLost",
    "FaultEvent", "FaultInjected", "FaultPlan", "KernelDispatchFault",
    "corrupt_checkpoint", "dump_telemetry",
]
