"""Simulation-as-a-service: async serving over the unified engine.

The port of ``repro/service``; it serves on the card unless the caller asks
for the CPU.  Quickstart::

    from repro_torch.service import (
        PlanSignature, SimulationService, StepRequest,
    )

    svc = SimulationService(workers=2).start()       # device="cuda"
    sig = PlanSignature("heat3d", (32, 32, 8))
    ticket = svc.submit(StepRequest(sig, steps=50))
    field = ticket.result(timeout=60)   # and ticket.stats for observability
    svc.stop()

Run the end-to-end smoke (mixed signatures, fault injection, degraded
mode) with ``python -m repro_torch.service --smoke`` (``--device cpu`` on
a machine without a card).
"""

from repro_torch.engine.health import NumericalFault
from repro_torch.engine.stats import service_stats
from repro_torch.service.requests import (
    DeadlineExceeded,
    PlanSignature,
    RequestFailed,
    RequestStats,
    ServiceOverloaded,
    SolveRequest,
    StepRequest,
    Ticket,
)
from repro_torch.service.scheduler import SignatureScheduler
from repro_torch.service.service import SimulationService
from repro_torch.service.workloads import (
    WORKLOADS,
    CompiledWorkload,
    WorkloadSpec,
    build_workload,
    get_workload,
    register_workload,
)

__all__ = [
    "CompiledWorkload",
    "DeadlineExceeded",
    "NumericalFault",
    "PlanSignature",
    "RequestFailed",
    "RequestStats",
    "ServiceOverloaded",
    "SignatureScheduler",
    "SimulationService",
    "SolveRequest",
    "StepRequest",
    "Ticket",
    "WORKLOADS",
    "WorkloadSpec",
    "build_workload",
    "get_workload",
    "register_workload",
    "service_stats",
]
