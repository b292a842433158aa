"""repro_torch.runtime — fault tolerance and straggler detection.

The port of ``repro/runtime``: :mod:`~repro_torch.runtime.fault`, whose
``ResilientLoop`` and ``HeartbeatMonitor`` drive LM training
(``launch/train.py``), and :mod:`~repro_torch.runtime.elastic`'s
``remesh`` and ``shrink_plan``.
"""
from repro_torch.runtime.elastic import remesh, shrink_plan
from repro_torch.runtime.fault import (FaultInjector, HeartbeatMonitor,
                                       InjectedFault, ResilientLoop)

__all__ = ["FaultInjector", "HeartbeatMonitor", "InjectedFault",
           "ResilientLoop", "remesh", "shrink_plan"]
