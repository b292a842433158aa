"""repro_torch.runtime — fault tolerance and straggler detection.

The port of ``repro/runtime``: :mod:`~repro_torch.runtime.fault` only
(``runtime/elastic.py`` belongs to the LM scaffold, not ported yet).
"""
from repro_torch.runtime.fault import (FaultInjector, HeartbeatMonitor,
                                       InjectedFault, ResilientLoop)

__all__ = ["FaultInjector", "HeartbeatMonitor", "InjectedFault",
           "ResilientLoop"]
