"""repro_torch.runtime — fault tolerance and straggler detection.

The port of ``repro/runtime``: :mod:`~repro_torch.runtime.fault`, whose
``ResilientLoop`` and ``HeartbeatMonitor`` drive LM training
(``launch/train.py``).  ``runtime/elastic.py`` (remeshing) comes with the
port's mesh parallelism.
"""
from repro_torch.runtime.fault import (FaultInjector, HeartbeatMonitor,
                                       InjectedFault, ResilientLoop)

__all__ = ["FaultInjector", "HeartbeatMonitor", "InjectedFault",
           "ResilientLoop"]
