"""repro_torch.engine — the execution engine (planner + executor).

Every way of running a recorded WFA program dispatches through here:

* :func:`plan` schedules the program's op groups into
  :class:`~repro_torch.engine.plan.Segment`s (fused kernel vs interpreter,
  with a time-tile factor per loop body);
* :func:`execute` runs a plan eagerly (``numpy``), on the plan's torch
  device, or on the bricks of its mesh (:func:`sharded_runner`);
* :func:`compile_body` builds a single body application ``env -> env`` —
  the one backend if/else in the tree;
* :func:`plan_mg_levels` schedules a multigrid hierarchy (level bodies
  through :func:`compile_body`, transfers through the kernel cache);
* :class:`HaloLayout` is the halo-resident layout a ``pallas`` plan steps
  on (:mod:`repro_torch.engine.layout`, with ``wrap_refresh``);
* :data:`stats` exposes the accounting (steps, launches, halo exchanges,
  repacks, tiles fused, health probes and faults, the service's requests),
  :func:`service_stats` its serving summary;
* :mod:`~repro_torch.engine.health` holds the ``check_finite`` sentinels'
  probe; :func:`differentiable_runner` and :func:`checkpointed_vjp` run a
  ``RunOptions(differentiable=True)`` plan under ``torch.autograd``.
"""

from repro_torch.engine import health
from repro_torch.engine.executor import (checkpointed_vjp,
                                         differentiable_runner, execute,
                                         fresh_buffer, guarded_runner,
                                         run_program,
                                         sharded_runner, single_runner)
from repro_torch.engine.health import NumericalFault, RecoveryPolicy
from repro_torch.engine.layout import HaloLayout
from repro_torch.engine.options import UNSET, RunOptions, resolve_options
from repro_torch.engine.plan import (
    BACKENDS,
    ExecutionPlan,
    LevelSegment,
    Segment,
    compile_body,
    plan,
    plan_mg_levels,
    resolve_device,
)
from repro_torch.engine.stats import (EngineStats, reset_stats,
                                      service_stats, stats)

__all__ = [
    "BACKENDS",
    "EngineStats",
    "ExecutionPlan",
    "HaloLayout",
    "LevelSegment",
    "NumericalFault",
    "RecoveryPolicy",
    "RunOptions",
    "Segment",
    "UNSET",
    "checkpointed_vjp",
    "compile_body",
    "differentiable_runner",
    "execute",
    "fresh_buffer",
    "guarded_runner",
    "health",
    "plan",
    "plan_mg_levels",
    "reset_stats",
    "resolve_device",
    "resolve_options",
    "run_program",
    "service_stats",
    "sharded_runner",
    "single_runner",
    "stats",
]
