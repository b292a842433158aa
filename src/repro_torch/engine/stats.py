"""Execution counters for the engine.

One global :data:`stats` instance (mirroring ``repro_torch.compiler.stats``)
that :func:`repro_torch.engine.plan` and :func:`repro_torch.engine.execute`
update in place; tests and benchmarks ``reset_stats()`` around a run.  The
counters are the reference's ``EngineStats``, field for field, so the two
packages' accounting compares directly.  The multigrid counters
(``mg_hierarchies``, ``mg_levels_built``, ``mg_level_log``) and the solve
outcome words (``solve_outcomes``) are live for single-device solves, the
overlap counters (``interior_launches``, ``boundary_launches``,
``overlapped_exchanges``) for split segments, the health counters for
guarded runs and solves, and the serving counters (``requests_*``,
``plan_*``, ``service_*``, ``queue_wait_s``) for
:class:`repro_torch.service.SimulationService`, which
:func:`service_stats` summarizes; the cost model's
(``cost_model_hits``: bodies planned with a calibrated entry;
``calibrations``: :func:`repro_torch.core.perfmodel.calibrate` runs) for
plans and calibrations.

Exchange counting is *static*: the executor derives the counts from the
plan — one halo exchange per fused-kernel launch (zero for halo-free
bodies: a wrap pad, or on a resident plan the in-place margin refresh) and
one launch per interpreter step.  ``repacks`` counts full-field
conversions: one per launch on the repacking path, the layout's
enter/exit events on a resident plan.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class EngineStats:
    """Counters for engine planning + execution (reset with ``reset_stats``).

    >>> from repro_torch.engine import reset_stats, stats
    >>> reset_stats()
    >>> (stats.steps_run, stats.exchanges_per_step, stats.launches)
    (0, 0.0, 0)
    """

    plans_built: int = 0
    bodies_compiled: int = 0  # compile_body calls (every backend dispatch)
    segments_fused: int = 0  # loop bodies routed to a fused kernel
    segments_interp: int = 0  # loop bodies routed to the roll interpreter
    steps_run: int = 0  # logical time steps executed
    launches: int = 0  # kernel / interpreter-step invocations
    exchanges: int = 0  # halo exchanges, wrap pads or margin refreshes
    tiles_fused: int = 0  # k>1 tiled launches (k steps per launch)
    resident_runs: int = 0  # executions stepping on a halo-resident layout
    repacks: int = 0  # full-field pad/copy conversions (per launch, or enter/exit)
    max_time_tile: int = 1  # largest k any segment ran with
    elapsed_s: float = 0.0  # wall time inside execute()
    tile_reasons: Tuple[str, ...] = ()  # why a tile factor was clamped/refused

    interior_launches: int = 0
    boundary_launches: int = 0
    overlapped_exchanges: int = 0
    cost_model_hits: int = 0  # plans served by a calibrated cost-model entry
    calibrations: int = 0  # cost-model calibration runs performed
    mg_hierarchies: int = 0
    mg_levels_built: int = 0
    mg_level_log: Tuple[Tuple[Tuple[int, int, int], bool, bool], ...] = ()
    ensemble_runs: int = 0
    ensemble_members: int = 0
    member_iterations: Tuple[int, ...] = ()
    health_probes: int = 0
    numerical_faults: int = 0
    recovery_attempts: int = 0
    solve_outcomes: Tuple[str, ...] = ()
    requests_admitted: int = 0
    requests_rejected: int = 0
    requests_expired: int = 0
    requests_completed: int = 0
    requests_failed: int = 0
    requests_degraded: int = 0
    request_retries: int = 0
    plan_builds: int = 0
    plan_cache_hits: int = 0
    service_checkpoints: int = 0
    service_restores: int = 0
    service_stragglers: int = 0
    queue_wait_s: float = 0.0

    @property
    def exchanges_per_step(self) -> float:
        """Halo exchanges (wrap pads or margin refreshes) per logical step."""
        return self.exchanges / self.steps_run if self.steps_run else 0.0

    @property
    def steps_per_sec(self) -> float:
        """Logical time steps per wall-clock second across executes."""
        return self.steps_run / self.elapsed_s if self.elapsed_s else 0.0

    def note_tile_reason(self, reason: str) -> None:
        self.tile_reasons = self.tile_reasons + (reason,)


stats = EngineStats()


def reset_stats() -> None:
    # mutate in place so `from repro_torch.engine import stats` stays live
    for f in dataclasses.fields(EngineStats):
        setattr(stats, f.name, f.default)


def service_stats() -> dict:
    """Service-level summary the ``--smoke`` gate and the card smoke read.

    Combines the serving-tier counters above with the kernel-pipeline
    counters of :data:`repro_torch.compiler.stats` (the fallback count is
    the "unexpected interpreter fallbacks" gate on a no-fault run).  The
    reference's dict, key for key.

    >>> from repro_torch.engine import reset_stats
    >>> from repro_torch.engine.stats import service_stats
    >>> reset_stats()
    >>> s = service_stats()
    >>> (s["requests"]["completed"], s["plans"]["cache_hits"], s["faults"]["retries"])
    (0, 0, 0)
    """
    from repro_torch.compiler import stats as kstats

    admitted = stats.requests_admitted
    return {
        "requests": {
            "admitted": admitted,
            "rejected": stats.requests_rejected,
            "expired": stats.requests_expired,
            "completed": stats.requests_completed,
            "failed": stats.requests_failed,
            "degraded": stats.requests_degraded,
            "mean_queue_wait_s": (
                stats.queue_wait_s / admitted if admitted else 0.0
            ),
        },
        "plans": {
            "builds": stats.plan_builds,
            "cache_hits": stats.plan_cache_hits,
        },
        "kernels": {
            "built": kstats.kernels_built,
            "cache_hits": kstats.cache_hits,
            "fallbacks": kstats.fallbacks,
            "launches": stats.launches,
        },
        "faults": {
            "retries": stats.request_retries,
            "checkpoints": stats.service_checkpoints,
            "restores": stats.service_restores,
            "stragglers": stats.service_stragglers,
        },
        "health": {
            "probes": stats.health_probes,
            "numerical_faults": stats.numerical_faults,
            "recovery_attempts": stats.recovery_attempts,
        },
        "steps_run": stats.steps_run,
        "repacks": stats.repacks,
    }
