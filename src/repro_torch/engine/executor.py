"""The engine executor: run an :class:`~repro_torch.engine.plan.ExecutionPlan`.

* ``numpy`` — eager segment interpretation on the host (the WFA validation
  mode);
* single device — the plan's steps called from a plain Python loop on
  tensors that live on the plan's device.  Time-tiled segments advance ``k``
  steps per call (``n // k`` tiled launches + ``n % k`` untiled remainder
  launches), which is where the wrap-pad amortization lands.

The executor also derives the engine's static communication accounting from
the plan (see :mod:`repro_torch.engine.stats`).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from repro_torch.convert import env_from_numpy, env_to_numpy
from repro_torch.core.program import _apply_op
from repro_torch.engine.hooks import fire_step_hook
from repro_torch.engine.plan import ExecutionPlan, Segment
from repro_torch.engine.stats import stats


def _apply_segment(seg: Segment, env):
    """Run one segment: tiled launches + remainder, or the plain loop."""
    if seg.loop is None:
        return seg.step(env)
    n, k = seg.loop.n, seg.time_tile
    if k > 1:
        for _ in range(n // k):
            env = seg.step(env)
        for _ in range(n % k):
            env = seg.step_rem(env)
        return env
    for _ in range(n):
        env = seg.step(env)
    return env


def single_runner(plan: ExecutionPlan):
    """``run(env) -> env`` over tensors on ``plan.device`` (no host copies,
    no synchronisation — the caller times or reads back the result)."""

    def run(env):
        env = dict(env)
        for seg in plan.segments:
            env = _apply_segment(seg, env)
        return env

    return run


def _run_single(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    out = single_runner(plan)(env_from_numpy(env, plan.device))
    return env_to_numpy(out)


def _account(plan: ExecutionPlan) -> None:
    """Static accounting for one execution of ``plan``: fused segments pay
    one wrap pad (and one full-field repack) per kernel launch, none when
    the body is halo-free; interpreter segments roll in place."""
    for seg in plan.segments:
        n, k = seg.n_steps, seg.time_tile
        stats.steps_run += n
        if seg.kind == "fused":
            tiled = n // k if k > 1 else 0
            launches = tiled + (n % k if k > 1 else n)
            stats.launches += launches
            stats.tiles_fused += tiled
            if seg.halo > 0:
                stats.exchanges += launches
                stats.repacks += launches
        else:
            stats.launches += n


def _run_numpy(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    """Eager host run (one member; the batched form comes with ensembles)."""
    env = {k: np.asarray(v).copy() for k, v in env.items()}
    roll = lambda a, s, ax: np.roll(a, s, axis=ax)  # noqa: E731
    for seg in plan.segments:
        for _ in range(seg.n_steps):
            for op in seg.ops:
                env[op.field_name] = _apply_op(op, env, np, roll)
    return env


def execute(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    """Run the plan from ``env`` (name -> (X, Y, Z) array); returns the final
    env as host NumPy arrays.  Updates :data:`repro_torch.engine.stats`.

    Fires the engine's step hook before any state advances.
    """
    fire_step_hook(stats.steps_run, tag="execute")
    t0 = time.perf_counter()
    if plan.backend == "numpy":
        out = _run_numpy(plan, env)
    else:
        out = _run_single(plan, env)
    stats.elapsed_s += time.perf_counter() - t0
    _account(plan)
    return out


def run_program(program, env: Dict[str, np.ndarray] = None, options=None):
    """plan + execute in one call (the ``WFAInterface.make`` entry point).

    Policy travels as ``options=RunOptions(...)`` (a bare string is the
    backend); ``env`` defaults to the fields' recorded initial data.
    """
    from repro_torch.engine.options import resolve_options
    from repro_torch.engine.plan import plan as _plan

    p = _plan(program, resolve_options(options, "run_program"))
    if env is None:
        env = {n: f.init_data for n, f in program.fields.items()}
    return execute(p, env)
