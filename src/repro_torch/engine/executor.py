"""The engine executor: run an :class:`~repro_torch.engine.plan.ExecutionPlan`.

* ``numpy`` — eager segment interpretation on the host (the WFA validation
  mode);
* single device — the plan's steps called from a plain Python loop on
  tensors that live on the plan's device.  Time-tiled segments advance ``k``
  steps per call (``n // k`` tiled launches + ``n % k`` untiled remainder
  launches), which is where the halo amortization lands.

Halo residency (:mod:`repro_torch.engine.layout`): when the plan carries a
padded layout, the run *enters* it once (every field copied to the
resident extent), steps the fused segments on those standing buffers —
margin slabs refreshed in place, K1 writing each written field into its
ping-pong spare — and *exits* once at the end; interpreter segments inside
a mixed plan are bracketed by exit/enter so their roll semantics see plain
tensors.  The spares are allocated at the first enter, one per written
field, so with an all-fused plan at k = 1 the step loop allocates nothing.
The executor also derives the engine's static communication accounting from
the plan (see :mod:`repro_torch.engine.stats`).

A batched plan (``plan.batch = B > 1``) steps ``(B, X, Y, Z)`` member
stacks: :func:`run_program` broadcasts every field the caller left
unstacked, the device steps (and the spares) carry the member axis, and
the ``numpy`` backend runs the members one by one and restacks them.

A plan on a mesh (``plan.mesh``) runs every field as an x-major list of
bricks (:func:`sharded_runner`): each brick is entered, stepped and
exited on its own device, with its own ping-pong spares, and a batched
plan bricks the trailing (X, Y) axes, every brick holding all B members.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.convert import env_from_numpy, env_to_numpy
from repro_torch.core.mesh import BrickArray, NamedSharding
from repro_torch.core.program import _apply_op
from repro_torch.engine.hooks import fire_step_hook
from repro_torch.engine.plan import ExecutionPlan, Segment
from repro_torch.engine.stats import stats


def _apply_segment(seg: Segment, env, *spare):
    """Run one segment: tiled launches + remainder, or the plain loop.
    ``spare`` is the resident steps' ping-pong buffers, where they run."""
    if seg.loop is None:
        return seg.step(env, *spare)
    n, k = seg.loop.n, seg.time_tile
    if k > 1:
        for _ in range(n // k):
            env = seg.step(env, *spare)
        for _ in range(n % k):
            env = seg.step_rem(env, *spare)
        return env
    for _ in range(n):
        env = seg.step(env, *spare)
    return env


def _resident(plan: ExecutionPlan) -> bool:
    """Whether the plan's fused segments step on a halo-resident layout."""
    return (plan.layout is not None and plan.layout.pad > 0
            and any(seg.kind == "fused" for seg in plan.segments))


def _layout_schedule(plan: ExecutionPlan):
    """The plan's step/conversion event stream: ``"enter"``/``"exit"``
    markers interleaved with segments.  Fused segments run on the layout's
    padded buffers; interpreter segments (mixed plans, lowering fallbacks)
    are bracketed by exit/enter so both step kinds see the env form they
    were compiled for.  With an all-fused plan this is exactly one enter
    and one exit per run.  The runner and the repack accounting both
    consume this one stream, so they cannot drift apart.
    """
    padded = False
    for seg in plan.segments:
        if seg.kind == "fused":
            if not padded:
                yield "enter"
                padded = True
        elif padded:
            yield "exit"
            padded = False
        yield seg
    if padded:
        yield "exit"


def _runner(plan: ExecutionPlan, enter, exit_, new_spare):
    """``run(env) -> env`` over the plan's segments: on a resident plan
    ``enter`` / ``exit_`` convert the env at the layout's events and
    ``new_spare(value)`` makes a written field's ping-pong spare at its
    first enter."""
    if not _resident(plan):
        def run(env):
            env = dict(env)
            for seg in plan.segments:
                env = _apply_segment(seg, env)
            return env

        return run

    written = {n for seg in plan.segments for n in seg.written}

    def run(env):
        spare = {}
        for ev in _layout_schedule(plan):
            if ev == "enter":
                env = enter(env)
                for n in written:
                    if n not in spare:
                        spare[n] = new_spare(env[n])
            elif ev == "exit":
                env = exit_(env)
            elif ev.kind == "fused":
                env = _apply_segment(ev, env, spare)
            else:
                env = _apply_segment(ev, env)
        return env

    return run


def single_runner(plan: ExecutionPlan):
    """``run(env) -> env`` over tensors on ``plan.device`` (no host copies,
    no synchronisation — the caller times or reads back the result).  The
    caller's tensors are never written; on a resident plan the result is
    fresh tensors from the layout's exit."""
    return _runner(plan, lambda env: plan.layout.enter(env),
                   lambda env: plan.layout.exit(env), torch.empty_like)


def _per_brick(fn, env):
    """``fn`` over each brick's env (name -> tensor), regrouped into name ->
    x-major list of bricks."""
    size = len(next(iter(env.values())))
    outs = [fn({n: v[b] for n, v in env.items()}) for b in range(size)]
    return {n: [o[n] for o in outs] for n in outs[0]}


def sharded_runner(plan: ExecutionPlan):
    """``run(env) -> env`` over name -> x-major list of brick tensors on
    the bricks of ``plan.mesh`` (no host copies, no synchronisation).  On a
    resident plan every brick is entered and exited on its own, and each
    written field holds one ping-pong spare per brick, allocated at the
    first enter, so a resident step allocates nothing.  The caller's
    tensors are never written."""
    return _runner(plan, lambda env: _per_brick(plan.layout.enter, env),
                   lambda env: _per_brick(plan.layout.exit, env),
                   lambda bricks: [torch.empty_like(t) for t in bricks])


def _run_single(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    out = single_runner(plan)(env_from_numpy(env, plan.device))
    return env_to_numpy(out)


def _run_sharded(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    """Cut every global field (a ``(B, …)`` stack on a batched plan) into
    the mesh's bricks, run them, and gather the result to host NumPy."""
    sharding = NamedSharding(plan.mesh)
    bricks = {k: list(sharding.shard(v).bricks) for k, v in env.items()}
    out = sharded_runner(plan)(bricks)
    return {k: BrickArray(v, sharding).gather("cpu").numpy()
            for k, v in out.items()}


def _account(plan: ExecutionPlan) -> None:
    """Static accounting for one execution of ``plan``.

    Fused segments pay one halo exchange per kernel launch (none when the
    body is halo-free): on a resident plan the in-place margin refresh, and
    the only repacking conversions are the layout's enter/exit events — two
    for an all-fused plan, plus a pair around each interpreter segment of a
    mixed plan; otherwise one full wrap pad (a repack) per launch.
    A split segment (``seg.split`` shells) counts each launch event's
    interior and boundary launches and one overlapped exchange.
    Interpreter segments roll in place on one device and pad per op, per
    step, on a mesh.  A launch is one event of the plan, however many
    bricks it covers.
    """
    resident = _resident(plan)
    if resident:
        stats.resident_runs += 1
        stats.repacks += sum(
            1 for ev in _layout_schedule(plan) if isinstance(ev, str))
    if plan.batch > 1:
        stats.ensemble_runs += 1
        stats.ensemble_members += plan.batch
    for seg in plan.segments:
        n, k = seg.n_steps, seg.time_tile
        stats.steps_run += n
        if seg.kind == "fused":
            tiled = n // k if k > 1 else 0
            launches = tiled + (n % k if k > 1 else n)
            stats.launches += launches
            stats.tiles_fused += tiled
            if seg.split:
                # overlap split: every launch event is one interior launch
                # plus `split` boundary shells, its exchange slabs in
                # flight while the interior computes
                stats.interior_launches += launches
                stats.boundary_launches += launches * seg.split
                if seg.halo > 0:
                    stats.overlapped_exchanges += launches
            if seg.halo > 0:
                stats.exchanges += launches
                if not resident:
                    stats.repacks += launches
        else:
            stats.launches += n
            if plan.mesh is not None:
                stats.exchanges += n * len(seg.ops)
                stats.repacks += n * len(seg.ops)


def _run_numpy(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    """Eager host run; a batched plan runs its members one by one (the
    eager validation backend has nothing to batch through) and restacks."""
    if plan.batch > 1:
        outs = [_run_numpy_one(plan, {k: v[b] for k, v in env.items()})
                for b in range(plan.batch)]
        return {k: np.stack([o[k] for o in outs]) for k in env}
    return _run_numpy_one(plan, env)


def _run_numpy_one(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    env = {k: np.asarray(v).copy() for k, v in env.items()}
    roll = lambda a, s, ax: np.roll(a, s, axis=ax)  # noqa: E731
    for seg in plan.segments:
        for _ in range(seg.n_steps):
            for op in seg.ops:
                env[op.field_name] = _apply_op(op, env, np, roll)
    return env


def execute(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    """Run the plan from ``env`` (name -> (X, Y, Z) array, or a (B, X, Y, Z)
    member stack on a batched plan); returns the final env as host NumPy
    arrays.  Updates :data:`repro_torch.engine.stats`.

    Fires the engine's step hook before any state advances.
    """
    if plan.batch > 1:
        for k, v in env.items():
            if np.ndim(v) != 4 or np.shape(v)[0] != plan.batch:
                raise ValueError(f"field {k!r} is {np.shape(v)}; a batched "
                                 f"plan steps ({plan.batch}, X, Y, Z) stacks")
    fire_step_hook(stats.steps_run, tag="execute")
    t0 = time.perf_counter()
    if plan.backend == "numpy":
        out = _run_numpy(plan, env)
    elif plan.mesh is None:
        out = _run_single(plan, env)
    else:
        out = _run_sharded(plan, env)
    stats.elapsed_s += time.perf_counter() - t0
    _account(plan)
    return out


def run_program(program, env: Dict[str, np.ndarray] = None, options=None):
    """plan + execute in one call (the ``WFAInterface.make`` entry point).

    Policy travels as ``options=RunOptions(...)`` (a bare string is the
    backend); ``env`` defaults to the fields' recorded initial data.  On a
    batched plan every field the caller left unstacked is broadcast to all
    members (:class:`~repro_torch.core.ensemble.Ensemble` overrides arrive
    stacked).
    """
    from repro_torch.engine.options import resolve_options
    from repro_torch.engine.plan import plan as _plan

    p = _plan(program, resolve_options(options, "run_program"))
    if env is None:
        env = {n: f.init_data for n, f in program.fields.items()}
    if p.batch > 1:
        env = {k: (np.broadcast_to(v, (p.batch,) + np.shape(v)).copy()
                   if np.ndim(v) == 3 else v)
               for k, v in env.items()}
    return execute(p, env)
