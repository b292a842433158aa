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

``RunOptions(check_finite=N)`` runs the plan guarded (:func:`guarded_runner`):
the launches are regrouped into chunks of ``ceil(N / k)``, each followed by
one ``isfinite`` probe of the state (:mod:`repro_torch.engine.health`),
whose verdict the host reads one chunk later; a failed probe raises
:class:`~repro_torch.engine.health.NumericalFault` with the step and the
last state that passed a probe.  :func:`run_program` retries a faulted
time-tiled or split plan once at ``time_tile=1, overlap=False`` when
``RunOptions(recovery=…)`` allows it.

Reverse-mode AD (:func:`differentiable_runner`, :func:`checkpointed_vjp`):
a plan built with ``RunOptions(differentiable=True)`` runs every fused
launch as a ``torch.autograd.Function`` whose forward is the K1 launch and
whose backward is the VJP of the roll interpreter's application of the
same body at the saved input, and the time loop as a checkpointed ladder
(``torch.utils.checkpoint``) whose saved states grow with the square root
of the launch count.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.convert import env_to_numpy
from repro_torch.core.mesh import BrickArray, NamedSharding
from repro_torch.core.program import _apply_op
from repro_torch.engine.hooks import fire_step_hook
from repro_torch.engine.plan import ExecutionPlan, Segment
from repro_torch.engine.stats import stats

log = logging.getLogger("repro_torch.engine")


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


def fresh_buffer(v, device=None) -> torch.Tensor:
    """A tensor copy of ``v`` (an array or a tensor) on ``device`` (default:
    ``v``'s own) that never aliases the caller's buffer, so a run may reuse
    or overwrite it (the reference's buffer safe to donate)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(v.device if device is None else device,
                             copy=True)
    return torch.tensor(np.asarray(v), device=device)


def _run_single(plan: ExecutionPlan, env: Dict[str, np.ndarray]):
    out = single_runner(plan)({k: fresh_buffer(v, plan.device)
                               for k, v in env.items()})
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


def _run_numpy(plan: ExecutionPlan, env: Dict[str, np.ndarray], check: int = 0):
    """Eager host run; a batched plan runs its members one by one (the
    eager validation backend has nothing to batch through) and restacks.
    ``check > 0`` probes the state every ``check`` steps, as the guarded
    device runs do."""
    if plan.batch > 1:
        outs = [_run_numpy_one(plan, {k: v[b] for k, v in env.items()}, check)
                for b in range(plan.batch)]
        return {k: np.stack([o[k] for o in outs]) for k in env}
    return _run_numpy_one(plan, env, check)


def _run_numpy_one(plan: ExecutionPlan, env: Dict[str, np.ndarray], check=0):
    from repro_torch.engine import health as ehealth

    env = {k: np.asarray(v).copy() for k, v in env.items()}
    roll = lambda a, s, ax: np.roll(a, s, axis=ax)  # noqa: E731
    step_idx, since, last_good, good_step = 0, 0, None, 0
    if check > 0:
        if not ehealth.probe(env):
            _sentinel_fault(env, 0, None, 0)
        last_good = {k: v.copy() for k, v in env.items()}
    for seg in plan.segments:
        for _ in range(seg.n_steps):
            for op in seg.ops:
                env[op.field_name] = _apply_op(op, env, np, roll)
            step_idx += 1
            since += 1
            if check > 0 and since >= check:
                since = 0
                if not ehealth.probe(env):
                    _sentinel_fault(env, step_idx, last_good, good_step)
                last_good = {k: v.copy() for k, v in env.items()}
                good_step = step_idx
    if check > 0 and since:
        if not ehealth.probe(env):
            _sentinel_fault(env, step_idx, last_good, good_step)
    return env


# ---------------------------------------------------------------------------
# explicit-path sentinels: chunked guarded execution (RunOptions.check_finite)
# ---------------------------------------------------------------------------


def _sentinel_fault(env, step_idx, last_good, good_step, host=None,
                    bad=None):
    """Raise the NumericalFault for a tripped explicit-path probe.

    ``bad`` names the poisoned fields (default: read off ``env``);
    ``last_good`` is the last probed-good env (host arrays), a function
    that rebuilds it, or None; ``host`` takes a rebuilt env to host NumPy
    arrays."""
    from repro_torch.engine import health as ehealth

    stats.numerical_faults += 1
    if bad is None:
        bad = ehealth.poisoned_fields(env)
    if callable(last_good):
        last_good = last_good()
    if last_good is not None and host is not None:
        last_good = host(last_good)
    raise ehealth.NumericalFault(
        f"non-finite field state at step {step_idx} "
        f"(fields: {', '.join(bad) or 'unknown'}; "
        f"last finite probe at step {good_step})",
        outcome="NAN_RESIDUAL",
        step=step_idx,
        last_good=last_good,
    )


class _Verdicts:
    """The probes' per-field verdicts, read late.

    :meth:`post` reduces the state (:func:`repro_torch.engine.health.
    field_verdicts`) and, on the card, starts a non-blocking copy of the
    verdicts into a pinned host buffer (held from the first call, one per
    outstanding verdict); :meth:`read` waits for that copy only.  The
    guarded run posts chunk c's verdicts and then reads chunk c − 1's, so
    the card has chunk c queued while the host waits and never idles for
    a probe.  On the host the verdicts are read at once.  Each read counts
    one ``stats.health_probes``."""

    def __init__(self):
        self._free = []

    def post(self, env):
        from repro_torch.engine import health as ehealth

        v = ehealth.field_verdicts(env)
        if v.device.type != "cuda":
            return v, None
        buf, ev = (self._free.pop() if self._free and
                   self._free[-1][0].shape == v.shape else
                   (torch.empty(v.shape, dtype=v.dtype, pin_memory=True),
                    torch.cuda.Event()))
        buf.copy_(v, non_blocking=True)
        ev.record()
        return buf, ev

    def read(self, handle) -> list:
        buf, ev = handle
        stats.health_probes += 1
        if ev is None:
            return buf.tolist()
        ev.synchronize()
        oks = buf.tolist()
        self._free.append(handle)
        return oks


def guarded_runner(plan: ExecutionPlan, every: int):
    """``run(env) -> env`` probing field finiteness every ~``every`` steps,
    over the env forms of :func:`single_runner` (tensors on the plan's
    device) and :func:`sharded_runner` (name → x-major list of bricks).

    The entry state is probed, then the plan's launches are regrouped into
    chunks of ``ceil(every / k)`` launches (per segment: the full chunks,
    then the tail, as the reference chunks them), each followed by one
    probe of the state — every field, every brick (the AND over bricks
    stands for the reference's ``pmin``), on a resident plan the whole
    resident buffers, as the reference probes its padded env: their
    margins hold zeros from the enter (the spares start zeroed here) or
    copies of interior cells from a refresh, never garbage.  Each verdict is read one chunk late (:class:`_Verdicts`),
    the last one after the run's exit is enqueued, so the card never waits
    for the host; the happy path launches exactly what the unguarded run
    does, in the same order, plus the probes' reductions, and gives the
    same bits.  It keeps no snapshot: the run logs its enter/exit events
    and chunks, and the first failed probe replays the log up to the last
    probed-good chunk from the caller's env (which no step writes: a
    resident run enters copies; fresh spares for the replay) and
    raises :class:`repro_torch.engine.health.NumericalFault` with the step
    index (the end of the failed chunk) and that state as host NumPy
    arrays, bitwise the unguarded run stopped there.
    """
    mesh, layout = plan.mesh, plan.layout
    if mesh is None:
        enter, exit_, new_spare = layout.enter, layout.exit, torch.zeros_like
        host = env_to_numpy
    else:
        sharding = NamedSharding(mesh)
        enter = lambda e: _per_brick(layout.enter, e)  # noqa: E731
        exit_ = lambda e: _per_brick(layout.exit, e)  # noqa: E731
        new_spare = lambda bricks: [torch.zeros_like(t) for t in bricks]  # noqa: E731

        def host(e):
            return {k: BrickArray(v, sharding).gather("cpu").numpy()
                    for k, v in e.items()}

    events = (list(_layout_schedule(plan)) if _resident(plan)
              else list(plan.segments))
    written = {n for seg in plan.segments for n in seg.written}
    verdicts = _Verdicts()

    def chunks(seg):
        """``(step_fn, launches, steps)`` of each probed chunk of ``seg``."""
        if seg.loop is None:
            return [(seg.step, 1, 1)]
        n, k = seg.loop.n, seg.time_tile
        parts = ([(seg.step, n // k, k), (seg.step_rem, n % k, 1)] if k > 1
                 else [(seg.step, n, 1)])
        out = []
        for fn, launches, per_launch in parts:
            if launches <= 0:
                continue
            per = min(max(1, -(-every // per_launch)), launches)
            full, tail = divmod(launches, per)
            out += [(fn, per, per * per_launch)] * full
            if tail:
                out.append((fn, tail, tail * per_launch))
        return out

    def replay(env0, log):
        """The state after ``log``'s events from ``env0``, out of the
        resident layout."""
        e, padded, sp = dict(env0), False, {}
        for kind, fn, n in log:
            if kind == "enter":
                e, padded = enter(e), True
                sp = {w: new_spare(e[w]) for w in written}
            elif kind == "exit":
                e, padded = exit_(e), False
            else:
                for _ in range(n):
                    e = fn(e, sp) if padded else fn(e)
        return exit_(e) if padded else e

    def run(env0):
        env, spare, padded = dict(env0), {}, False
        step, log, pending = 0, [], []

        def settle(keep):
            """Read the posted verdicts, oldest first, until ``keep``
            remain; raise at the first failed one."""
            while len(pending) > keep:
                handle, names, at, good, good_log = pending.pop(0)
                oks = verdicts.read(handle)
                if not all(oks):
                    _sentinel_fault(
                        None, at,
                        None if good_log is None
                        else (lambda: replay(env0, good_log)),
                        good, host=host,
                        bad=[n for n, ok in zip(names, oks) if not ok])

        # probe the entry state too: a poisoned initial condition faults
        # at step 0 with last_good=None rather than masquerading as "last
        # good"
        pending.append((verdicts.post(env), list(env), 0, 0, None))
        for ev in events:
            if ev == "enter":
                env, padded = enter(env), True
                for n in written:
                    if n not in spare:
                        spare[n] = new_spare(env[n])
                log.append(("enter", None, 0))
                continue
            if ev == "exit":
                env, padded = exit_(env), False
                log.append(("exit", None, 0))
                continue
            for fn, launches, steps in chunks(ev):
                for _ in range(launches):
                    env = fn(env, spare) if padded else fn(env)
                good_log = list(log)
                log.append(("steps", fn, launches))
                pending.append((verdicts.post(env), list(env),
                                step + steps, step, good_log))
                step += steps
                settle(keep=1)
        if padded:
            env = exit_(env)
        settle(keep=0)
        return env

    return run


def _run_guarded(plan: ExecutionPlan, env: Dict[str, np.ndarray], every: int):
    """:func:`guarded_runner` from host arrays to host arrays (the mesh's
    bricks cut from, and gathered back to, the global fields)."""
    run = guarded_runner(plan, every)
    if plan.mesh is None:
        return env_to_numpy(run({k: fresh_buffer(v, plan.device)
                                 for k, v in env.items()}))
    sharding = NamedSharding(plan.mesh)
    out = run({k: list(sharding.shard(v).bricks) for k, v in env.items()})
    return {k: BrickArray(v, sharding).gather("cpu").numpy()
            for k, v in out.items()}


def execute(plan: ExecutionPlan, env: Dict[str, np.ndarray], options=None):
    """Run the plan from ``env`` (name -> (X, Y, Z) array, or a (B, X, Y, Z)
    member stack on a batched plan); returns the final env as host NumPy
    arrays.  Updates :data:`repro_torch.engine.stats`.

    Fires the engine's step hook before any state advances.
    ``options=RunOptions(check_finite=N)`` routes through the guarded
    chunked run (:func:`guarded_runner`): an ``isfinite`` sentinel every ~N
    steps, raising :class:`repro_torch.engine.health.NumericalFault`
    instead of returning poisoned state.  ``check_finite=0`` (default) is
    the sentinel-free path.
    """
    check = int(getattr(options, "check_finite", 0) or 0)
    if plan.batch > 1:
        for k, v in env.items():
            if np.ndim(v) != 4 or np.shape(v)[0] != plan.batch:
                raise ValueError(f"field {k!r} is {np.shape(v)}; a batched "
                                 f"plan steps ({plan.batch}, X, Y, Z) stacks")
    fire_step_hook(stats.steps_run, tag="execute")
    t0 = time.perf_counter()
    if plan.backend == "numpy":
        out = _run_numpy(plan, env, check)
    elif check > 0:
        out = _run_guarded(plan, env, check)
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

    With ``options.recovery.detile_explicit`` (and sentinels armed by
    ``check_finite``), a :class:`~repro_torch.engine.health.NumericalFault`
    from a time-tiled or split plan triggers one de-escalated retry —
    ``time_tile=1``, ``overlap=False`` — before the fault propagates: the
    conservative schedule changes rounding, the cheapest recovery for a
    marginal explicit run.
    """
    from repro_torch.engine import health as ehealth
    from repro_torch.engine.options import resolve_options
    from repro_torch.engine.plan import plan as _plan

    options = resolve_options(options, "run_program")
    p = _plan(program, options)
    if env is None:
        env = {n: f.init_data for n, f in program.fields.items()}
    if p.batch > 1:
        env = {k: (np.broadcast_to(v, (p.batch,) + np.shape(v)).copy()
                   if np.ndim(v) == 3 else v)
               for k, v in env.items()}
    try:
        return execute(p, env, options)
    except ehealth.NumericalFault as fault:
        rec = options.recovery
        aggressive = any(seg.time_tile > 1 or seg.split for seg in p.segments)
        if rec is None or not rec.detile_explicit or not aggressive:
            raise
        log.warning(
            "explicit sentinel tripped at step %s; retrying with the "
            "conservative schedule (time_tile=1, overlap off)", fault.step)
        stats.recovery_attempts += 1
        opts2 = options.replace(time_tile=1, overlap=False)
        return execute(_plan(program, opts2), env, opts2)


# ---------------------------------------------------------------------------
# reverse-mode AD: checkpointed differentiable stepping
# ---------------------------------------------------------------------------


def _flatten(env, spec):
    """The tensors of ``env`` in ``spec``'s order: a field's tensor, or its
    bricks in x-major order."""
    flat = []
    for name, nbricks in spec:
        v = env[name]
        if nbricks is None:
            flat.append(v)
        else:
            flat.extend(v)
    return flat


def _unflatten(spec, flat):
    env, i = {}, 0
    for name, nbricks in spec:
        if nbricks is None:
            env[name] = flat[i]
            i += 1
        else:
            env[name] = list(flat[i:i + nbricks])
            i += nbricks
    return env


def _env_spec(env):
    """``((name, None | number of bricks), …)`` of an env."""
    return tuple((n, len(v) if isinstance(v, (list, tuple)) else None)
                 for n, v in env.items())


class _DiffLaunch(torch.autograd.Function):
    """One compiled launch whose reverse pass is the roll interpreter's.

    The forward runs ``step`` (the fused kernel K1 on the card, its plain
    version on the host) on the env's tensors; the backward differentiates
    ``ref_step`` — the roll interpreter's application of the same body —
    at the saved input.  For the (bi)linear bodies the compiler fuses both
    compute the same function (the backend-agreement tests hold them to
    rounding), so the VJP is exact while the forward stays on the kernel.
    """

    @staticmethod
    def forward(ctx, step, ref_step, spec, *flat):
        ctx.ref_step, ctx.spec = ref_step, spec
        ctx.save_for_backward(*flat)
        return tuple(_flatten(step(_unflatten(spec, flat)), spec))

    @staticmethod
    def backward(ctx, *cts):
        flat = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(flat, need)]
            outs = _flatten(ctx.ref_step(_unflatten(ctx.spec, ins)), ctx.spec)
            pairs = [(o, ct) for o, ct in zip(outs, cts) if o.requires_grad]
            wrt = [t for t in ins if t.requires_grad]
            if not pairs or not wrt:
                return (None,) * (3 + len(ins))
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [ct for _, ct in pairs],
                allow_unused=True))
        return (None, None, None,
                *[next(grads) if t.requires_grad else None for t in ins])


def _diff_launch(step, ref_step):
    """``launch(env) -> env`` running ``step`` forward and differentiating
    ``ref_step`` backward (:class:`_DiffLaunch`)."""

    def launch(env):
        spec = _env_spec(env)
        return _unflatten(spec, _DiffLaunch.apply(step, ref_step, spec,
                                                  *_flatten(env, spec)))

    return launch


def _checkpoint(fn, env):
    """``fn(env)`` rematerialized in the reverse pass: only ``env`` is
    saved (``torch.utils.checkpoint``, non-reentrant)."""
    from torch.utils.checkpoint import checkpoint

    spec = _env_spec(env)

    def flat_fn(*flat):
        return tuple(_flatten(fn(_unflatten(spec, flat)), spec))

    return _unflatten(spec, checkpoint(flat_fn, *_flatten(env, spec),
                                       use_reentrant=False,
                                       preserve_rng_state=False))


def _chunked(launch, env, n: int, chunk: int, checkpoint: bool):
    """Run ``n`` launches, rematerializing in chunks of ``chunk``.

    Checkpointing each chunk caps the reverse pass's saved states at
    O(n/chunk + chunk) envs instead of O(n) — the classic two-level
    ladder.  ``checkpoint=False`` keeps every launch's saved input, the
    all-residuals reference the checkpointed gradient is held against."""
    if n <= 0:
        return env

    def chunk_fn(e, size):
        for _ in range(size):
            e = launch(e)
        return e

    if not checkpoint or n <= chunk:
        return chunk_fn(env, n)
    full, tail = divmod(n, chunk)
    for _ in range(full):
        env = _checkpoint(lambda e: chunk_fn(e, chunk), env)
    return chunk_fn(env, tail)


def differentiable_runner(plan: ExecutionPlan, *, checkpoint: bool = True,
                          chunk_steps: int = None):
    """Reverse-differentiable ``run(env) -> env`` for a differentiable plan.

    Requires a plan built with ``RunOptions(differentiable=True)``
    (repacking steps, no resident layout).  Fused segments keep their
    compiled kernels on the forward sweep — each launch is a
    ``torch.autograd.Function`` whose backward differentiates the
    equivalent roll-interpreter application (:class:`_DiffLaunch`) — and
    the time loop is a checkpointed ladder: chunks of ``chunk_steps``
    steps (snapped to the segment's tile factor ``k``; default
    ``k·ceil(sqrt(launches))``) are rematerialized by
    ``torch.utils.checkpoint``, so the reverse pass's memory grows with the
    square root of the step count rather than linearly.  Interpreter
    segments differentiate natively.

    ``checkpoint=False`` keeps every launch's saved input — the reference
    the checkpointed gradients are held against.  ``env`` maps names to
    global tensors on the plan's device (which may require grad); on a
    mesh plan the runner cuts them into the mesh's bricks, runs the same
    ladder over bricks (``halo_pad``'s out-of-place copies carry the
    gradient between bricks) and gathers the result, all differentiably.
    Compose with ``torch.autograd`` at the call site; for step counts
    whose saved states exceed device memory even checkpointed, see
    :func:`checkpointed_vjp`.
    """
    if not plan.differentiable:
        raise ValueError(
            "differentiable_runner needs a plan built with "
            "RunOptions(differentiable=True)")
    if plan.backend == "numpy":
        raise ValueError("the eager numpy backend is not differentiable")
    from repro_torch.engine.plan import compile_body

    shapes = {n: f.shape for n, f in plan.program.fields.items()}
    dtypes = {n: f.dtype for n, f in plan.program.fields.items()}

    staged = []
    for seg in plan.segments:
        if seg.kind == "fused":
            ref1, _ = compile_body(seg.ops, seg.loop, shapes, dtypes, "jit",
                                   device=plan.device, batch=plan.batch,
                                   mesh=plan.mesh)

            def _ref_k(e, _ref=ref1, _k=seg.time_tile):
                for _ in range(_k):
                    e = _ref(e)
                return e

            launch = _diff_launch(seg.step, _ref_k)
            launch_rem = (_diff_launch(seg.step_rem, ref1)
                          if seg.step_rem is not None else None)
        else:
            launch, launch_rem = seg.step, seg.step
        staged.append((seg, launch, launch_rem))

    def run_local(env):
        env = dict(env)
        for seg, launch, launch_rem in staged:
            if seg.loop is None:
                env = launch(env)
                continue
            n, k = seg.loop.n, seg.time_tile
            if k > 1:
                chunk = max(1, (chunk_steps or 0) // k) or None
                launches = n // k
                chunk = chunk or max(1, int(np.ceil(np.sqrt(max(1, launches)))))
                env = _chunked(launch, env, launches, chunk, checkpoint)
                env = _chunked(launch_rem, env, n % k, max(1, n % k),
                               checkpoint)
            else:
                chunk = chunk_steps or max(1, int(np.ceil(np.sqrt(max(1, n)))))
                env = _chunked(launch, env, n, chunk, checkpoint)
        return env

    if plan.mesh is None:
        return run_local
    sharding = NamedSharding(plan.mesh)

    def run(env):
        out = run_local({k: list(sharding.shard(v).bricks)
                         for k, v in env.items()})
        return {k: BrickArray(v, sharding).gather(plan.device)
                for k, v in out.items()}

    return run


def checkpointed_vjp(chunk_fn, env0, n_chunks: int, *, spill_dir: str = None):
    """Out-of-core reverse sweep: spill chunk-boundary states, replay back.

    For runs whose checkpointed ladder still exceeds device memory, this
    trades the in-device ladder for host-side chunk snapshots: the forward
    sweep applies ``chunk_fn`` (any differentiable ``env -> env`` on
    tensors, e.g. one chunk of :func:`differentiable_runner` steps)
    ``n_chunks`` times without recording a graph, saving each chunk's
    *input* env — in memory, or on disk through
    :class:`repro_torch.checkpoint.manager.CheckpointManager` when
    ``spill_dir`` is given (atomic ``.npz`` snapshots, restored with their
    exact dtypes onto the tensors' devices).  Returns ``(env_final,
    vjp_fn)``; ``vjp_fn(cotangent_env)`` replays the chunks newest-first,
    restoring each saved state and pulling the cotangent back through
    ``chunk_fn``'s graph at that state — peak device memory is one chunk's
    saved tensors, whatever the run's length.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1; got {n_chunks}")
    manager = None
    snaps = []
    if spill_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager

        manager = CheckpointManager(spill_dir, keep=n_chunks)
    env = {k: torch.as_tensor(v).detach() for k, v in env0.items()}
    with torch.no_grad():
        for i in range(n_chunks):
            if manager is not None:
                manager.save(i, env)
            else:
                snaps.append(env)
            env = chunk_fn(env)
    final = env

    def vjp_fn(ct):
        ct = {k: torch.as_tensor(v) for k, v in ct.items()}
        for i in reversed(range(n_chunks)):
            if manager is not None:
                saved, _, _ = manager.restore(final, step=i)
            else:
                saved = snaps[i]
            with torch.enable_grad():
                ins = {k: v.detach().requires_grad_() for k, v in saved.items()}
                out = chunk_fn(ins)
                names = [k for k in out if out[k].requires_grad]
                grads = torch.autograd.grad([out[k] for k in names],
                                            list(ins.values()),
                                            [ct[k] for k in names],
                                            allow_unused=True)
            ct = {k: (torch.zeros_like(v) if g is None else g)
                  for (k, v), g in zip(ins.items(), grads)}
        return ct

    return final, vjp_fn
