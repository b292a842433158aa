"""The engine planner: one dispatch point for every execution path.

``plan(program, options)`` walks the recorded program's op groups exactly
once and schedules each as a :class:`Segment` — either a *fused* segment (the
:mod:`repro_torch.compiler` pipeline built one fused stencil kernel for the
body, possibly time-tiled so k steps share one wrap pad) or an *interpreter*
segment (the shared roll-based step, used by the ``jit`` backend and as the
logged fallback for bodies that do not lower).
:func:`repro_torch.engine.executor.execute` then runs the plan.

Time-tile selection: an explicit ``time_tile=k`` is honoured up to the
legality bounds of :func:`repro_torch.compiler.ir.tile_group` and clamped
with a logged reason otherwise; ``time_tile=None`` auto-picks the largest
power-of-two divisor of the trip count whose tiled halo stays small next to
the grid (:func:`repro_torch.compiler.ir.auto_tile`) — or, when the measured
cost model (:mod:`repro_torch.core.perfmodel`) holds a calibrated entry for
the body on the plan's device, the candidate it predicts fastest
(``stats.cost_model_hits`` counts the plans it serves).

Layout: planning is two-pass.  Pass one lowers each body and picks its
tile factor; with ``RunOptions(resident=True)`` (the default) and
``backend="pallas"``, the run-wide margin is ``K = max k·h`` over the fused
bodies and the plan carries ``HaloLayout(K, shapes)``
(:mod:`repro_torch.engine.layout`).  Pass two compiles each body against
that margin: the executor enters the layout once per run of fused
segments, and each launch refreshes four margin slabs in place and writes
a second resident buffer per written field (ping-pong), instead of
wrap-padding every input.  The reference writes in place and plans this
only in interpret mode, where blocks run one at a time; ping-pong makes it
valid on the card, so the port plans it on the CPU and the card alike.
``resident=False`` (or ``K = 0``: every fused body halo-free) keeps the
repacking step: a wrap pad per launch and fresh kernel outputs.

Ensembles: ``RunOptions(batch=B)`` plans the same segments over ``(B, X,
Y, Z)`` member stacks — fused bodies on K1 built for B members (one launch
advances all of them), interpreter steps on the whole stack, whose rolls
and masks act on the trailing three axes.

Overlap: ``RunOptions(overlap=True)`` splits each fused resident launch
whose body has a halo and whose brick keeps an interior at depth ``k·h``
(:func:`repro_torch.compiler.ir.split_regions`) into an interior launch
and four boundary shells, the margin exchange on a second stream meanwhile
(:func:`repro_torch.compiler.codegen._build_overlap_step`); the segment
records its shells in ``Segment.split``.  ``overlap="auto"`` splits only
where the body's calibrated cost-model entry predicts the split faster than
the monolithic launch at the brick's extent (no entry: monolithic);
``overlap=False`` never splits.

Differentiation: ``RunOptions(differentiable=True)`` plans no resident
layout (every fused body on the repacking step, fresh outputs per launch),
so the inputs of every launch survive as the saved inputs of
:func:`repro_torch.engine.executor.differentiable_runner`'s reverse pass.

Meshes: ``RunOptions(mesh=…)`` (a :class:`repro_torch.core.mesh.Mesh`)
plans every body for the mesh's bricks — fused bodies through
:func:`repro_torch.compiler.codegen.compile_group_sharded` (one K1 launch
per brick), interpreter steps through
:func:`repro_torch.core.halo.interp_step_sharded` — and tile legality is
judged on the brick extent.  ``backend="shard_map"`` is the ``jit`` backend
on a mesh (the default mesh over ``options.device`` when none is given);
``numpy`` drops the mesh.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.compiler import (LoweringError, auto_tile, lower_group,
                                   split_regions, tile_group)
from repro_torch.compiler.codegen import (compile_group, compile_group_sharded,
                                          try_compile)
from repro_torch.core import perfmodel
from repro_torch.core.mesh import Mesh
from repro_torch.core.program import Program, _group_ops, _interp_step
from repro_torch.device import resolve_device
from repro_torch.engine.layout import HaloLayout
from repro_torch.engine.options import UNSET, resolve_options
from repro_torch.engine.stats import stats

log = logging.getLogger("repro_torch.engine")

#: user-facing backends (``shard_map`` is ``jit`` on a mesh)
BACKENDS = ("numpy", "jit", "shard_map", "pallas")


@dataclasses.dataclass
class Segment:
    """One scheduled op group: the loop, its ops, and the compiled step(s).

    ``step`` advances ``time_tile`` logical steps per call; ``step_rem``
    (untiled) covers the ``n % k`` remainder when the tile factor does not
    divide the trip count.  ``numpy`` plans carry no compiled steps — the
    executor interprets ``ops`` eagerly.  ``written`` names the fields a
    fused body writes (the executor's ping-pong spares on a resident plan).
    """

    loop: Optional[object]
    ops: Tuple
    kind: str  # "fused" | "interp" | "eager"
    step: Optional[Callable] = None
    step_rem: Optional[Callable] = None
    time_tile: int = 1
    halo: int = 0
    reason: str = ""  # fallback / clamp explanation, "" when none
    written: Tuple[str, ...] = ()
    #: boundary shell launches per tile when the segment runs the
    #: interior/boundary overlap split (0 = monolithic fused launch)
    split: int = 0

    @property
    def n_steps(self) -> int:
        return self.loop.n if self.loop is not None else 1


@dataclasses.dataclass
class ExecutionPlan:
    """Scheduled execution of one recorded program on one device or on the
    bricks of ``mesh``.

    ``layout`` is the halo-resident layout the executor runs the fused
    segments on: every field (every brick, on a mesh) entered once to the
    plan-wide margin ``layout.pad`` (max ``k·h`` over the fused bodies).
    ``pad == 0`` (``resident=False``, an interpreter backend, or only
    halo-free bodies) is the repacking path.
    """

    program: Program
    backend: str  # normalized: "numpy" | "jit" | "pallas"
    device: Optional[torch.device]  # None for the host-only numpy backend
    segments: List[Segment]
    layout: Optional[HaloLayout] = None
    batch: int = 1  # leading member axis every env tensor carries (if > 1)
    mesh: Optional[Mesh] = None  # the bricks' mesh; None on one device
    #: built for reverse-mode AD: repacking steps only, no halo-resident
    #: layout — see RunOptions.differentiable
    differentiable: bool = False


def compile_body(
    ops,
    loop,
    shapes,
    dtypes,
    backend: str,
    *,
    device="cuda",
    time_tile: int = 1,
    group=None,
    resident: int = 0,
    batch: int = 1,
    mesh: Optional[Mesh] = None,
    split=None,
) -> Tuple[Callable, bool]:
    """Build one body application ``env -> env`` — THE backend dispatch.

    Returns ``(step, fused)``.  ``backend="pallas"`` routes through the
    compiler (fused kernel, ``time_tile`` sub-steps per call, interpreter
    fallback on :class:`LoweringError` counted in
    ``repro_torch.compiler.stats``); ``backend="jit"`` returns the shared
    roll-interpreter step.  ``resident=K`` builds a fused step on the
    halo-resident layout of margin ``K``, ``step(env, spare) -> env`` (see
    :func:`repro_torch.compiler.codegen.compile_group`); the solver keeps
    ``0``, so its vectors stay unpadded.  Steps operate on tensors on
    ``device`` (the card by default, which must exist); ``batch=B > 1``
    builds them over ``(B, X, Y, Z)`` member stacks.  With ``mesh`` the
    step operates on the mesh's bricks (name -> x-major list of brick
    tensors, on the bricks' own devices; ``shapes`` stay global): K1 per
    brick (:func:`repro_torch.compiler.codegen.compile_group_sharded`) or
    the roll interpreter on halo-padded bricks
    (:func:`repro_torch.core.halo.interp_step_sharded`).  ``split`` (a
    :class:`repro_torch.compiler.ir.SplitRegions` of this body at
    ``time_tile`` on the brick, from the planner) builds a fused resident
    step as the interior/boundary split; ``None`` keeps the monolithic
    launch.
    """
    if mesh is None:
        device = resolve_device(device)
    stats.bodies_compiled += 1
    if backend == "pallas":
        from repro_torch.engine.hooks import fire_compile_hook

        def fn():
            # the hook can raise LoweringError — the injectable stand-in for
            # a lowering failure; try_compile turns it into the fallback
            fire_compile_hook(getattr(loop, "name", None))
            if mesh is not None:
                return compile_group_sharded(
                    ops, shapes, dtypes, mesh, time_tile=time_tile,
                    group=group, resident=resident, batch=batch,
                    split=split)
            return compile_group(ops, shapes, dtypes, device=device,
                                 time_tile=time_tile, group=group,
                                 resident=resident, batch=batch,
                                 split=split)

        step = try_compile(fn, loop)
        if step is not None:
            return step, True
    elif backend != "jit":
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if mesh is not None:
        from repro_torch.core.halo import interp_step_sharded

        return interp_step_sharded(ops, mesh), False
    return _interp_step(ops), False


@dataclasses.dataclass
class LevelSegment:
    """One multigrid level's scheduled bodies and transfers.

    The multi-level analogue of :class:`Segment`: ``smooth`` and ``resid``
    are compiled body applications (``env -> env``, fused kernel K1 or roll
    interpreter — the same :func:`compile_body` dispatch as every other
    path), ``restrict``/``prolong`` move tensors to/from the next-coarser
    level (``None`` on the coarsest).  ``diag`` is the level operator's
    constant diagonal, which the smoother and coarse solve divide by.
    """

    level: int
    shape: Tuple[int, int, int]
    smooth: Callable
    resid: Callable
    smooth_fused: bool
    resid_fused: bool
    diag: float
    restrict: Optional[Callable] = None
    prolong: Optional[Callable] = None


def plan_mg_levels(bodies, backend: str, dtype,
                   device="cuda") -> List[LevelSegment]:
    """Schedule one multigrid hierarchy: every level body through the
    engine's single dispatch point, every transfer through the kernel cache.

    ``bodies`` is finest-first; each entry is a dict with ``shape``,
    ``diag`` and two recorded bodies ``smooth``/``resid`` as ``(ops,
    shapes, dtypes)`` triples (see :mod:`repro_torch.solver.multigrid`,
    which records them per level).  ``backend="pallas"`` lowers each body to
    one fused kernel — one cache entry per level — and the transfers to the
    restriction/prolongation kernels K3/K4 of
    :mod:`repro_torch.kernels.transfer` (on a CPU ``device`` their plain
    versions run; unlike the reference, no environment decides this);
    ``backend="jit"`` uses the roll interpreter and the plain transfers.
    Per-level outcomes land in ``stats.mg_level_log``.  The levels live on
    ``device``: the card by default, which must exist.
    """
    from repro_torch.compiler.codegen import compile_transfer
    from repro_torch.kernels.transfer import prolong_ref, restrict_ref

    device = resolve_device(device)

    segments: List[LevelSegment] = []
    log_entries = []
    for lvl, body in enumerate(bodies):
        shape = tuple(body["shape"])
        s_ops, s_shapes, s_dtypes = body["smooth"]
        r_ops, r_shapes, r_dtypes = body["resid"]
        smooth, s_fused = compile_body(s_ops, None, s_shapes, s_dtypes, backend,
                                       device=device)
        resid, r_fused = compile_body(r_ops, None, r_shapes, r_dtypes, backend,
                                      device=device)
        seg = LevelSegment(
            level=lvl,
            shape=shape,
            smooth=smooth,
            resid=resid,
            smooth_fused=s_fused,
            resid_fused=r_fused,
            diag=float(body["diag"]),
        )
        if lvl + 1 < len(bodies):
            coarse = tuple(bodies[lvl + 1]["shape"])
            if backend == "pallas":
                seg.restrict = compile_transfer("restrict", shape, coarse, dtype,
                                                device)
                seg.prolong = compile_transfer("prolong", shape, coarse, dtype,
                                               device)
            else:
                seg.restrict = restrict_ref
                seg.prolong = lambda c, n=shape: prolong_ref(c, n)
        segments.append(seg)
        log_entries.append((shape, s_fused, r_fused))
        stats.mg_levels_built += 1
    stats.mg_hierarchies += 1
    stats.mg_level_log = tuple(log_entries)
    return segments


def _brick_xy(program: Program, mesh: Optional[Mesh],
              group) -> Tuple[int, int]:
    """Per-brick (X, Y) extent of the fields ``group`` touches (the whole
    grid on one device), anchored on its first written field (the
    convention ``codegen._field_specs`` validates)."""
    nx, ny, _ = program.fields[group.fields_written()[0]].shape
    if mesh is None:
        return nx, ny
    mx, my = mesh.dims
    return nx // mx, ny // my


def _mesh_device(mesh: Mesh, device) -> torch.device:
    """The mesh's home device, after checking that ``device`` (the run's
    ``RunOptions.device``) names the same device type as every brick: a
    CPU mesh never runs under the card default, nor the reverse."""
    want = torch.device(device).type
    types = {d.type for d in mesh.devices}
    if types != {want}:
        raise ValueError(
            f"RunOptions(device={str(device)!r}) but the mesh's bricks are on "
            f"{sorted(types)}; pass the device type the mesh was built for")
    return mesh.home


def _pick_tile(group, loop, requested: Optional[int], brick_xy, cost=None,
               nz=None) -> Tuple[int, str]:
    """Resolve the tile factor for one fused loop body: (k, clamp_reason).

    ``cost`` is this body's calibrated
    :class:`~repro_torch.core.perfmodel.MeasuredCost` entry when one exists:
    auto selection then minimizes the measured model over the legal
    candidates instead of applying the static rule (``k = 1`` always
    admissible — see :func:`repro_torch.compiler.ir.auto_tile`).
    """
    n = loop.n if loop is not None else 1
    if n <= 1:
        return 1, ""
    if requested is None:
        return auto_tile(group, brick_xy, n, cost=cost, nz=nz), ""
    k = max(1, int(requested))
    try:
        tile_group(group, k, brick_xy=brick_xy, n_steps=n)
        return k, ""
    except LoweringError as e:
        kmax = n
        if group.halo > 0:
            kmax = min(kmax, min(brick_xy) // group.halo)
        k_ok = max(1, min(k, kmax))
        reason = f"time_tile={requested} clamped to k={k_ok}: {e}"
        log.warning("%s", reason)
        return k_ok, reason


def _split_pays(cost, brick_xy, nz: int, h: int, k: int) -> bool:
    """``overlap="auto"``'s test: a calibrated entry predicts the split step
    faster than the monolithic one at the brick's extent (no entry: no)."""
    if cost is None:
        return False
    return (perfmodel.predict_step_us(cost, brick_xy, nz, h, k, split=True)
            < perfmodel.predict_step_us(cost, brick_xy, nz, h, k))


def plan(
    program: Program,
    options=None,
    *,
    backend=UNSET,
    mesh=UNSET,
    time_tile=UNSET,
    resident=UNSET,
) -> ExecutionPlan:
    """Schedule a recorded program: group ops once, pick a strategy per body.

    Execution policy arrives as one frozen
    :class:`~repro_torch.engine.options.RunOptions` bundle (a bare string is
    accepted as the backend).  The legacy ``backend=`` / ``mesh=`` /
    ``time_tile=`` / ``resident=`` keywords warn once per keyword and
    forward into the bundle.

    Two passes: pass one lowers each body, looks up its calibrated
    cost-model entry for the plan's device (a mesh's home device) and picks
    its tile factor, which fixes the run-wide margin ``K = max k·h`` of the
    halo-resident layout; pass two decides the overlap split and compiles
    each body (and its remainder step) against ``K``.
    """
    options = resolve_options(
        options,
        "engine.plan",
        backend=backend,
        mesh=mesh,
        time_tile=time_tile,
        resident=resident,
    )
    backend = options.resolved_backend("jit")
    time_tile = options.time_tile
    mesh = options.mesh

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "shard_map":
        backend = "jit"
        if mesh is None:
            from repro_torch.core.halo import default_mesh2d

            mesh = default_mesh2d(options.device)
    # the numpy validation backend is eager and host-only: it never touches
    # a device or a mesh, so it needs none; a mesh's bricks carry their own
    if backend == "numpy":
        mesh = device = None
    elif mesh is not None:
        device = _mesh_device(mesh, options.device)
    else:
        device = resolve_device(options.device)

    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    if mesh is not None:
        mx, my = mesh.dims
        for n, (nx, ny, _) in shapes.items():
            if nx % mx or ny % my:
                raise ValueError(f"field {n} shape ({nx},{ny}) not divisible "
                                 f"by mesh ({mx},{my})")

    # pass one: lower + pick tile factors
    scheduled = []
    for loop, ops in _group_ops(program):
        group = None
        k, reason = 1, ""
        cost = None
        if backend == "pallas":
            try:
                group = lower_group(ops)
            except LoweringError:
                group = None  # compile_body repeats the lowering to log/count
            if group is not None:
                name0 = group.fields_written()[0]
                cost = perfmodel.cost_model.lookup(
                    group, shapes[name0][2], dtypes[name0], device)
                if cost is not None:
                    stats.cost_model_hits += 1
                k, reason = _pick_tile(group, loop, time_tile,
                                       _brick_xy(program, mesh, group),
                                       cost=cost, nz=shapes[name0][2])
        elif backend != "numpy" and time_tile is not None and time_tile != 1:
            # an explicit tile request on an interpreter backend is dropped,
            # not honoured — say so instead of silently running untiled
            reason = (
                f"time_tile={time_tile} ignored: backend {backend!r} has no "
                "fused kernels to tile (use backend='pallas')"
            )
            log.warning("%s", reason)
        scheduled.append((loop, ops, group, k, reason, cost))

    pad = 0
    if options.resident and backend == "pallas" and not options.differentiable:
        # a differentiable plan keeps the repacking steps: the resident
        # layout's ping-pong outputs and margin rewrites reuse buffers that
        # a reverse pass keeps as saved inputs
        pad = max((k * g.halo for _, _, g, k, _, _ in scheduled
                   if g is not None), default=0)
    layout = HaloLayout(pad=pad, shapes=shapes)

    # pass two: compile each body against the layout
    segments: List[Segment] = []
    for loop, ops, group, k, reason, cost in scheduled:
        if backend == "numpy":
            segments.append(Segment(loop=loop, ops=tuple(ops), kind="eager"))
            continue
        # the overlap split, decided here only: on a resident plan, for a
        # body with a halo whose brick keeps an interior at depth k·h, when
        # forced (overlap=True) or, on "auto", predicted faster than the
        # monolithic launch by the body's calibrated entry; None is the
        # monolithic launch
        split = split_rem = None
        if options.overlap is not False and group is not None and pad > 0:
            brick = _brick_xy(program, mesh, group)
            split = split_regions(group, k, brick)
            if options.overlap == "auto" and not _split_pays(
                    cost, brick, shapes[group.fields_written()[0]][2],
                    group.halo, k):
                split = None
            if split is not None:  # the n % k remainder step splits at k = 1
                split_rem = split_regions(group, 1, brick)
        step, fused = compile_body(ops, loop, shapes, dtypes, backend,
                                   device=device, time_tile=k, group=group,
                                   resident=pad, batch=options.batch,
                                   mesh=mesh, split=split)
        if not fused:
            k = 1
            split = None
        seg = Segment(
            loop=loop,
            ops=tuple(ops),
            kind="fused" if fused else "interp",
            step=step,
            time_tile=k,
            halo=group.halo if group is not None else 0,
            reason=reason,
            written=tuple(group.fields_written()) if fused else (),
            split=len(split.shells) if split is not None else 0,
        )
        if fused and k > 1 and seg.n_steps % k:
            seg.step_rem, _ = compile_body(ops, loop, shapes, dtypes, backend,
                                           device=device, time_tile=1,
                                           group=group, resident=pad,
                                           batch=options.batch, mesh=mesh,
                                           split=split_rem)
        if reason:
            stats.note_tile_reason(reason)
        if fused:
            stats.segments_fused += 1
        else:
            stats.segments_interp += 1
        segments.append(seg)

    stats.plans_built += 1
    stats.max_time_tile = max(
        stats.max_time_tile, max((s.time_tile for s in segments), default=1)
    )
    return ExecutionPlan(program=program, backend=backend, device=device,
                         segments=segments, layout=layout, batch=options.batch,
                         mesh=mesh, differentiable=options.differentiable)
