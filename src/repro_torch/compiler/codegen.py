"""Codegen pass + kernel cache for the WFA program compiler.

``compile_group`` turns one loop body's lowered :class:`LoweredGroup` into a
``step(env) -> env`` function around exactly one launch of the fused stencil
kernel K1 (built by :func:`repro_torch.kernels.fused.build_fused_call`).
Kernels are memoized by *program signature* — the lowered tap form plus
field shapes/dtypes, time tile, members and device — so re-making an identical
program (the WFA's repeated ``make_WSE`` workflow) reuses the built kernel;
:data:`stats` exposes build/hit/fallback counters for tests and benchmarks.

:func:`compile_transfer` caches the multigrid transfer kernels (K3, K4) in
the same cache.

Two single-device steps are ported:

* the halo-resident step (``resident=K``, what the planner builds for
  ``backend="pallas"`` by default): fields live in resident buffers with a
  ``K``-deep margin (:mod:`repro_torch.engine.layout`); each launch
  refreshes the four margin slabs to depth ``k·h`` in place, K1's margin
  mode reads the current buffers and writes the spare buffer of each
  written field, and the step swaps the two;
* the repacking step (``resident=0``): every launch wrap-pads its inputs by
  ``k·h`` (so out-of-domain taps reproduce the interpreter's ``roll``
  semantics) and the kernel writes fresh outputs.

Both take ``batch=B``: every env tensor is then a ``(B, X, Y, Z)`` member
stack and the one launch per step advances all B members (K1's member
axis), each member's bits those of its own single run.

:func:`compile_group_sharded` builds the same two steps over the bricks of
a :class:`~repro_torch.core.mesh.Mesh`: K1 built once for the brick extent
without wrap (the Moat from each brick's global coordinates), one launch
per brick, the halos exchanged between bricks
(:func:`repro_torch.core.halo.halo_refresh` on resident bricks,
:func:`~repro_torch.core.halo.halo_pad` on the repacking step).

Both builders take ``split=`` on the resident layout (the planner's
:func:`repro_torch.compiler.ir.split_regions` of the body on the brick):
the launch is split into an interior launch (K1's region mode, which reads
no margin) and four boundary-shell launches (:func:`_build_overlap_step`),
so the margin exchange can run on a second stream while the interior
computes.  ``split=None`` is the monolithic launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
from typing import Dict, Tuple

import torch

from repro_torch.compiler.ir import (LoweredGroup, LoweringError, RegionSpec,
                                     SplitRegions, lower_group)
from repro_torch.convert import dtype_name, torch_dtype

log = logging.getLogger("repro_torch.compiler")


@dataclasses.dataclass
class CompilerStats:
    """Counters for the fused-kernel pipeline (reset with ``reset_stats``)."""

    groups_fused: int = 0      # loop bodies routed to a fused kernel
    kernels_built: int = 0     # distinct fused kernels constructed
    cache_hits: int = 0        # loop bodies served from the kernel cache
    fallbacks: int = 0         # loop bodies routed to the interpreter
    fallback_reasons: Tuple[str, ...] = ()

    def note_fallback(self, reason: str) -> None:
        self.fallbacks += 1
        self.fallback_reasons = self.fallback_reasons + (reason,)


stats = CompilerStats()

_KERNEL_CACHE: Dict[tuple, object] = {}
#: held across each cache lookup and the build it may start, so threads
#: (the service's workers) that meet one new signature together build it
#: once and share it
_CACHE_LOCK = threading.Lock()


def reset_stats() -> None:
    # mutate in place so `from repro_torch.compiler import stats` stays live
    stats.groups_fused = 0
    stats.kernels_built = 0
    stats.cache_hits = 0
    stats.fallbacks = 0
    stats.fallback_reasons = ()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _KERNEL_CACHE.clear()


def try_compile(compile_fn, loop):
    """The fallback policy: run ``compile_fn()``; on :class:`LoweringError`
    count the fallback, log the reason and return ``None`` so the caller
    substitutes its interpreter step.  Only lowering errors are caught — a
    kernel that fails to build or launch raises."""
    try:
        return compile_fn()
    except LoweringError as e:
        stats.note_fallback(str(e))
        log.warning(
            "pallas lowering failed for loop %r: %s — falling back to the "
            "interpreter for this body", getattr(loop, "name", None), e)
        return None


def _field_specs(group: LoweredGroup, shapes: Dict[str, tuple],
                 dtypes: Dict[str, object]):
    """Ordered name -> (nz, torch dtype); validates a common (X, Y) extent."""
    names = list(group.fields_written())
    for n in group.fields_read():
        if n not in names:
            names.append(n)
    base_xy = shapes[names[0]][:2]
    for n in names:
        if shapes[n][:2] != base_xy:
            raise LoweringError(
                f"fields {names[0]!r} {shapes[names[0]]} and {n!r} "
                f"{shapes[n]} disagree in (X, Y); cannot fuse")
    specs = {n: (shapes[n][2], torch_dtype(dtypes[n])) for n in names}
    return specs, base_xy


def _get_kernel(group: LoweredGroup, specs, bx, by, nx, ny, device, time_tile,
                wrap, margin=0, batch=1, region=None):
    from repro_torch.kernels.fused import build_fused_call

    device = torch.device(device)
    # ``region`` tags the overlap's interior launch (None: the whole brick)
    sig = (group, tuple((n, s[0], dtype_name(s[1])) for n, s in specs.items()),
           bx, by, nx, ny, str(device), int(time_tile), bool(wrap), int(margin),
           int(batch), region)
    with _CACHE_LOCK:
        hit = _KERNEL_CACHE.get(sig)
        if hit is not None:
            stats.cache_hits += 1
            return hit
        # a body outside the kernel's limits (dtype, field count,
        # descriptor size) raises ValueError here: it is a gap of the port,
        # not a lowering failure, so it must not become an interpreter
        # fallback
        built = build_fused_call(group.updates, specs, group.halo, bx, by,
                                 nx, ny, time_tile=time_tile, wrap=wrap,
                                 device=device, margin=margin, batch=batch,
                                 region=region)
        stats.kernels_built += 1
        _KERNEL_CACHE[sig] = built
        return built


def compile_transfer(kind: str, fine_shape, coarse_shape, dtype,
                     device="cuda"):
    """Build (and cache) one inter-grid transfer for a level pair.

    ``kind`` is ``"restrict"`` (full weighting, fine → coarse, K3) or
    ``"prolong"`` (trilinear, coarse → fine, K4); the canonical form is
    :class:`repro_torch.compiler.ir.TransferStencil`, which validates the
    shape pair once, here.  Cached in the same signature-keyed cache as the
    fused stencil kernels — one entry per (kind, level-pair shapes, dtype,
    device) — with the same ``kernels_built`` / ``cache_hits`` accounting.
    The returned call is :func:`repro_torch.kernels.ops.restrict` or
    :func:`~repro_torch.kernels.ops.prolong` bound to the level pair: it
    launches the kernel on a CUDA tensor and runs its plain version on a
    CPU one.  ``device`` is the card by default, which must exist.
    """
    from repro_torch.compiler.ir import TransferStencil
    from repro_torch.engine.plan import resolve_device
    from repro_torch.kernels import ops

    ts = TransferStencil(kind, tuple(fine_shape), tuple(coarse_shape))
    device = resolve_device(device)
    sig = ("transfer", ts, dtype_name(dtype), str(device))
    with _CACHE_LOCK:
        hit = _KERNEL_CACHE.get(sig)
        if hit is not None:
            stats.cache_hits += 1
            return hit
        if kind == "restrict":
            call = functools.partial(ops.restrict)
        else:
            call = functools.partial(ops.prolong, fine_shape=ts.fine_shape)
        stats.kernels_built += 1
        _KERNEL_CACHE[sig] = call
        return call


def _wrap_pad(v: torch.Tensor, ph: int) -> torch.Tensor:
    """``ph``-deep periodic pad of the (X, Y) axes (``ph`` ≤ extent), the
    last three axes being (X, Y, Z); leading (member) axes pass through."""
    v = torch.cat([v[..., -ph:, :, :], v, v[..., :ph, :, :]], dim=-3)
    return torch.cat([v[..., -ph:, :], v, v[..., :ph, :]], dim=-2)


class _SideStreams:
    """The overlap step's second stream on each CUDA device it runs on, and
    the two events per device that order it: ``entry`` (recorded on the
    device's current stream when the exchange starts; the side stream waits
    on it) and ``done`` (recorded on the side stream when the exchange is
    enqueued; :meth:`join` makes the current stream wait on it).  Nothing
    for CPU devices, where the exchange runs inline."""

    def __init__(self, devices):
        self.devices = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
        self.side = {d: torch.cuda.Stream(d) for d in self.devices}
        self.entry = {d: torch.cuda.Event() for d in self.devices}
        self.done = {d: torch.cuda.Event() for d in self.devices}

    @contextlib.contextmanager
    def exchange(self):
        """Work enqueued inside goes to the side streams, after everything
        enqueued before on the current streams."""
        with contextlib.ExitStack() as stack:
            for d in self.devices:
                self.entry[d].record(torch.cuda.current_stream(d))
                self.side[d].wait_event(self.entry[d])
                stack.enter_context(torch.cuda.stream(self.side[d]))
            yield
            for d in self.devices:
                self.done[d].record(self.side[d])

    def join(self) -> None:
        """Work enqueued after this on the current streams waits for the
        exchange."""
        for d in self.devices:
            torch.cuda.current_stream(d).wait_event(self.done[d])


def _check_split(split: SplitRegions, resident: int, ph: int, brick) -> None:
    """Raise :class:`ValueError` unless ``split`` is the split of a resident
    step at depth ``ph = k·h`` on a ``brick``-sized brick."""
    bx, by = brick
    if not resident or split.interior != RegionSpec(ph, ph, bx - 2 * ph,
                                                     by - 2 * ph):
        raise ValueError(f"{split} is not the split of a resident step at "
                         f"depth {ph} on a {bx}×{by} brick")


def _build_overlap_step(group, specs, bx, by, nx, ny, time_tile, wrap, margin,
                        batch, split, bricks, slabs_fn, single):
    """One interior/boundary-split step of the exchange/compute overlap
    (the reference's ``_build_overlap_step``), ``step(env, spare) -> env``
    on the resident layout of margin ``margin``.

    ``bricks`` lists each brick's ``(device, global origin)`` (one entry on
    one device, where ``single`` says env values are tensors rather than
    x-major lists of bricks); ``slabs_fn(buffers, out)`` extracts the
    depth-``k·h`` margin slabs of one field's brick buffers into the held
    slab buffers ``out`` (:func:`repro_torch.engine.layout.wrap_slabs` on
    one device, :func:`repro_torch.core.halo.exchange_slabs` on a mesh).
    The schedule, per step:

    1. **exchange in flight** — the slabs of every input go to buffers of
       their own, on a second CUDA stream (:class:`_SideStreams`) that
       starts after everything already enqueued; the slabs only read the
       current buffers.
    2. **interior launch** — K1's region mode over ``split.interior``, per
       brick on the current stream, from the current buffers into the
       spares (ping-pong): its window lies inside the brick, so it needs no
       slab, and nothing orders it after the exchange.
    3. **boundary launches** — the current stream waits for the exchange;
       then, shell by shell, each shell's padded window is assembled from
       the current buffer and the slabs
       (:func:`repro_torch.engine.layout.strip_window`, cell for cell the
       window a monolithic launch reads off a refreshed buffer), K1's
       padded mode steps it at the shell's extent, and
       :func:`~repro_torch.engine.layout.land_region` stores it in the
       spare.

    Every K1 launch is on the current stream (the sweep's held scratch is
    per kernel, and kernels are shared by the bricks of a device); only
    copies go to the side stream.  Slab, window and shell-output buffers
    are allocated at the first call and held, so a split step allocates
    nothing after it.  The split gives the monolithic launch's bits: every
    launch runs the same per-cell arithmetic and the same global Moat.  On
    the CPU the same step runs inline, on the plain versions.
    """
    from repro_torch.engine.layout import land_region, slab_buffers, strip_window
    from repro_torch.kernels.ops import fused_step

    ph = time_tile * group.halo
    in_names = list(specs)
    devices = list(dict.fromkeys(dev for dev, _ in bricks))
    interior = {}
    for dev in devices:
        interior[dev], written = _get_kernel(
            group, specs, bx, by, nx, ny, dev, time_tile, wrap, margin=margin,
            batch=batch, region=split.interior)
    shells = [{dev: _get_kernel(group, specs, r.rx, r.ry, nx, ny, dev,
                                time_tile, wrap, batch=batch)[0]
               for dev in devices} for r in split.shells]
    held = {}

    def hold(cur):
        """The step's side streams and buffers, allocated at its first call
        (the plan fixes every buffer's shape, dtype and device)."""
        if not held:
            held["streams"] = _SideStreams(dev for dev, _ in bricks)
            held["slabs"] = {n: [slab_buffers(t, bx, by, ph) for t in cur[n]]
                             for n in in_names}
            held["windows"] = [
                {n: [t.new_empty((*t.shape[:-3], r.rx + 2 * ph, r.ry + 2 * ph,
                                  t.shape[-1])) for t in cur[n]]
                 for n in in_names} for r in split.shells]
            held["outs"] = [
                [[cur[n][b].new_empty((*cur[n][b].shape[:-3], r.rx, r.ry,
                                       cur[n][b].shape[-1])) for n in written]
                 for b in range(len(bricks))] for r in split.shells]
        return held

    def step(env, spare):
        env = dict(env)
        cur = {n: [env[n]] if single else list(env[n]) for n in in_names}
        dst = {n: [spare[n]] if single else list(spare[n]) for n in written}
        h = hold(cur)
        streams = h["streams"]
        with streams.exchange():
            slabs = {n: slabs_fn(cur[n], h["slabs"][n]) for n in in_names}
        r = split.interior
        try:
            for b, (dev, (cx, cy)) in enumerate(bricks):
                fused_step(interior[dev], [cur[n][b] for n in in_names],
                           (cx + r.x0, cy + r.y0),
                           out=[dst[n][b] for n in written])
        finally:
            streams.join()
        for r, kernels, wins, outs in zip(split.shells, shells, h["windows"],
                                          h["outs"]):
            for b, (dev, (cx, cy)) in enumerate(bricks):
                ins = [strip_window(cur[n][b], slabs[n][b], margin, ph, r, bx,
                                    by, out=wins[n][b]) for n in in_names]
                got = fused_step(kernels[dev], ins, (cx + r.x0, cy + r.y0),
                                 out=outs[b])
                for name, o in zip(written, got):
                    land_region(dst[name][b], o, margin, r)
        for name in written:
            env[name], spare[name] = spare[name], env[name]
        return env

    return step


def compile_group(ops, shapes: Dict[str, tuple], dtypes: Dict[str, object],
                  device="cuda", *, time_tile: int = 1,
                  group: LoweredGroup = None, resident: int = 0,
                  batch: int = 1, split: SplitRegions = None):
    """Lower + codegen one loop body for single-device execution.

    With ``time_tile=k`` each call advances *k* steps off one halo window of
    depth ``k·h`` (validated by :func:`repro_torch.compiler.ir.tile_group`).
    Pass ``group=`` to reuse a lowering the planner already derived.

    ``resident=0`` returns ``step(env) -> env``: one launch on wrap-padded
    copies of ``env``'s tensors, into fresh outputs.  ``resident=K`` returns
    ``step(env, spare) -> env`` on the halo-resident layout: ``env`` holds
    resident buffers with a ``K``-deep margin, ``spare`` (owned by the
    executor, updated in place) one more buffer per written field; the step
    refreshes every input's margin to depth ``k·h``, launches K1 from the
    current buffers into the spares and swaps the two.  Fields the body
    only reads stay in their (refreshed) buffers.

    ``batch=B > 1`` builds the same steps over ``(B, …)`` member stacks:
    K1 is built for B members, so each launch advances all of them.

    ``split`` (resident only; the body's
    :func:`repro_torch.compiler.ir.split_regions` at ``time_tile`` on the
    grid) builds the split step of :func:`_build_overlap_step` instead, its
    slabs from :func:`repro_torch.engine.layout.wrap_slabs`.

    Raises :class:`LoweringError` when the body cannot be fused (the caller
    falls back to the interpreter and logs the reason) or when ``K < k·h``,
    and ``ValueError`` when it is outside the fused kernel's limits (see
    :func:`repro_torch.kernels.fused.build_fused_call`), which no caller
    catches.
    """
    from repro_torch.compiler.ir import tile_group
    from repro_torch.kernels.ops import fused_step

    if group is None:
        group = lower_group(ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    # the same bound the planner clamps against: a wrap pad deeper than the
    # grid would be ill-formed
    tiled = tile_group(group, time_tile, brick_xy=(nx, ny))
    ph = tiled.halo            # k·h margin, paid once per tile
    if resident and resident < ph:
        raise LoweringError(f"resident margin {resident} < tiled halo {ph}")
    if split is not None:
        from repro_torch.engine.layout import wrap_slabs

        _check_split(split, resident, ph, (nx, ny))
        step = _build_overlap_step(
            group, specs, nx, ny, nx, ny, time_tile, True, resident, batch,
            split, bricks=[(torch.device(device), (0, 0))],
            slabs_fn=lambda bufs, out: [wrap_slabs(bufs[0], resident, ph,
                                                   out=out[0])],
            single=True)
        stats.groups_fused += 1
        return step
    kernel, written = _get_kernel(group, specs, nx, ny, nx, ny, device,
                                  time_tile, wrap=True, margin=resident,
                                  batch=batch)
    in_names = list(specs)
    stats.groups_fused += 1

    if resident:
        from repro_torch.engine.layout import wrap_refresh

        def step(env, spare):
            env = dict(env)
            ins = [wrap_refresh(env[n], resident, ph) for n in in_names]
            fused_step(kernel, ins, out=[spare[n] for n in written])
            for name in written:
                env[name], spare[name] = spare[name], env[name]
            return env

        return step

    def step(env):
        env = dict(env)
        padded = [_wrap_pad(env[n], ph) if ph else env[n].contiguous()
                  for n in in_names]
        outs = fused_step(kernel, padded)
        for name, out in zip(written, outs):
            env[name] = out
        return env

    return step


def compile_group_sharded(ops, shapes: Dict[str, tuple],
                          dtypes: Dict[str, object], mesh, *,
                          time_tile: int = 1, group: LoweredGroup = None,
                          resident: int = 0, batch: int = 1,
                          split: SplitRegions = None):
    """Lower + codegen one loop body for the bricks of ``mesh``.

    ``shapes`` are the global field shapes, which must divide the mesh; the
    returned step operates on name -> x-major list of brick tensors (each
    on its brick's device).  K1 is built for the brick extent with
    ``wrap=False``, once per device of the mesh, and launched once per
    brick with the brick's global origin ``(cx·bx, cy·by)`` as its
    coordinates, so the Moat and the out-of-domain cells come from global
    coordinates.

    ``resident=0``: ``step(env) -> env`` halo-pads every brick to depth
    ``k·h`` (:func:`repro_torch.core.halo.halo_pad`, ONE exchange per k
    steps) and launches K1's padded mode into fresh outputs.
    ``resident=K``: ``step(env, spare) -> env`` on ``(…, bx + 2K, by + 2K,
    nz)`` resident bricks: the margins are refreshed to depth ``k·h`` in
    place (:func:`~repro_torch.core.halo.halo_refresh`), K1's margin mode
    writes each brick's spare, and the step swaps the lists.  Both give the
    same bits.  ``batch=B`` builds both over ``(B, …)`` member stacks in
    every brick.  ``split`` (resident only; the body's
    :func:`repro_torch.compiler.ir.split_regions` at ``time_tile`` on the
    brick) builds the split step of :func:`_build_overlap_step`, its slabs
    exchanged by :func:`repro_torch.core.halo.exchange_slabs`.

    Raises :class:`LoweringError` when the body cannot be fused, the
    extent does not divide the mesh, or ``K < k·h``.
    """
    from repro_torch.compiler.ir import tile_group
    from repro_torch.core.halo import exchange_slabs, halo_pad, halo_refresh
    from repro_torch.kernels.ops import fused_step

    if group is None:
        group = lower_group(ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    mx, my = mesh.dims
    if nx % mx or ny % my:
        raise LoweringError(
            f"global extent ({nx},{ny}) not divisible by mesh ({mx},{my})")
    bx, by = nx // mx, ny // my
    tiled = tile_group(group, time_tile, brick_xy=(bx, by))
    ph = tiled.halo
    if resident and resident < ph:
        raise LoweringError(f"resident margin {resident} < tiled halo {ph}")
    origins = [tuple(c * e for c, e in zip(mesh.coords(b), (bx, by)))
               for b in range(mesh.size)]
    if split is not None:
        _check_split(split, resident, ph, (bx, by))
        step = _build_overlap_step(
            group, specs, bx, by, nx, ny, time_tile, False, resident, batch,
            split, bricks=list(zip(mesh.devices, origins)),
            slabs_fn=lambda bufs, out: exchange_slabs(bufs, resident, ph, mesh,
                                                      out=out),
            single=False)
        stats.groups_fused += 1
        return step
    kernels = {}
    for dev in mesh.devices:
        if dev not in kernels:
            kernels[dev], written = _get_kernel(
                group, specs, bx, by, nx, ny, dev, time_tile, wrap=False,
                margin=resident, batch=batch)
    bricks = [(kernels[dev], origin)
              for dev, origin in zip(mesh.devices, origins)]
    in_names = list(specs)
    stats.groups_fused += 1

    if resident:

        def step(env, spare):
            env = dict(env)
            for n in in_names:
                halo_refresh(env[n], resident, ph, mesh)
            for b, (kernel, coords) in enumerate(bricks):
                fused_step(kernel, [env[n][b] for n in in_names], coords,
                           out=[spare[n][b] for n in written])
            for name in written:
                env[name], spare[name] = spare[name], env[name]
            return env

        return step

    def step(env):
        env = dict(env)
        padded = [halo_pad(env[n], ph, mesh) if ph
                  else [t.contiguous() for t in env[n]] for n in in_names]
        outs = [fused_step(kernel, [p[b] for p in padded], coords)
                for b, (kernel, coords) in enumerate(bricks)]
        for i, name in enumerate(written):
            env[name] = [o[i] for o in outs]
        return env

    return step
