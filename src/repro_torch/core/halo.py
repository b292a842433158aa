"""Bricks and their halo exchange — the port of ``repro/core/halo.py``.

A brick function of the reference runs once per device under ``shard_map``
and exchanges planes with ``lax.ppermute``.  Here one process holds every
brick (:mod:`repro_torch.core.mesh`), so each function takes the list of
bricks, x-major, and returns a list; the bricks move in lock step as they
do under ``shard_map``.  Bricks exchange planes only through
:func:`_ppermute_shift` and reduce only through
:func:`repro_torch.core.mesh.psum`: multi-card transport plugs in there.

* :func:`halo_pad` — a padded copy of every brick (the repacking step);
* :func:`exchange_slabs` / :func:`halo_refresh` — the resident step's
  margin refresh: four slabs per brick, landed in place;
* :func:`evaluate_padded` / :func:`interp_step_sharded` — the roll
  interpreter on halo-padded bricks (the sharded ``jit`` backend and the
  sharded fallback);
* :func:`run_sharded` — the mesh entry point into the engine.

Every exchange goes X first, then Y from the x-extended rows, so corner
cells arrive from the diagonal neighbour in two hops; a brick on the
domain's edge receives zeros.  Leading (member) axes travel whole.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import stencil as st
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.kernels.stencil7 import moat_mask


def _ppermute_shift(parts: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
                    direction: int,
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> List[torch.Tensor]:
    """What each brick receives from its neighbour along ``axis_name``:
    ``direction=+1`` from the lower index, ``-1`` from the higher one.

    ``parts[b]`` is what brick ``b`` sends.  The permutation is not cyclic
    (the reference's ``[(i, i+1)]``): a brick on the domain's edge receives
    zeros, and a 1-brick axis receives zeros only.  Without ``out`` each
    received part is a fresh contiguous copy on the receiver's device;
    with ``out`` (one destination view per brick, on the receiver's
    device, overlapping no part) it is copied or zero-filled there, and
    nothing is allocated.  This is the only place bricks exchange planes:
    multi-card transport plugs in here.
    """
    axis = mesh.axis_names.index(axis_name)
    n = mesh.dims[axis]
    res = []
    for b, dev in enumerate(mesh.devices):
        cx, cy = mesh.coords(b)
        c = (cx, cy)[axis] - direction
        dst = None if out is None else out[b]
        if 0 <= c < n:
            src = parts[mesh.brick(c, cy) if axis == 0 else mesh.brick(cx, c)]
            if dst is None:
                dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
            dst.copy_(src)
        elif dst is None:
            dst = torch.zeros(parts[b].shape, dtype=parts[b].dtype, device=dev)
        else:
            dst.zero_()
        res.append(dst)
    return res


def halo_pad(bricks: Sequence[torch.Tensor], h: int,
             mesh: Mesh) -> List[torch.Tensor]:
    """Pad every ``(…, bx, by, Z)`` brick with depth-``h`` halos in X and Y.

    X first, then Y from the x-extended rows, so corner cells arrive from
    the diagonal neighbour in two hops — bitwise the reference's
    ``halo_pad``.  Edge bricks receive zeros in the out-of-domain halo.
    Leading (member) axes pass through.
    """
    if h == 0:
        return list(bricks)
    ax_x, ax_y = mesh.axis_names
    lo_x = _ppermute_shift([t[..., -h:, :, :] for t in bricks], mesh, ax_x, +1)
    hi_x = _ppermute_shift([t[..., :h, :, :] for t in bricks], mesh, ax_x, -1)
    xs = [torch.cat([lo, t, hi], dim=-3)
          for lo, t, hi in zip(lo_x, bricks, hi_x)]
    lo_y = _ppermute_shift([t[..., -h:, :] for t in xs], mesh, ax_y, +1)
    hi_y = _ppermute_shift([t[..., :h, :] for t in xs], mesh, ax_y, -1)
    return [torch.cat([lo, t, hi], dim=-2) for lo, t, hi in zip(lo_y, xs, hi_y)]


def _extent(resident: torch.Tensor, margin: int) -> Tuple[int, int]:
    return (resident.shape[-3] - 2 * margin, resident.shape[-2] - 2 * margin)


def exchange_slabs(resident: Sequence[torch.Tensor], margin: int, h: int,
                   mesh: Mesh,
                   out: Optional[Sequence[Dict[str, torch.Tensor]]] = None
                   ) -> List[Dict[str, torch.Tensor]]:
    """Exchange the depth-``h`` margin slabs of halo-resident bricks into
    *separate* tensors: per brick, ``{"lo_x", "hi_x", "lo_y", "hi_y"}``
    shaped as :func:`repro_torch.engine.layout.slab_rects` lays them out.

    ``resident[b]`` is a ``(…, bx + 2·margin, by + 2·margin, Z)`` buffer
    whose interior holds brick ``b``; it is only read.  Two transfers for
    X; each Y slab's sender contributes its x-extended rows (its own edge
    rows flanked by the corner pieces of the X slabs it received), three
    transfers per Y slab, exactly like :func:`halo_pad`'s second
    concatenation, so the slabs are bitwise what :func:`halo_pad` builds,
    zero fill on domain-edge bricks included.  The slabs land in ``out``
    (one dict of buffers per brick, on the receivers' devices: the overlap
    step holds them) or in fresh tensors.
    :func:`repro_torch.engine.layout.land_slabs` stores them.  Leading
    (member) axes travel whole.
    """
    from repro_torch.engine.layout import slab_buffers

    K = margin
    bx, by = _extent(resident[0], K)
    ax_x, ax_y = mesh.axis_names
    if out is None:
        out = [slab_buffers(t, bx, by, h) for t in resident]
    lo_x = _ppermute_shift([t[..., K + bx - h:K + bx, K:K + by, :]
                            for t in resident], mesh, ax_x, +1,
                           out=[o["lo_x"] for o in out])
    hi_x = _ppermute_shift([t[..., K:K + h, K:K + by, :] for t in resident],
                           mesh, ax_x, -1, out=[o["hi_x"] for o in out])
    for name, y0, direction in (("lo_y", by - h, +1), ("hi_y", 0, -1)):
        pieces = (((0, h), [s[..., :, y0:y0 + h, :] for s in lo_x]),
                  ((h, h + bx), [t[..., K:K + bx, K + y0:K + y0 + h, :]
                                 for t in resident]),
                  ((h + bx, bx + 2 * h), [s[..., :, y0:y0 + h, :]
                                          for s in hi_x]))
        for (x0, x1), parts in pieces:
            _ppermute_shift(parts, mesh, ax_y, direction,
                            out=[o[name][..., x0:x1, :, :] for o in out])
    return list(out)


def halo_refresh(resident: Sequence[torch.Tensor], margin: int, h: int,
                 mesh: Mesh) -> List[torch.Tensor]:
    """Refresh the depth-``h`` margins of halo-resident bricks in place.

    The same four transfers as :func:`exchange_slabs`, each copied straight
    into the receivers' margin (``_ppermute_shift(out=…)``): the X slabs
    land first, then the Y slabs read their sources from the senders' own
    x-extended rows, which now hold the corner pieces.  Out-of-domain
    margins are zero-filled.  The margins end bitwise equal to
    :func:`halo_pad`'s; interiors are untouched and nothing is allocated.
    Needs ``h <= margin`` and ``h`` at most the brick's extent.  Returns
    the buffers.
    """
    if h == 0:
        return list(resident)
    from repro_torch.engine.layout import slab_views

    K = margin
    bx, by = _extent(resident[0], K)
    ax_x, ax_y = mesh.axis_names
    views = [slab_views(t, K, h) for t in resident]
    _ppermute_shift([t[..., K + bx - h:K + bx, K:K + by, :] for t in resident],
                    mesh, ax_x, +1, out=[v["lo_x"] for v in views])
    _ppermute_shift([t[..., K:K + h, K:K + by, :] for t in resident],
                    mesh, ax_x, -1, out=[v["hi_x"] for v in views])
    _ppermute_shift([t[..., K - h:K + bx + h, K + by - h:K + by, :]
                     for t in resident], mesh, ax_y, +1,
                    out=[v["lo_y"] for v in views])
    _ppermute_shift([t[..., K - h:K + bx + h, K:K + h, :] for t in resident],
                    mesh, ax_y, -1, out=[v["hi_y"] for v in views])
    return list(resident)


def local_moat_mask(bx: int, by: int, coords: Tuple[int, int], mx: int,
                    my: int, device, h: int = 0) -> torch.Tensor:
    """``(bx + 2h, by + 2h, 1)`` mask of brick ``coords`` padded by ``h``,
    False on the cells of the global domain's x/y faces (the Moat)."""
    cx, cy = coords
    return moat_mask(cx * bx - h, cy * by - h, bx + 2 * h, by + 2 * h,
                     mx * bx, my * by, device)


def evaluate_padded(expr: st.StencilExpr, env_padded: Dict[str, torch.Tensor],
                    target_z: slice, h: int, bx: int, by: int):
    """Evaluate a stencil expression on one brick's depth-``h`` halo-padded
    fields (``(…, bx + 2h, by + 2h, Z)``); returns the ``(…, bx, by, z)``
    value over the target z slice."""
    if isinstance(expr, st.Const):
        return expr.value
    if isinstance(expr, st.Term):
        a = env_padded[expr.field_name]
        x0 = h + expr.dx
        y0 = h + expr.dy
        return a[..., x0:x0 + bx, y0:y0 + by, expr.zslice_obj()]
    if isinstance(expr, st.BinOp):
        lhs = evaluate_padded(expr.lhs, env_padded, target_z, h, bx, by)
        rhs = evaluate_padded(expr.rhs, env_padded, target_z, h, bx, by)
        return st._BINOPS[expr.op](lhs, rhs)
    raise TypeError(type(expr))


def interp_step_sharded(ops, mesh: Mesh):
    """Roll-interpreter step for one op group on the bricks of ``mesh``.

    ``step(env) -> env`` over name -> x-major list of bricks: one halo
    exchange and padded evaluation per op, the Moat from mesh coordinates.
    The engine hands this out (via ``compile_body``) as the sharded ``jit``
    backend and the sharded interpreter fallback, so the two cannot
    diverge.  Leading (member) axes pass through.
    """
    mx, my = mesh.dims
    masks: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def mask(b: int, bx: int, by: int, device) -> torch.Tensor:
        if (b, bx, by) not in masks:
            masks[b, bx, by] = local_moat_mask(bx, by, mesh.coords(b), mx, my,
                                               device)
        return masks[b, bx, by]

    def step(env):
        env = dict(env)
        for op in ops:
            h = max(1, op.expr.max_offset())
            names = {t.field_name for t in op.expr.terms()}
            padded = {n: halo_pad(env[n], h, mesh) for n in names}
            new = []
            for b, f in enumerate(env[op.field_name]):
                bx, by = f.shape[-3], f.shape[-2]
                val = evaluate_padded(op.expr, {n: p[b] for n, p in
                                                padded.items()},
                                      op.target_z, h, bx, by)
                g = f.clone()
                g[..., op.target_z] = torch.where(mask(b, bx, by, f.device),
                                                  val, f[..., op.target_z])
                new.append(g)
            env[op.field_name] = new
        return env

    return step


def default_mesh2d(device="cuda") -> Mesh:
    """Largest 2-D mesh over the available devices (rows ~ sqrt): one brick
    per card, or one brick on the CPU."""
    from repro_torch.engine.plan import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    mx = int(np.sqrt(n))
    while n % mx:
        mx -= 1
    return make_mesh((mx, n // mx), ("data", "model"), device=devices)


def run_sharded(program, env: Dict[str, np.ndarray], mesh=None,
                use_pallas=None, time_tile=None, resident=None, *,
                options=None) -> Dict[str, np.ndarray]:
    """Execute a recorded WFA program on a brick mesh.

    A thin wrapper over the engine: plans the program for the ``pallas``
    backend (``use_pallas=True``: K1 per brick, ``time_tile=k`` amortizing
    one depth-``k·h`` exchange over k steps, halo-resident bricks unless
    ``resident=False``) or the ``jit`` backend (the roll interpreter on
    halo-padded bricks) and executes it on every brick of ``mesh``.
    ``env`` maps field names to global ``(X, Y, Z)`` arrays; the returned
    env holds the final values, gathered back to host NumPy.  With
    ``mesh=None`` it is ``options.mesh``, else the default mesh over the
    devices of ``options.device`` (one brick on the CPU).

    >>> import numpy as np
    >>> from repro_torch.core import Field, ForLoop, WFAInterface
    >>> from repro_torch.engine import RunOptions
    >>> with WFAInterface() as wse:
    ...     T = Field("T", init_data=np.full((8, 8, 4), 2.0, np.float32))
    ...     with ForLoop("time_loop", 2):
    ...         T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
    >>> mesh = make_mesh((2, 2), device="cpu")
    >>> out = run_sharded(wse.program, {"T": T.init_data}, mesh,
    ...                   options=RunOptions(device="cpu"))
    >>> float(out["T"][3, 3, 1])
    0.5

    The legacy ``use_pallas=`` / ``time_tile=`` / ``resident=`` keywords
    warn once and forward into ``options`` (``use_pallas=True`` maps to
    ``backend="pallas"``).
    """
    from repro_torch.engine import execute, plan
    from repro_torch.engine.options import UNSET, _warn_once, resolve_options

    options = resolve_options(
        options, "run_sharded",
        time_tile=UNSET if time_tile is None else time_tile,
        resident=UNSET if resident is None else resident)
    if use_pallas is not None:
        _warn_once("run_sharded", "use_pallas", "backend='pallas'")
        options = options.replace(backend="pallas" if use_pallas else "jit")
    if mesh is None:
        mesh = (options.mesh if options.mesh is not None
                else default_mesh2d(options.device))
    options = options.replace(backend=options.resolved_backend("jit"),
                              mesh=mesh)
    return execute(plan(program, options), env)
