"""Bricks and their halo exchange — the part of ``repro/core/halo.py`` that
the legacy brick drivers (:mod:`repro_torch.core.explicit`,
:mod:`repro_torch.core.implicit`) need.

A brick function of the reference runs once per device under ``shard_map``
and exchanges planes with ``lax.ppermute``.  Here one process holds every
brick (:mod:`repro_torch.core.mesh`), so each function takes the list of
bricks, x-major, and returns a list: every brick's outgoing planes are cut
before any brick is updated, and the exchange hands over copies, so the
bricks move in lock step as they do under ``shard_map``.

The sharding slice brings ``exchange_slabs``, ``halo_refresh``,
``evaluate_padded``, ``interp_step_sharded`` and ``run_sharded``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.kernels.stencil7 import moat_mask


def _ppermute_shift(parts: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
                    direction: int) -> List[torch.Tensor]:
    """What each brick receives from its neighbour along ``axis_name``:
    ``direction=+1`` from the lower index, ``-1`` from the higher one.

    ``parts[b]`` is what brick ``b`` sends.  The permutation is not cyclic
    (the reference's ``[(i, i+1)]``): a brick on the domain's edge receives
    zeros, and a 1-brick axis receives zeros only.  Each received part is a
    fresh contiguous copy on the receiver's device.  This is the only place
    bricks exchange planes: multi-card transport plugs in here.
    """
    axis = mesh.axis_names.index(axis_name)
    n = mesh.dims[axis]
    out = []
    for b, dev in enumerate(mesh.devices):
        cx, cy = mesh.coords(b)
        c = (cx, cy)[axis] - direction
        if 0 <= c < n:
            src = parts[mesh.brick(c, cy) if axis == 0 else mesh.brick(cx, c)]
            buf = torch.empty(src.shape, dtype=src.dtype, device=dev)
            buf.copy_(src)
        else:
            buf = torch.zeros(parts[b].shape, dtype=parts[b].dtype, device=dev)
        out.append(buf)
    return out


def halo_pad(bricks: Sequence[torch.Tensor], h: int,
             mesh: Mesh) -> List[torch.Tensor]:
    """Pad every ``(bx, by, Z)`` brick with depth-``h`` halos in X and Y.

    X first, then Y from the x-extended rows, so corner cells arrive from
    the diagonal neighbour in two hops — bitwise the reference's
    ``halo_pad``.  Edge bricks receive zeros in the out-of-domain halo.
    """
    if h == 0:
        return list(bricks)
    ax_x, ax_y = mesh.axis_names
    lo_x = _ppermute_shift([t[-h:] for t in bricks], mesh, ax_x, +1)
    hi_x = _ppermute_shift([t[:h] for t in bricks], mesh, ax_x, -1)
    xs = [torch.cat([lo, t, hi], dim=0) for lo, t, hi in zip(lo_x, bricks, hi_x)]
    lo_y = _ppermute_shift([t[:, -h:] for t in xs], mesh, ax_y, +1)
    hi_y = _ppermute_shift([t[:, :h] for t in xs], mesh, ax_y, -1)
    return [torch.cat([lo, t, hi], dim=1) for lo, t, hi in zip(lo_y, xs, hi_y)]


def local_moat_mask(bx: int, by: int, coords: Tuple[int, int], mx: int,
                    my: int, device, h: int = 0) -> torch.Tensor:
    """``(bx + 2h, by + 2h, 1)`` mask of brick ``coords`` padded by ``h``,
    False on the cells of the global domain's x/y faces (the Moat)."""
    cx, cy = coords
    return moat_mask(cx * bx - h, cy * by - h, bx + 2 * h, by + 2 * h,
                     mx * bx, my * by, device)


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
