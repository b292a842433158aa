"""Explicit FTCS heat-equation solver (paper Eq. 2) — the legacy functional
API, ported from ``repro/core/explicit.py``.

Three tiers, all computing the same update:

* :func:`ftcs_step` / :func:`ftcs_solve` — one device, whole grid;
* :func:`make_sharded_ftcs` — the brick-decomposed solver over a
  :class:`repro_torch.core.mesh.Mesh` with halo exchange; ``halo_depth=k``
  exchanges a depth-k halo once per k local steps; ``overlap=True`` takes
  the plain step, since one process on one stream has no exchange to hide
  (the engine's split, ``RunOptions(overlap=True)``, is the port's overlap);
* ``use_kernel=True`` steps each padded brick with the hand-written kernel
  K6, ``use_kernel="planes"`` each unpadded brick and its received halo
  planes with K7 (:mod:`repro_torch.kernels.ops`).

The brick steps and both kernels sum the neighbours as
``c_diag·c + c_off·(((((x₋ + x₊) + y₋) + y₊) + z₊) + z₋)``, so every
``make_sharded_ftcs`` variant, and every mesh shape, gives the same bits.
:func:`ftcs_solve` sums ``s + (z₋ + z₊)`` instead, as the reference does,
and differs from them by rounding.  Each ``lax.fori_loop`` of the reference
is a Python loop; fields are torch tensors on any device, and every step
writes fresh tensors.

:func:`ftcs_solve_checkpointed` runs the same step as :func:`ftcs_solve`
in ``torch.utils.checkpoint`` chunks, for reverse-mode AD in O(√n) saved
states.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.halo import _ppermute_shift, halo_pad, local_moat_mask
from repro_torch.core.mesh import BrickArray, Mesh, NamedSharding
from repro_torch.kernels.stencil7 import coef, neighbor_sum

__all__ = ["ftcs_solve", "ftcs_solve_checkpointed", "ftcs_solve_repack",
           "ftcs_step", "interior_mask3d", "make_sharded_ftcs",
           "neighbor_sum_padded"]


# ---------------------------------------------------------------------------
# single-device reference
# ---------------------------------------------------------------------------

def interior_mask3d(shape, device="cuda") -> torch.Tensor:
    """Bool mask of ``shape``, True off all six faces."""
    from repro_torch.engine.plan import resolve_device

    m = torch.zeros(tuple(shape), dtype=torch.bool, device=resolve_device(device))
    m[1:-1, 1:-1, 1:-1] = True
    return m


#: 6-neighbour sum from a halo-padded ``(bx+2, by+2, Z)`` brick →
#: ``(bx, by, Z)``, z neighbours edge-replicated (the kernels' own order)
neighbor_sum_padded = neighbor_sum


def _pad_xy(T: torch.Tensor, h: int = 1) -> torch.Tensor:
    """Zero halo of depth ``h`` in X and Y (``jnp.pad``)."""
    return F.pad(T, (0, 0, h, h, h, h))


def ftcs_step(T: torch.Tensor, w: float, mask=None) -> torch.Tensor:
    """One FTCS step on the full ``(X, Y, Z)`` grid; boundaries stay fixed."""
    if mask is None:
        mask = interior_mask3d(T.shape, T.device)
    new = coef(1.0 - 6.0 * w, T.dtype) * T \
        + coef(w, T.dtype) * neighbor_sum_padded(_pad_xy(T))
    return torch.where(mask, new, T)


def ftcs_solve_repack(T0: torch.Tensor, w: float, steps: int) -> torch.Tensor:
    """The pre-residency stepping: one full-grid zero pad and two z-shift
    copies per step (:func:`ftcs_step` in a loop)."""
    mask = interior_mask3d(T0.shape, T0.device)
    T = T0
    for _ in range(steps):
        T = ftcs_step(T, w, mask)
    return T


def _ftcs_zero_repack_step(T0: torch.Tensor, w: float):
    """``step(T) -> T`` of :func:`ftcs_solve`'s loop for fields shaped as
    ``T0``: the fixed z faces stay in place, only the inner ``(X, Y, Z−2)``
    slab is padded in X/Y and stepped, the z neighbours are plain
    z-slices, and the X/Y Moat is pinned by a broadcast mask."""
    nx, ny, _ = T0.shape
    dev = T0.device
    row = torch.arange(nx, device=dev)[:, None, None]
    col = torch.arange(ny, device=dev)[None, :, None]
    mask_xy = (row > 0) & (row < nx - 1) & (col > 0) & (col < ny - 1)
    a, b = coef(1.0 - 6.0 * w, T0.dtype), coef(w, T0.dtype)

    def step(T):
        Ti = T[:, :, 1:-1]
        P = _pad_xy(Ti)
        s = P[:-2, 1:-1, :] + P[2:, 1:-1, :] + P[1:-1, :-2, :] + P[1:-1, 2:, :]
        zsum = T[:, :, :-2] + T[:, :, 2:]
        new = torch.where(mask_xy, a * Ti + b * (s + zsum), Ti)
        return torch.cat([T[:, :, :1], new, T[:, :, -1:]], dim=2)

    return step


def ftcs_solve(T0: torch.Tensor, w: float, steps: int) -> torch.Tensor:
    """FTCS time loop with zero-repack stepping (the same update as
    :func:`ftcs_step`, to rounding): the fixed z faces stay in place, only
    the inner ``(X, Y, Z−2)`` slab is padded in X/Y and stepped, the z
    neighbours are plain z-slices, and the X/Y Moat is pinned by a
    broadcast mask."""
    if T0.shape[2] < 3:
        return T0  # no interior z plane: every cell is boundary-pinned
    step = _ftcs_zero_repack_step(T0, w)
    T = T0
    for _ in range(steps):
        T = step(T)
    return T


def ftcs_solve_checkpointed(T0, w: float, steps: int, chunk: int = 0):
    """:func:`ftcs_solve` with a checkpointed reverse sweep.

    The same forward values (the step body is shared), structured for
    ``torch.autograd``: the time loop runs in chunks of ``chunk`` steps
    (default ``⌈√steps⌉``), each rematerialized by
    ``torch.utils.checkpoint`` in the reverse pass, so the pass stores one
    state per chunk and recomputes inside — O(√n) saved states instead of
    the O(n) a plain differentiable loop keeps, at one extra forward pass
    of compute.  The remainder ``steps % chunk`` runs after the chunks.
    """
    from torch.utils.checkpoint import checkpoint

    if T0.shape[2] < 3 or steps <= 0:
        return T0
    if chunk <= 0:
        chunk = max(1, int(np.ceil(np.sqrt(steps))))
    step = _ftcs_zero_repack_step(T0, w)

    def run(T, n):
        for _ in range(n):
            T = step(T)
        return T

    n_chunks, rem = divmod(steps, chunk)
    T = T0
    for _ in range(n_chunks):
        T = checkpoint(run, T, chunk, use_reentrant=False,
                       preserve_rng_state=False)
    return run(T, rem)


# ---------------------------------------------------------------------------
# distributed bricks (lists of bricks, x-major, stepped in lock step)
# ---------------------------------------------------------------------------

def _fix_z_boundary(new: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``new`` with ``T``'s two z faces."""
    return torch.cat([T[:, :, :1], new[:, :, 1:-1], T[:, :, -1:]], dim=2)


def _update(T, s, w):
    """``(1 − 6ω)·T + ω·s`` with the coefficients in ``T``'s dtype."""
    return coef(1.0 - 6.0 * w, T.dtype) * T + coef(w, T.dtype) * s


def ftcs_brick_step(bricks: Sequence[torch.Tensor], w: float, masks,
                    mesh: Mesh) -> List[torch.Tensor]:
    """Plain halo-exchange step on every brick (the paper's schedule)."""
    P = halo_pad(bricks, 1, mesh)
    return [_fix_z_boundary(torch.where(m, _update(T, neighbor_sum_padded(p), w),
                                        T), T)
            for T, p, m in zip(bricks, P, masks)]


def ftcs_brick_step_wide(bricks: Sequence[torch.Tensor], w: float, k: int,
                         masks, mesh: Mesh) -> List[torch.Tensor]:
    """Communication-avoiding: one depth-``k`` exchange, ``k`` local steps.

    After local step j the padded cells at distance ≥ j from the padded
    edge are exact, so the central brick is exact after k steps; the
    padded Moat mask (``masks``) pins the domain's faces, so out-of-domain
    halo values never reach an interior cell.
    """
    out = []
    for P in halo_pad(bricks, k, mesh):
        m = masks[len(out)]
        for _ in range(k):
            new = _update(P, neighbor_sum_padded(_pad_xy(P)), w)
            P = _fix_z_boundary(torch.where(m, new, P), P)
        out.append(P[k:-k, k:-k, :])
    return out


def make_sharded_ftcs(mesh: Mesh, shape, w: float, *, overlap: bool = False,
                      halo_depth: int = 1, use_kernel=False,
                      steps_per_call: int = 1):
    """Build a brick-decomposed FTCS stepper over ``mesh``.

    Returns ``(step_fn, sharding)``; ``step_fn(T)`` advances
    ``steps_per_call`` (× ``halo_depth``) time steps of the field ``T`` (a
    :class:`~repro_torch.core.mesh.BrickArray` of ``sharding``, or a global
    tensor or array, which is cut into bricks first) and returns a fresh
    BrickArray.  The variant: ``halo_depth > 1`` wins, then
    ``use_kernel="planes"`` (K7: unpadded brick + halo planes, Moat in the
    kernel), then ``use_kernel=True`` (K6 on the padded brick); else, with
    ``overlap`` or without, the plain step.  All give the same bits.
    """
    ax_x, ax_y = mesh.axis_names[-2], mesh.axis_names[-1]
    mx, my = mesh.shape[ax_x], mesh.shape[ax_y]
    nx, ny, nz = shape
    assert nx % mx == 0 and ny % my == 0, (shape, mesh.shape)
    bx, by = nx // mx, ny // my
    sharding = NamedSharding(mesh, (ax_x, ax_y, None))
    h = halo_depth if halo_depth > 1 else 0  # the wide step masks padded bricks
    masks = [local_moat_mask(bx, by, mesh.coords(b), mx, my, d, h)
             for b, d in enumerate(mesh.devices)]
    from repro_torch.kernels import ops as kops

    def planes_step(bricks):
        xlo = _ppermute_shift([T[-1:] for T in bricks], mesh, ax_x, +1)
        xhi = _ppermute_shift([T[:1] for T in bricks], mesh, ax_x, -1)
        ylo = _ppermute_shift([T[:, -1:] for T in bricks], mesh, ax_y, +1)
        yhi = _ppermute_shift([T[:, :1] for T in bricks], mesh, ax_y, -1)
        return [kops.stencil7_planes(T, xlo[b], xhi[b], ylo[b], yhi[b],
                                     mesh.coords(b), 1.0 - 6.0 * w, w, nx, ny)
                for b, T in enumerate(bricks)]

    def kernel_step(bricks):
        P = halo_pad(bricks, 1, mesh)
        return [_fix_z_boundary(torch.where(m, kops.stencil7(p, 1.0 - 6.0 * w, w),
                                            T), T)
                for T, p, m in zip(bricks, P, masks)]

    if halo_depth > 1:
        body = lambda b: ftcs_brick_step_wide(b, w, halo_depth, masks, mesh)  # noqa: E731
    elif use_kernel == "planes":
        body = planes_step
    elif use_kernel:
        body = kernel_step
    else:  # overlap too: one process on one stream has nothing to overlap
        body = lambda b: ftcs_brick_step(b, w, masks, mesh)  # noqa: E731

    def step(T):
        if not isinstance(T, BrickArray):
            T = sharding.shard(T)
        if T.shape != (nx, ny, nz) or T.mesh is not mesh:
            raise ValueError(f"step_fn built for {(nx, ny, nz)} on {mesh}; got "
                             f"{T.shape} on {T.mesh}")
        bricks = list(T.bricks)
        for _ in range(steps_per_call):
            bricks = body(bricks)
        return BrickArray(bricks, sharding)

    return step, sharding
