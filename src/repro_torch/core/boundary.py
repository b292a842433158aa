"""Boundary handling — the "Moat" of the WFA.

Boundary cells live inside the global array; updates write only interior
cells (the mask below), so Dirichlet values persist by construction —
exactly Eq. 2's ``T_C^{n+1} = T_C^n = γ  ∀ C ∈ bc``.

Masks are built once per shape (and, for torch, per device) and cached;
in distributed mode each brick derives its *local* mask from its mesh
coordinates (only bricks on the domain edge own Moat cells).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interior_mask_np(nx: int, ny: int) -> np.ndarray:
    m = np.zeros((nx, ny, 1), dtype=bool)
    m[1:-1, 1:-1, :] = True
    return m


@functools.lru_cache(maxsize=None)
def _interior_mask_torch(nx: int, ny: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_interior_mask_np(nx, ny)).to(device)


def interior_mask(shape_xy, xp, device=None):
    """(X, Y, 1) bool mask: True on cells whose x/y are interior.

    Z interiority is expressed by the update's target z-slice itself, so the
    mask only handles the X/Y Moat.  ``xp`` is numpy or torch; the torch
    mask lives on ``device``.
    """
    nx, ny = shape_xy
    if xp is np:
        return _interior_mask_np(nx, ny)
    return _interior_mask_torch(nx, ny, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _local_interior_mask_np(bx: int, by: int, at_x_lo: bool, at_x_hi: bool,
                            at_y_lo: bool, at_y_hi: bool) -> np.ndarray:
    m = np.ones((bx, by, 1), dtype=bool)
    if at_x_lo:
        m[0, :, :] = False
    if at_x_hi:
        m[-1, :, :] = False
    if at_y_lo:
        m[:, 0, :] = False
    if at_y_hi:
        m[:, -1, :] = False
    return m


def local_interior_mask(brick_xy, coords, mesh_xy, xp, device=None):
    """(bx, by, 1) Moat mask of the brick at mesh ``coords`` of an ``(mx,
    my)`` mesh (distributed mode): False on the cells of the global
    domain's x/y faces.  ``xp`` is numpy or torch; the torch mask lives on
    ``device``."""
    bx, by = brick_xy
    cx, cy = coords
    mx, my = mesh_xy
    m = _local_interior_mask_np(bx, by, cx == 0, cx == mx - 1,
                                cy == 0, cy == my - 1)
    if xp is np:
        return m
    return torch.from_numpy(m).to(torch.device(device or "cpu"))
