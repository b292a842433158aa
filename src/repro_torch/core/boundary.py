"""Boundary handling — the "Moat" of the WFA.

Boundary cells live inside the global array; updates write only interior
cells (the mask below), so Dirichlet values persist by construction —
exactly Eq. 2's ``T_C^{n+1} = T_C^n = γ  ∀ C ∈ bc``.

Masks are built once per shape (and, for torch, per device) and cached.
The per-brick mask of distributed mode comes with the sharding slice.
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
