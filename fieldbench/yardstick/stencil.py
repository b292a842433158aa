"""Operations and bytes of stencil and grid-transfer work, from shapes.

A body is a list of ``(coefficient, taps)`` groups plus a constant, as the
recorded update ``T = Σ_g coeff_g · Σ taps_g (+ const)`` reads; its count
is the one a plain evaluation needs per updated cell: the adds inside each
group, one multiply per coefficient other than 1, the adds between groups
and the constant's add.  Bytes count each input byte read once and each
output byte written once.
"""
from __future__ import annotations

from typing import Sequence, Tuple

ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


def body_ops(groups: Sequence[Tuple[float, int]], const: float = 0.0) -> int:
    """Floating-point operations per updated cell of one body application."""
    per = 0
    for coeff, taps in groups:
        per += taps - 1 + (coeff != 1.0)
    per += max(len(groups) - 1, 0) + (const != 0.0 and bool(groups))
    return per


def interior_cells(shape: Sequence[int]) -> int:
    """Cells a body writes: the grid without its one-cell Moat and without
    the first and last z plane."""
    nx, ny, nz = shape
    return (nx - 2) * (ny - 2) * (nz - 2)


def apply_flops(shape: Sequence[int], groups, const: float = 0.0) -> int:
    """Operations of one application of a body to the grid."""
    return interior_cells(shape) * body_ops(groups, const)


def apply_bytes(shape: Sequence[int], dtype: str, halo: int = 1) -> int:
    """Bytes of one application of a halo-``halo`` body to one field: the
    field with its periodic x/y pad read once, the field written once
    (269.5 MB at 512×512×128 float32)."""
    nx, ny, nz = shape
    s = ITEMSIZE[dtype]
    return (nx + 2 * halo) * (ny + 2 * halo) * nz * s + nx * ny * nz * s


def coarse_shape(shape: Sequence[int]) -> Tuple[int, int, int]:
    """The next-coarser level: coarse cell I on fine cell 2I."""
    return tuple(int(n) // 2 + 1 for n in shape)


def transfer_bytes(fine: Sequence[int], dtype: str) -> int:
    """Bytes of one restriction or prolongation between ``fine`` and its
    coarse level: one level read once, the other written once (151.4 MB at
    512×512×128 float32)."""
    s = ITEMSIZE[dtype]
    nx, ny, nz = fine
    cx, cy, cz = coarse_shape(fine)
    return (nx * ny * nz + cx * cy * cz) * s
