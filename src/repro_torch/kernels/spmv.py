"""K5 — the fused BTCS SpMV and partial dot product, on Hopper.

The port of ``repro/kernels/spmv.py::spmv_dot``: over a halo-padded
``(bx+2, by+2, Z)`` brick ``P`` of the search vector,
``Ap = c_diag·c + c_off·Σ6`` (K6's stencil, z neighbours edge-replicated)
and, in the same pass, the brick's ``Σ c·Ap`` over the *unmasked* ``Ap`` —
Moat and z faces included, as the reference computes it before
``make_sharded_iteration`` masks ``Ap``.

* :func:`spmv_launch_shape` is the one owner of the kernel's launch shape:
  a block of 32 z lanes × :data:`TY` y rows owns a tile of ``TY`` rows,
  :data:`ZC` z and ``xc`` consecutive x planes, which it marches along x;
  it writes one partial per tile;
* :func:`launch_spmv_dot` launches ``spmv_dot_march_kernel``
  (``csrc/stencil7.cu``) on a CUDA tensor with that shape and returns
  ``(Ap, partials)``; it counts its launches in
  ``launch_spmv_dot.launches``;
* :func:`spmv_dot_ref` is the plain PyTorch version: ``Ap`` from
  :func:`repro_torch.kernels.stencil7.affine_stencil_ref` (bit for bit the
  kernel's) and the dot from one ``torch.sum``;
  :func:`spmv_dot_tiles_ref` gives the per-tile partials in the kernel's
  tile order (for the tests and the card checks; no card path uses it);
* :func:`repro_torch.kernels.ops.spmv_hex_dot` picks between kernel and
  plain version by the tensor's device and sums the kernel's partials with
  one ``torch.sum``.

The dot accumulates in ``promote(dtype, float32)`` (the reference's TPU
kernel and its oracle always used float32); the kernel sums in another
order than ``torch.sum``, so the dots agree to rounding, and the kernel is
deterministic (no atomics).

Bound on the card: bytes (the padded brick read once, ``Ap`` written once).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.dotprod import acc_dtype
from repro_torch.kernels.stencil7 import (  # noqa: F401 (CELLS)
    CELLS, MAX_GRID, MAX_GRID_X, TY, ZC, affine_stencil_ref, check_operand,
    library, raise_on_error)

#: at most this many x planes per block: a thread's serial chain of
#: products stays at ≤ XC_MAX·CELLS = 128
XC_MAX = 32
#: 4 blocks on each of the H100's 132 SMs: ``xc`` shrinks until a grid
#: holds at least this many blocks, where the brick allows
TARGET_BLOCKS = 4 * 132
#: the most cells a padded (by+2, Z) plane may hold (the kernel keeps
#: in-plane offsets in an int)
MAX_PLANE = 2 ** 31 - 1


class SpmvShape(NamedTuple):
    """One K5 launch: ``grid = (y tiles, x tiles, z chunks)``, ``block =
    (32, TY)``, ``xc`` x planes per tile, and ``partials`` (one per block;
    the partial of tile (y, x, z) at ``(z·x tiles + x)·y tiles + y``)."""

    grid: Tuple[int, int, int]
    block: Tuple[int, int]
    ty: int
    xc: int
    zc: int
    partials: int


def spmv_launch_shape(bx: int, by: int, nz: int) -> SpmvShape:
    """The launch shape of K5 on a ``(bx, by, nz)`` brick.

    ``xc = ⌊bx · y tiles · z chunks / TARGET_BLOCKS⌋`` clamped to
    ``[1, XC_MAX]``, then evened out over its ``⌈bx / xc⌉`` x tiles: at
    least :data:`TARGET_BLOCKS` blocks where the brick has that many
    columns × planes, and at most 128 products per thread.  Raises
    ``ValueError`` for an empty brick, a grid over CUDA's limits or a
    padded plane over :data:`MAX_PLANE` cells.
    """
    if min(bx, by, nz) < 1:
        raise ValueError(f"spmv_dot of an empty brick ({bx}, {by}, {nz})")
    y_tiles, z_tiles = -(-by // TY), -(-nz // ZC)
    xc = max(1, min(XC_MAX, bx * y_tiles * z_tiles // TARGET_BLOCKS))
    x_tiles = -(-bx // xc)
    xc = -(-bx // x_tiles)
    if (x_tiles > MAX_GRID or z_tiles > MAX_GRID or y_tiles > MAX_GRID_X
            or (by + 2) * nz > MAX_PLANE):
        raise ValueError(f"spmv_dot: brick ({bx}, {by}, {nz}) exceeds the "
                         "launch grid")
    return SpmvShape((y_tiles, x_tiles, z_tiles), (32, TY), TY, xc, ZC,
                     y_tiles * x_tiles * z_tiles)


def tile_sums(values: torch.Tensor, shape: SpmvShape) -> torch.Tensor:
    """Sum a ``(bx, by, Z)`` tensor over each tile of ``shape``, in the
    kernel's partial order: a ``(shape.partials,)`` tensor of its dtype."""
    bx, by, nz = values.shape
    y_t, x_t, z_t = shape.grid
    padded = values.new_zeros((x_t * shape.xc, y_t * shape.ty, z_t * shape.zc))
    padded[:bx, :by, :nz] = values
    tiles = padded.reshape(x_t, shape.xc, y_t, shape.ty, z_t, shape.zc)
    return tiles.sum(dim=(1, 3, 5)).permute(2, 0, 1).reshape(-1)


def spmv_dot_ref(P: torch.Tensor, c_diag: float, c_off: float):
    """Plain K5: ``(Ap, Σ c·Ap)`` with the dot a 0-d tensor in the
    accumulation dtype."""
    av = affine_stencil_ref(P, c_diag, c_off)
    c = P[1:-1, 1:-1, :]
    return av, torch.sum(c * av, dtype=acc_dtype(P.dtype))


def spmv_dot_tiles_ref(P: torch.Tensor, c_diag: float, c_off: float,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain K5's partials: ``Σ c·Ap`` over each tile of
    :func:`spmv_launch_shape`, in the kernel's order, ``Ap`` as
    :func:`spmv_dot_ref` computes it and the products and sums in ``dtype``
    (default: the accumulation dtype)."""
    av = affine_stencil_ref(P, c_diag, c_off)
    acc = dtype or acc_dtype(P.dtype)
    prod = P[1:-1, 1:-1, :].to(acc) * av.to(acc)
    return tile_sums(prod, spmv_launch_shape(*av.shape))


def launch_spmv_dot(P: torch.Tensor, c_diag: float, c_off: float):
    """Launch K5 on the CUDA padded brick ``P``; returns the fresh
    ``(bx, by, Z)`` ``Ap`` and the ``(partials,)`` tile sums of ``Σ c·Ap``
    in the accumulation dtype.  Checks device, dtype, rank and contiguity;
    does not synchronise."""
    if P.ndim != 3:
        raise ValueError(f"spmv_dot input must be 3-D, got {tuple(P.shape)}")
    check_operand(P, P.shape, "spmv_dot")
    bx, by, nz = P.shape[0] - 2, P.shape[1] - 2, P.shape[2]
    shape = spmv_launch_shape(bx, by, nz)
    lib = library()
    out = torch.empty((bx, by, nz), dtype=P.dtype, device=P.device)
    partials = torch.empty((shape.partials,), dtype=acc_dtype(P.dtype),
                           device=P.device)
    fn = lib.spmv_dot_f32 if P.dtype == torch.float32 else lib.spmv_dot_f64
    rc = fn(P.data_ptr(), out.data_ptr(), partials.data_ptr(), bx, by, nz,
            *shape.grid, *shape.block, shape.xc, shape.partials, c_diag, c_off,
            P.device.index, torch.cuda.current_stream(P.device).cuda_stream)
    raise_on_error(lib, rc, "spmv_dot")
    launch_spmv_dot.launches += 1
    return out, partials


launch_spmv_dot.launches = 0
