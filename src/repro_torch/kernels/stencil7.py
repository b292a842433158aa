"""K6 and K7 — the legacy 7-point stencil kernels, on Hopper (their CUDA
source also holds K5, :mod:`repro_torch.kernels.spmv`).

The port of ``repro/kernels/stencil7.py``:

* K6, ``affine_stencil``: over a halo-padded ``(bx+2, by+2, Z)`` brick,
  ``out = c_diag·c + c_off·(((((x₋ + x₊) + y₋) + y₊) + z₊) + z₋)`` with the
  z neighbours edge-replicated; FTCS with ``(1 − 6ω, ω)``, the BTCS
  operator with ``(1, −ωψ)``;
* K7, ``stencil_planes``: one FTCS step from an *unpadded* ``(bx, by, Z)``
  brick and the four halo planes its neighbours sent, the Dirichlet Moat
  (global x/y faces and the z faces) kept in the kernel.  On the card it
  marches along x on K5's tile (:mod:`repro_torch.kernels.spmv`), and
  :func:`k7_launch_shape` is the one owner of its launch shape.

:func:`affine_stencil_ref` and :func:`stencil_planes_ref` are the plain
PyTorch versions, the reference's ``repro/kernels/ref.py`` oracles with the
same association: the CPU path and the yardstick of the CUDA kernels
(``csrc/stencil7.cu``), which equal them bit for bit.  The coefficients are
rounded to the field's dtype first, as JAX rounds the reference's weakly
typed Python floats.  :func:`launch_stencil7` / :func:`launch_stencil_planes`
count their launches in ``.launches``; :mod:`repro_torch.kernels.ops` picks
kernel or plain version by the tensors' device.  The reference's TPU
``block=`` tile has no counterpart: K6 picks its own, K7 takes
:func:`k7_launch_shape`'s.

Bound on the card: bytes (each input read once, the brick written once).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

#: the dtypes the kernels are built for
DTYPES = (torch.float32, torch.float64)
#: gridDim.y / gridDim.z limit of the launch shapes (see csrc/stencil7.cu)
MAX_GRID = 65535
#: the x-marching tile of K5 and K7 (``kSpmv*`` in csrc/stencil7.cu): a
#: block of 32 z lanes × TY y rows, CELLS z cells per thread 32 apart, so
#: ZC z per block
TY = 8
CELLS = 4
ZC = 32 * CELLS
#: gridDim.x limit
MAX_GRID_X = 2 ** 31 - 1
#: K7's tile depth, x planes per block: the depth that timed fastest, or
#: tied, on both the 1×1 and the 2×2 meshes' bricks of 512×512×128 in a
#: sweep of 1–32 (PERF.md §6).  At 64 registers a thread an SM holds 4
#: blocks (528 on the card); deeper tiles leave the 2×2 brick's grid with
#: fewer blocks than that, or a short last wave
K7_XC = 4
#: the most cells a (by, Z) plane of K7 may hold, a z chunk to spare (the
#: kernel keeps in-plane offsets in an int)
K7_MAX_PLANE = 2 ** 31 - 1 - ZC


def coef(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(float(v), dtype=dtype).item()


def neighbor_sum(P: torch.Tensor) -> torch.Tensor:
    """The 6-neighbour sum over a padded ``(bx+2, by+2, Z)`` brick, z
    neighbours edge-replicated, summed ``x₋ + x₊ + y₋ + y₊ + z₊ + z₋`` left
    to right."""
    c = P[1:-1, 1:-1, :]
    s = P[:-2, 1:-1, :] + P[2:, 1:-1, :] + P[1:-1, :-2, :] + P[1:-1, 2:, :]
    zp = torch.cat([c[:, :, 1:], c[:, :, -1:]], dim=2)
    zm = torch.cat([c[:, :, :1], c[:, :, :-1]], dim=2)
    return s + zp + zm


def affine_stencil_ref(P: torch.Tensor, c_diag: float, c_off: float) -> torch.Tensor:
    """Plain K6: ``c_diag·c + c_off·Σ6`` over the padded brick ``P``."""
    c = P[1:-1, 1:-1, :]
    return coef(c_diag, P.dtype) * c + coef(c_off, P.dtype) * neighbor_sum(P)


def moat_mask(x0: int, y0: int, ex: int, ey: int, nx: int, ny: int,
              device) -> torch.Tensor:
    """``(ex, ey, 1)`` mask of the cells at global ``x0 + i, y0 + j``: False
    on the ``(nx, ny)`` domain's x/y faces (the Moat)."""
    gx = x0 + torch.arange(ex, device=device)[:, None, None]
    gy = y0 + torch.arange(ey, device=device)[None, :, None]
    return (gx > 0) & (gx < nx - 1) & (gy > 0) & (gy < ny - 1)


def interior(bx: int, by: int, nz: int, coords: Sequence[int], nx: int, ny: int,
             device) -> torch.Tensor:
    """``(bx, by, nz)`` mask of brick ``coords``: True off the global x/y
    faces and the z faces."""
    cx, cy = (int(c) for c in coords)
    zi = torch.arange(nz, device=device)
    return moat_mask(cx * bx, cy * by, bx, by, nx, ny, device) & (zi > 0) & (zi < nz - 1)


def stencil_planes_ref(T, xlo, xhi, ylo, yhi, coords, c_diag: float,
                       c_off: float, nx: int, ny: int) -> torch.Tensor:
    """Plain K7, in the reference oracle's padded-assembly form: the planes
    around the brick (zero corners), :func:`affine_stencil_ref`, and the
    old value on the Moat."""
    bx, by, nz = T.shape
    P = torch.cat([xlo, T, xhi], dim=0)
    zero = torch.zeros((1, 1, nz), dtype=T.dtype, device=T.device)
    ylo_p = torch.cat([zero, ylo, zero], dim=0)
    yhi_p = torch.cat([zero, yhi, zero], dim=0)
    P = torch.cat([ylo_p, P, yhi_p], dim=1)
    out = affine_stencil_ref(P, c_diag, c_off)
    return torch.where(interior(bx, by, nz, coords, nx, ny, T.device), out, T)


class K7Shape(NamedTuple):
    """One K7 launch: ``grid = (y tiles, x tiles, z chunks)``, ``block =
    (32, TY)``, and ``xc`` x planes per tile."""

    grid: Tuple[int, int, int]
    block: Tuple[int, int]
    xc: int


def k7_launch_shape(bx: int, by: int, nz: int) -> K7Shape:
    """The launch shape of K7 on a ``(bx, by, nz)`` brick: tiles of
    :data:`TY` rows × :data:`ZC` z × ``xc`` x planes, ``xc`` =
    :data:`K7_XC` evened out over its ``⌈bx / K7_XC⌉`` x tiles.  Raises
    ``ValueError`` for an empty brick, a grid over CUDA's limits or a
    plane over :data:`K7_MAX_PLANE` cells.
    """
    if min(bx, by, nz) < 1:
        raise ValueError(f"stencil_planes of an empty brick ({bx}, {by}, {nz})")
    y_tiles, z_tiles = -(-by // TY), -(-nz // ZC)
    x_tiles = -(-bx // K7_XC)
    xc = -(-bx // x_tiles)
    if (x_tiles > MAX_GRID or z_tiles > MAX_GRID or y_tiles > MAX_GRID_X
            or by * nz > K7_MAX_PLANE):
        raise ValueError(f"stencil_planes: brick ({bx}, {by}, {nz}) exceeds "
                         "the launch grid")
    return K7Shape((y_tiles, x_tiles, z_tiles), (32, TY), xc)


# ---------------------------------------------------------------------------
# the CUDA launchers
# ---------------------------------------------------------------------------

_LIB = None


def library():
    """The built ``stencil7`` library (K5, K6 and K7) with its C signatures
    declared."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library

        lib = load_library("stencil7")
        for fn, real in ((lib.stencil7_f32, ctypes.c_float),
                         (lib.stencil7_f64, ctypes.c_double)):
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
                real, real, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn, real in ((lib.spmv_dot_f32, ctypes.c_float),
                         (lib.spmv_dot_f64, ctypes.c_double)):
            # P, Ap, partials; bx, by, nz; grid, block, xc; n_partials
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
                ctypes.c_longlong, real, real, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn, real in ((lib.stencil_planes_f32, ctypes.c_float),
                         (lib.stencil_planes_f64, ctypes.c_double)):
            # T, xlo, xhi, ylo, yhi, out; bx, by, nz, gx0, gy0, nx, ny;
            # grid, block, xc
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [
                real, real, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.stencil7_error.argtypes = [ctypes.c_int]
        lib.stencil7_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_operand(t: torch.Tensor, shape, what: str, like: torch.Tensor = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA float32/float64 tensor of
    ``shape`` (on ``like``'s device and dtype when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {t.device}")
    if t.dtype not in DTYPES:
        raise ValueError(f"{what} kernel takes {DTYPES}, got {t.dtype}")
    if like is not None and (t.device != like.device or t.dtype != like.dtype):
        raise ValueError(f"{what} operands must share one device and dtype")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} operand has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} operands must be contiguous")


def check_brick(bx: int, by: int, nz: int, what: str) -> None:
    """Raise for an empty brick or one whose K6 launch grid (one block
    of ``min(128, ⌈Z⌉₃₂) × 256/that`` threads per z/y tile, ``bx`` tiles
    deep) the card refuses."""
    if min(bx, by, nz) < 1:
        raise ValueError(f"{what} of an empty brick ({bx}, {by}, {nz})")
    rows = 256 // min(128, -(-nz // 32) * 32)
    if bx > MAX_GRID or -(-by // rows) > MAX_GRID:
        raise ValueError(f"{what}: brick ({bx}, {by}, {nz}) exceeds the launch grid")


def raise_on_error(lib, rc: int, what: str) -> None:
    """Raise for a nonzero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.stencil7_error(rc).decode()} (cudaError {rc})")


def launch_stencil7(P: torch.Tensor, c_diag: float, c_off: float) -> torch.Tensor:
    """Launch K6 on the CUDA padded brick ``P``; returns the fresh
    ``(bx, by, Z)`` output.  Checks device, dtype, rank and contiguity;
    does not synchronise."""
    if P.ndim != 3:
        raise ValueError(f"stencil7 input must be 3-D, got {tuple(P.shape)}")
    check_operand(P, P.shape, "stencil7")
    bx, by, nz = P.shape[0] - 2, P.shape[1] - 2, P.shape[2]
    check_brick(bx, by, nz, "stencil7")
    lib = library()
    out = torch.empty((bx, by, nz), dtype=P.dtype, device=P.device)
    fn = lib.stencil7_f32 if P.dtype == torch.float32 else lib.stencil7_f64
    rc = fn(P.data_ptr(), out.data_ptr(), bx, by, nz, c_diag, c_off,
            P.device.index, torch.cuda.current_stream(P.device).cuda_stream)
    raise_on_error(lib, rc, "stencil7")
    launch_stencil7.launches += 1
    return out


def launch_stencil_planes(T, xlo, xhi, ylo, yhi, coords, c_diag: float,
                          c_off: float, nx: int, ny: int) -> torch.Tensor:
    """Launch K7 on the CUDA brick ``T`` and its planes ``xlo``/``xhi``
    ``(1, by, Z)`` and ``ylo``/``yhi`` ``(bx, 1, Z)``, with the shape of
    :func:`k7_launch_shape`; ``coords`` are the brick's mesh coordinates,
    ``nx, ny`` the global extent.  Returns the fresh stepped brick; does not
    synchronise."""
    if T.ndim != 3:
        raise ValueError(f"stencil_planes brick must be 3-D, got {tuple(T.shape)}")
    check_operand(T, T.shape, "stencil_planes")
    bx, by, nz = T.shape
    launch = k7_launch_shape(bx, by, nz)
    for plane, shape in ((xlo, (1, by, nz)), (xhi, (1, by, nz)),
                         (ylo, (bx, 1, nz)), (yhi, (bx, 1, nz))):
        check_operand(plane, shape, "stencil_planes", like=T)
    cx, cy = (int(c) for c in coords)
    lib = library()
    out = torch.empty_like(T)
    fn = lib.stencil_planes_f32 if T.dtype == torch.float32 else lib.stencil_planes_f64
    rc = fn(T.data_ptr(), xlo.data_ptr(), xhi.data_ptr(), ylo.data_ptr(),
            yhi.data_ptr(), out.data_ptr(), bx, by, nz, cx * bx, cy * by,
            int(nx), int(ny), *launch.grid, *launch.block, launch.xc, c_diag,
            c_off, T.device.index,
            torch.cuda.current_stream(T.device).cuda_stream)
    raise_on_error(lib, rc, "stencil_planes")
    launch_stencil_planes.launches += 1
    return out


launch_stencil7.launches = 0
launch_stencil_planes.launches = 0
