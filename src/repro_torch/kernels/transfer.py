"""K3 and K4 — the multigrid transfers, on Hopper.

The port of ``repro/kernels/transfer.py``: full-weighting restriction (K3,
``build_restrict_call``) and trilinear prolongation (K4,
``build_prolong_call``) between two levels of a multigrid hierarchy.
Alignment is even vertex-centred: coarse cell ``I`` sits on fine cell
``2I``, so a fine extent ``n`` coarsens to ``n//2 + 1`` (Moat planes
included) for every parity.

* restriction — per axis ``coarse[I] = 1/2·fine[2I] + 1/4·(fine[2I−1] +
  fine[2I+1])`` over the coarse interior, x then y then z; the coarse Moat
  is zero;
* prolongation — per axis ``fine[2I] = coarse[I]`` and ``fine[2I+1] =
  1/2·(coarse[I] + coarse[I+1])``, x then y then z; the fine Moat is zero.

:func:`restrict_ref` / :func:`prolong_ref` are the plain PyTorch versions:
the reference's ``_restrict_axis`` / ``_prolong_axis`` arithmetic in the
same axis order (strided slices, an interleave, zero pads).  The CUDA
kernels (``csrc/transfer.cu``) follow the same separable order with every
operation rounded on its own, so they equal the plain versions bit for
bit.  K3 tiles the coarse level one cell per thread.  K4 marches along x:
a block owns :data:`K4_TY` coarse rows (twice as many fine rows) ×
:data:`K4_ZC` fine z × ``xc`` coarse steps, stages each coarse plane's tile
once and writes fine planes ``2I`` and ``2I+1`` per step;
:func:`k4_launch_shape` is the one owner of its launch shape, and
:func:`prolong_tiles_ref` is that schedule in plain PyTorch (the tests hold
it bitwise against :func:`prolong_ref`).

:func:`repro_torch.compiler.codegen.compile_transfer` caches one call per
level pair; on a CUDA tensor it launches the kernel (:func:`launch_restrict`
/ :func:`launch_prolong`, counted in ``.launches`` and, by the fine level's
shape, in ``.by_level``), on a CPU tensor it runs the plain version
(:mod:`repro_torch.kernels.ops`).

Bound on the card: bytes (K3 reads the fine level once and writes the
coarse one; K4 the reverse).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compiler.ir import coarsen_shape
from repro_torch.kernels.stencil7 import MAX_GRID, MAX_GRID_X

#: the dtypes the kernels are built for
DTYPES = (torch.float32, torch.float64)
#: K4's tile (``kProlong*`` in csrc/transfer.cu): a block of 32 z lanes ×
#: K4_TY coarse rows, each thread two fine rows and four fine z cells, so
#: 2·K4_TY fine rows and K4_ZC fine z per block
K4_TY = 8
K4_ZC = 128
#: K4's tile depth, coarse x steps per block (two fine planes each): the
#: depth that timed fastest at five of the six level pairs of 512×512×128
#: in a sweep of 1–16 (PERF.md §6; at 129×129×33 depth 2 is 0.0003 ms
#: faster).  The coarse level (17 MB at the finest pair) stays in the 50 MB
#: L2, so a tile's re-read of its last plane costs little, while every
#: further step of the march costs a barrier
K4_XC = 1
#: the most cells a fine (ny, nz) plane of K4 may hold, a z chunk to spare
#: (the kernel keeps in-plane offsets in an int)
K4_MAX_PLANE = 2 ** 31 - 1 - K4_ZC


def _sl(a, axis: int, start: int, stop: int, step: int = 1):
    """Static (possibly strided) slice of ``a`` along one axis."""
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop, step)
    return a[tuple(idx)]


def _pad_axis(a, axis: int):
    """One zero plane on each side of ``axis``."""
    pad = [0] * (2 * a.ndim)
    pad[2 * (a.ndim - 1 - axis)] = 1
    pad[2 * (a.ndim - 1 - axis) + 1] = 1
    return F.pad(a, pad)


def _restrict_axis(a, axis: int, m: int):
    """Full weighting along ``axis``: fine extent n → coarse interior m
    (``m = n//2 − 1``); coarse cell i (1-based) weighs fine cells 2i−1, 2i,
    2i+1 by 1/4, 1/2, 1/4."""
    lo = _sl(a, axis, 1, 2 * m, 2)
    mid = _sl(a, axis, 2, 2 * m + 1, 2)
    hi = _sl(a, axis, 3, 2 * m + 2, 2)
    return 0.5 * mid + 0.25 * (lo + hi)


def _prolong_axis(c, axis: int, n: int):
    """Linear interpolation along ``axis``: coarse extent n//2+1 → fine n.

    Even fine cells copy the coincident coarse cell, odd fine cells average
    the two spanning coarse cells; the fine Moat planes are zero.
    """
    m = n // 2 - 1
    odd = 0.5 * (_sl(c, axis, 0, m + 1) + _sl(c, axis, 1, m + 2))
    even = _sl(c, axis, 1, m + 1)
    pairs = torch.stack([_sl(odd, axis, 0, m), even], dim=axis + 1)
    shape = list(pairs.shape)
    shape[axis:axis + 2] = [2 * m]
    seq = torch.cat([pairs.reshape(shape), _sl(odd, axis, m, m + 1)], dim=axis)
    return _pad_axis(_sl(seq, axis, 0, n - 2), axis)


def restrict_ref(fine: torch.Tensor) -> torch.Tensor:
    """Plain full weighting — the ``jit`` path, the CPU path and K3's
    yardstick."""
    a = fine
    for axis in range(3):
        a = _restrict_axis(a, axis, fine.shape[axis] // 2 - 1)
    return F.pad(a, (1, 1, 1, 1, 1, 1)).contiguous()


def prolong_ref(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Plain trilinear interpolation — the ``jit`` path, the CPU path and
    K4's yardstick."""
    a = coarse
    for axis, n in enumerate(fine_shape):
        a = _prolong_axis(a, axis, int(n))
    return a.contiguous()


class K4Shape(NamedTuple):
    """One K4 launch: ``grid = (y tiles, x tiles, z chunks)``, ``block =
    (32, K4_TY)``, and ``xc`` coarse x steps (``2·xc`` fine planes) per
    tile."""

    grid: Tuple[int, int, int]
    block: Tuple[int, int]
    xc: int


def k4_launch_shape(nx: int, ny: int, nz: int) -> K4Shape:
    """The launch shape of K4 onto a fine ``(nx, ny, nz)`` level: tiles of
    ``2·K4_TY`` fine rows × :data:`K4_ZC` fine z × ``2·xc`` fine planes,
    ``xc`` = :data:`K4_XC` evened out over the ``⌈⌈nx/2⌉ / K4_XC⌉`` x tiles.
    Raises ``ValueError`` for an empty level, a grid over CUDA's limits or
    a plane over :data:`K4_MAX_PLANE` cells."""
    if min(nx, ny, nz) < 1:
        raise ValueError(f"prolong onto an empty level ({nx}, {ny}, {nz})")
    steps = -(-nx // 2)
    x_tiles = -(-steps // K4_XC)
    xc = -(-steps // x_tiles)
    y_tiles, z_tiles = -(-ny // (2 * K4_TY)), -(-nz // K4_ZC)
    if (x_tiles > MAX_GRID or z_tiles > MAX_GRID or y_tiles > MAX_GRID_X
            or ny * nz > K4_MAX_PLANE):
        raise ValueError(f"prolong: level ({nx}, {ny}, {nz}) exceeds the "
                         "launch grid")
    return K4Shape((y_tiles, x_tiles, z_tiles), (32, K4_TY), xc)


def _interleave(even, odd, axis: int, n: int):
    """``even[0], odd[0], even[1], …`` along ``axis``, cut to ``n``."""
    both = torch.stack([even, odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] = 2 * even.shape[axis]
    return _sl(both.reshape(shape), axis, 0, n)


def prolong_tiles_ref(coarse: torch.Tensor, fine_shape,
                      launch: K4Shape = None) -> torch.Tensor:
    """K4's schedule in plain PyTorch: tile by tile of ``launch`` (default
    :func:`k4_launch_shape`), coarse plane ``I + 1``'s tile staged with a
    one-row, one-z halo (zero off the level), the odd x-pass tile
    ``0.5·(P_I + P_{I+1})`` formed from it, and fine planes ``2I`` and
    ``2I + 1`` emitted per step — the y pass, the z pass and the Moat
    select of ``csrc/transfer.cu``.  Cells no tile writes stay NaN."""
    nx, ny, nz = (int(n) for n in fine_shape)
    cx, cy, cz = coarse.shape
    s = launch or k4_launch_shape(nx, ny, nz)
    fy_t, fz_t = 2 * K4_TY, K4_ZC
    fine = torch.full((nx, ny, nz), float("nan"), dtype=coarse.dtype)
    for ty, tx, tz in ((a, b, c) for a in range(s.grid[0])
                       for b in range(s.grid[1]) for c in range(s.grid[2])):
        J0, K0 = ty * K4_TY, tz * (K4_ZC // 2)
        I0 = tx * s.xc
        I1 = min(I0 + s.xc, -(-nx // 2))

        def staged(p):
            t = torch.zeros((K4_TY + 1, K4_ZC // 2 + 1), dtype=coarse.dtype)
            if p < cx:
                src = coarse[p, J0:J0 + K4_TY + 1, K0:K0 + K4_ZC // 2 + 1]
                t[:src.shape[0], :src.shape[1]] = src
            return t

        fy = torch.arange(2 * J0, 2 * J0 + fy_t)[:, None]
        fz = torch.arange(2 * K0, 2 * K0 + fz_t)[None, :]
        yz_in = (fy > 0) & (fy < ny - 1) & (fz > 0) & (fz < nz - 1)
        rows, cols = min(fy_t, ny - 2 * J0), min(fz_t, nz - 2 * K0)
        cur = staged(I0)
        for I in range(I0, I1):
            nxt = staged(I + 1)
            for fx, X in ((2 * I, cur), (2 * I + 1, 0.5 * (cur + nxt))):
                if fx >= nx:
                    continue
                Y = _interleave(X[:-1], 0.5 * (X[:-1] + X[1:]), 0, fy_t)
                Z = _interleave(Y[:, :-1], 0.5 * (Y[:, :-1] + Y[:, 1:]), 1, fz_t)
                out = torch.where(yz_in & (0 < fx < nx - 1), Z,
                                  torch.zeros((), dtype=Z.dtype))
                fine[fx, 2 * J0:2 * J0 + rows, 2 * K0:2 * K0 + cols] = \
                    out[:rows, :cols]
            cur = nxt
    return fine


# ---------------------------------------------------------------------------
# the CUDA launchers
# ---------------------------------------------------------------------------

_LIB = None


def _library():
    """The built ``transfer`` library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library

        lib = load_library("transfer")
        for fn in (lib.restrict_f32, lib.restrict_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.prolong_f32, lib.prolong_f64):
            # coarse, fine, shape; grid, block, xc; device, stream
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7 + [
                               ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.transfer_error.argtypes = [ctypes.c_int]
        lib.transfer_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, shape, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPES:
        raise ValueError(f"{what} kernel takes {DTYPES}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} input has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} input is not contiguous")


def _launch(kind: str, src: torch.Tensor, out_shape, fine, coarse, launch=()):
    """Launch ``kind`` from ``src`` into a fresh ``out_shape`` tensor;
    ``launch`` holds K4's grid, block and tile depth (K3 takes none)."""
    lib = _library()
    dst = torch.empty(tuple(out_shape), dtype=src.dtype, device=src.device)
    fn = getattr(lib, f"{kind}_{'f32' if src.dtype == torch.float32 else 'f64'}")
    shape = (ctypes.c_int * 6)(*fine, *coarse)
    rc = fn(src.data_ptr(), dst.data_ptr(), shape, *launch, src.device.index,
            torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kind} launch failed: "
                           f"{lib.transfer_error(rc).decode()} (cudaError {rc})")
    return dst


def launch_restrict(fine: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a CUDA ``(nx, ny, nz)`` tensor; returns the fresh coarse
    level.  Checks device, dtype, rank and contiguity; does not
    synchronise."""
    if fine.ndim != 3:
        raise ValueError(f"restrict input must be 3-D, got {tuple(fine.shape)}")
    _check(fine, fine.shape, "restrict")
    coarse = coarsen_shape(fine.shape)
    out = _launch("restrict", fine, coarse, tuple(fine.shape), coarse)
    launch_restrict.launches += 1
    _count_level(launch_restrict, tuple(fine.shape))
    return out


def launch_prolong(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Launch K4 on a CUDA coarse tensor with the shape of
    :func:`k4_launch_shape`; returns the fresh fine level of
    ``fine_shape``.  Checks device, dtype, shape and contiguity; does not
    synchronise."""
    fine_shape = tuple(int(n) for n in fine_shape)
    _check(coarse, coarsen_shape(fine_shape), "prolong")
    s = k4_launch_shape(*fine_shape)
    out = _launch("prolong", coarse, fine_shape, fine_shape,
                  tuple(coarse.shape), (*s.grid, *s.block, s.xc))
    launch_prolong.launches += 1
    _count_level(launch_prolong, fine_shape)
    return out


def _count_level(launcher, fine_shape) -> None:
    """One more launch of ``launcher`` at the level pair of ``fine_shape``."""
    launcher.by_level[fine_shape] = launcher.by_level.get(fine_shape, 0) + 1


launch_restrict.launches = 0
launch_prolong.launches = 0
#: launches by the fine level's shape, beside ``.launches``
launch_restrict.by_level = {}
launch_prolong.by_level = {}
