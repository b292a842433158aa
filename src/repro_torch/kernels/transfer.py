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
kernels (``csrc/transfer.cu``) tile the output level one cell per thread
and follow the same separable order with every operation rounded on its
own, so they equal the plain versions bit for bit.

:func:`repro_torch.compiler.codegen.compile_transfer` caches one call per
level pair; on a CUDA tensor it launches the kernel (:func:`launch_restrict`
/ :func:`launch_prolong`, counted in ``.launches``), on a CPU tensor it runs
the plain version (:mod:`repro_torch.kernels.ops`).

Bound on the card: bytes (K3 reads the fine level once and writes the
coarse one; K4 the reverse).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.compiler.ir import coarsen_shape

#: the dtypes the kernels are built for
DTYPES = (torch.float32, torch.float64)


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
        for fn in (lib.restrict_f32, lib.restrict_f64, lib.prolong_f32,
                   lib.prolong_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int), ctypes.c_int,
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


def _launch(kind: str, src: torch.Tensor, out_shape, fine, coarse):
    lib = _library()
    dst = torch.empty(tuple(out_shape), dtype=src.dtype, device=src.device)
    f32 = src.dtype == torch.float32
    fn = {("restrict", True): lib.restrict_f32, ("restrict", False): lib.restrict_f64,
          ("prolong", True): lib.prolong_f32, ("prolong", False): lib.prolong_f64}[
              (kind, f32)]
    shape = (ctypes.c_int * 6)(*fine, *coarse)
    rc = fn(src.data_ptr(), dst.data_ptr(), shape, src.device.index,
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
    return out


def launch_prolong(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Launch K4 on a CUDA coarse tensor; returns the fresh fine level of
    ``fine_shape``.  Checks device, dtype, shape and contiguity; does not
    synchronise."""
    fine_shape = tuple(int(n) for n in fine_shape)
    _check(coarse, coarsen_shape(fine_shape), "prolong")
    out = _launch("prolong", coarse, fine_shape, fine_shape,
                  tuple(coarse.shape))
    launch_prolong.launches += 1
    return out


launch_restrict.launches = 0
launch_prolong.launches = 0
