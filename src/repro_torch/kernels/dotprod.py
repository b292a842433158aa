"""K2 — the fused dual dot product, on Hopper.

The port of ``repro/kernels/dotprod.py::dual_dot_2d``: ``(a·b, c·d)`` in one
sweep over the four operands, as per-block partial pairs.  Preconditioned
CG and pipelined CG take both of an iteration's reductions from it
(``dot2`` in :mod:`repro_torch.solver.api`).

* :func:`launch_dual_dot` launches the CUDA kernel
  (``csrc/dual_dot.cu``, built for ``sm_90a`` at first use) on CUDA
  tensors and returns the ``(blocks, 2)`` partials; it counts its launches
  in ``launch_dual_dot.launches``;
* :func:`dual_dot_ref` is the plain PyTorch version: the two sums, each
  taken by ``torch.sum``;
* :func:`repro_torch.kernels.ops.dual_dot` picks between them by the
  tensors' device and sums the kernel's partials.

Both accumulate in ``promote(dtype, float32)``: float32 for float32
operands, float64 for float64 ones (the TPU kernel always used float32).
The kernel sums in another order than ``torch.sum``, so the two agree to
rounding, not bitwise; the kernel is deterministic (no atomics).

Bound on the card: bytes (each distinct operand read once).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

#: elements one block of the kernel reduces (256 threads × 32)
ITEMS_PER_BLOCK = 8192
#: the dtypes the kernel is built for
DTYPES = (torch.float32, torch.float64)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a dot over ``dtype`` operands."""
    return torch.promote_types(dtype, torch.float32)


def dual_dot_ref(a, b, c, d) -> torch.Tensor:
    """Plain PyTorch version: ``stack([a·b, c·d])`` in the accumulation
    dtype."""
    acc = acc_dtype(a.dtype)
    return torch.stack([torch.sum(a * b, dtype=acc), torch.sum(c * d, dtype=acc)])


_LIB = None


def _library():
    """The built ``dual_dot`` library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library

        lib = load_library("dual_dot")
        for fn in (lib.dual_dot_f32, lib.dual_dot_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.dual_dot_items_per_block.restype = ctypes.c_int
        lib.dual_dot_error.argtypes = [ctypes.c_int]
        lib.dual_dot_error.restype = ctypes.c_char_p
        if lib.dual_dot_items_per_block() != ITEMS_PER_BLOCK:
            raise RuntimeError("dual_dot library and wrapper disagree on the "
                               "block size")
        _LIB = lib
    return _LIB


def _check_operands(ops: Sequence[torch.Tensor]) -> None:
    first = ops[0]
    if first.device.type != "cuda":
        raise ValueError(f"dual_dot kernel needs CUDA tensors, got {first.device}")
    if first.dtype not in DTYPES:
        raise ValueError(f"dual_dot kernel takes {DTYPES}, got {first.dtype}")
    for t in ops:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError("dual_dot operands must share one device and dtype")
        if t.numel() != first.numel():
            raise ValueError(
                f"dual_dot operands differ in size: {t.numel()} vs {first.numel()}")
        if not t.is_contiguous():
            raise ValueError("dual_dot operands must be contiguous")
    if first.numel() == 0:
        raise ValueError("dual_dot of empty operands")


def launch_dual_dot(a, b, c, d) -> torch.Tensor:
    """Launch K2 on CUDA tensors; returns the ``(blocks, 2)`` partials in
    the accumulation dtype (sum over axis 0 gives ``(a·b, c·d)``).

    Checks device, dtype, size and contiguity, allocates the partials with
    ``torch.empty``, launches on the current stream and raises if the
    launch was refused.  Does not synchronise.
    """
    ops = (a, b, c, d)
    _check_operands(ops)
    lib = _library()
    n = a.numel()
    blocks = -(-n // ITEMS_PER_BLOCK)
    dev = a.device
    partials = torch.empty((blocks, 2), dtype=a.dtype, device=dev)
    fn = lib.dual_dot_f32 if a.dtype == torch.float32 else lib.dual_dot_f64
    rc = fn(*[t.data_ptr() for t in ops], n, partials.data_ptr(), blocks,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"dual_dot launch failed: {lib.dual_dot_error(rc).decode()} "
            f"(cudaError {rc})")
    launch_dual_dot.launches += 1
    return partials


launch_dual_dot.launches = 0
