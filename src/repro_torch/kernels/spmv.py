"""K5 — the fused BTCS SpMV and partial dot product, on Hopper.

The port of ``repro/kernels/spmv.py::spmv_dot``: over a halo-padded
``(bx+2, by+2, Z)`` brick ``P`` of the search vector,
``Ap = c_diag·c + c_off·Σ6`` (K6's stencil, z neighbours edge-replicated)
and, in the same pass, the brick's ``Σ c·Ap`` over the *unmasked* ``Ap`` —
Moat and z faces included, as the reference computes it before
``make_sharded_iteration`` masks ``Ap``.

* :func:`launch_spmv_dot` launches the CUDA kernel — K6's templated body
  in ``csrc/stencil7.cu`` with the block reduction switched on — on a
  CUDA tensor and returns ``(Ap, partials)``, one partial per block; it
  counts its launches in ``launch_spmv_dot.launches``;
* :func:`spmv_dot_ref` is the plain PyTorch version: ``Ap`` from
  :func:`repro_torch.kernels.stencil7.affine_stencil_ref` (bit for bit the
  kernel's) and the dot from one ``torch.sum``;
* :func:`repro_torch.kernels.ops.spmv_hex_dot` picks between them by the
  tensor's device and sums the kernel's partials with one ``torch.sum``.

The dot accumulates in ``promote(dtype, float32)`` (the reference's TPU
kernel and its oracle always used float32); the kernel sums in another
order than ``torch.sum``, so the dots agree to rounding, and the kernel is
deterministic (no atomics).

Bound on the card: bytes (the padded brick read once, ``Ap`` written once).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dotprod import acc_dtype
from repro_torch.kernels.stencil7 import (affine_stencil_ref, check_brick,
                                          check_operand, library,
                                          raise_on_error)


def spmv_dot_ref(P: torch.Tensor, c_diag: float, c_off: float):
    """Plain K5: ``(Ap, Σ c·Ap)`` with the dot a 0-d tensor in the
    accumulation dtype."""
    av = affine_stencil_ref(P, c_diag, c_off)
    c = P[1:-1, 1:-1, :]
    return av, torch.sum(c * av, dtype=acc_dtype(P.dtype))


def launch_spmv_dot(P: torch.Tensor, c_diag: float, c_off: float):
    """Launch K5 on the CUDA padded brick ``P``; returns the fresh
    ``(bx, by, Z)`` ``Ap`` and the ``(blocks,)`` partials of ``Σ c·Ap`` in
    the accumulation dtype.  Checks device, dtype, rank and contiguity;
    does not synchronise."""
    if P.ndim != 3:
        raise ValueError(f"spmv_dot input must be 3-D, got {tuple(P.shape)}")
    check_operand(P, P.shape, "spmv_dot")
    bx, by, nz = P.shape[0] - 2, P.shape[1] - 2, P.shape[2]
    check_brick(bx, by, nz, "spmv_dot")
    lib = library()
    blocks = lib.spmv_dot_blocks(bx, by, nz)
    if blocks < 1:
        raise ValueError(f"spmv_dot: no launch shape for brick ({bx}, {by}, {nz})")
    out = torch.empty((bx, by, nz), dtype=P.dtype, device=P.device)
    partials = torch.empty((blocks,), dtype=acc_dtype(P.dtype), device=P.device)
    fn = lib.spmv_dot_f32 if P.dtype == torch.float32 else lib.spmv_dot_f64
    rc = fn(P.data_ptr(), out.data_ptr(), partials.data_ptr(), bx, by, nz,
            c_diag, c_off, P.device.index,
            torch.cuda.current_stream(P.device).cuda_stream)
    raise_on_error(lib, rc, "spmv_dot")
    launch_spmv_dot.launches += 1
    return out, partials


launch_spmv_dot.launches = 0
