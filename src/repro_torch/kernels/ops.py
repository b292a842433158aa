"""Device dispatch for the port's kernels.

Replaces the reference's ``_interpret()`` switch (``repro/kernels/ops.py``):
the tensors' device decides, and nothing else does — there is no
environment switch.  A CUDA tensor goes to the hand-written kernel (which
launches or raises); a CPU tensor goes to the kernel's plain PyTorch
version; any other device raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot
from repro_torch.kernels.fused import FusedKernel, fused_step_ref, launch_fused
from repro_torch.kernels.spmv import launch_spmv_dot, spmv_dot_ref
from repro_torch.kernels.stencil7 import (affine_stencil_ref, launch_stencil7,
                                          launch_stencil_planes,
                                          stencil_planes_ref)
from repro_torch.kernels.transfer import (launch_prolong, launch_restrict,
                                          prolong_ref, restrict_ref)


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no {what} kernel for device {t.device}")


def fused_step(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
               coords: Tuple[int, int] = (0, 0),
               out: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, ...]:
    """One launch of the fused loop-body kernel K1: on wrap-padded inputs
    into fresh outputs, or (margin mode) on resident buffers into the
    ``out`` buffers; ``(B, …)`` member stacks for a kernel built for B
    members."""
    if _on_card(inputs[0], "fused stencil"):
        return launch_fused(kernel, inputs, coords, out=out)
    return fused_step_ref(kernel, inputs, coords, out=out)


def dual_dot(a, b, c, d) -> torch.Tensor:
    """``stack([a·b, c·d])`` in ``promote(dtype, float32)``: on the card K2's
    per-block partials summed over the block axis (the reference wrapper's
    ``sum(axis=0)``), on the host the plain version."""
    if _on_card(a, "dual dot"):
        return torch.sum(launch_dual_dot(a, b, c, d), dim=0)
    return dual_dot_ref(a, b, c, d)


def restrict(fine: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction K3 of one multigrid level."""
    if _on_card(fine, "restriction"):
        return launch_restrict(fine)
    return restrict_ref(fine)


def prolong(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Trilinear prolongation K4 of one multigrid level."""
    if _on_card(coarse, "prolongation"):
        return launch_prolong(coarse, fine_shape)
    return prolong_ref(coarse, fine_shape)


def stencil7(P: torch.Tensor, c_diag: float, c_off: float) -> torch.Tensor:
    """K6: the affine 7-point stencil over a ``(bx+2, by+2, Z)`` halo-padded
    brick → ``(bx, by, Z)``."""
    if _on_card(P, "7-point stencil"):
        return launch_stencil7(P, c_diag, c_off)
    return affine_stencil_ref(P, c_diag, c_off)


def stencil7_planes(T, xlo, xhi, ylo, yhi, coords, c_diag: float,
                    c_off: float, nx: int, ny: int) -> torch.Tensor:
    """K7: one FTCS step from an unpadded brick, its four received halo
    planes and its mesh ``coords``; the Moat is kept in the kernel."""
    if _on_card(T, "halo-plane stencil"):
        return launch_stencil_planes(T, xlo, xhi, ylo, yhi, coords, c_diag,
                                     c_off, nx, ny)
    return stencil_planes_ref(T, xlo, xhi, ylo, yhi, coords, c_diag, c_off,
                              nx, ny)


def spmv_hex(P: torch.Tensor, c_diag: float, c_off: float) -> torch.Tensor:
    """K5 with its dot discarded: the BTCS SpMV of the CG operator."""
    if _on_card(P, "SpMV"):
        return launch_spmv_dot(P, c_diag, c_off)[0]
    return spmv_dot_ref(P, c_diag, c_off)[0]


def spmv_hex_dot(P: torch.Tensor, c_diag: float, c_off: float):
    """K5: ``(Ap, Σ c·Ap)`` over the padded brick, the dot a 0-d tensor in
    ``promote(dtype, float32)`` — on the card K5's per-block partials summed
    by one ``torch.sum``."""
    if _on_card(P, "SpMV"):
        av, partials = launch_spmv_dot(P, c_diag, c_off)
        return av, torch.sum(partials)
    return spmv_dot_ref(P, c_diag, c_off)
