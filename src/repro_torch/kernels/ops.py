"""Device dispatch for the port's kernels.

Replaces the reference's ``_interpret()`` switch (``repro/kernels/ops.py``):
the tensors' device decides, and nothing else does — there is no
environment switch.  A CUDA tensor goes to the hand-written kernel (which
launches or raises); a CPU tensor goes to the kernel's plain PyTorch
version; any other device raises.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot
from repro_torch.kernels.fused import FusedKernel, fused_step_ref, launch_fused
from repro_torch.kernels.transfer import (launch_prolong, launch_restrict,
                                          prolong_ref, restrict_ref)


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no {what} kernel for device {t.device}")


def fused_step(kernel: FusedKernel, padded: Sequence[torch.Tensor],
               coords: Tuple[int, int] = (0, 0)) -> Tuple[torch.Tensor, ...]:
    """One launch of the fused loop-body kernel K1 on wrap-padded inputs."""
    if _on_card(padded[0], "fused stencil"):
        return launch_fused(kernel, padded, coords)
    return fused_step_ref(kernel, padded, coords)


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
