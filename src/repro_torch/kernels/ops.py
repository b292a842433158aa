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

from repro_torch.kernels.fused import FusedKernel, fused_step_ref, launch_fused


def fused_step(kernel: FusedKernel, padded: Sequence[torch.Tensor],
               coords: Tuple[int, int] = (0, 0)) -> Tuple[torch.Tensor, ...]:
    """One launch of the fused loop-body kernel K1 on wrap-padded inputs."""
    dev = padded[0].device
    if dev.type == "cuda":
        return launch_fused(kernel, padded, coords)
    if dev.type == "cpu":
        return fused_step_ref(kernel, padded, coords)
    raise RuntimeError(f"no fused stencil kernel for device {dev}")
