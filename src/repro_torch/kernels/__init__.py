"""repro_torch.kernels — hand-written Hopper kernels and their plain versions.

* :mod:`~repro_torch.kernels.fused` — K1, the fused loop-body stencil
  (CUDA C++ in ``csrc/fused_stencil.cu``) and ``fused_step_ref``;
* :mod:`~repro_torch.kernels.dotprod` — K2, the fused dot pair;
* :mod:`~repro_torch.kernels.transfer` — K3/K4, the multigrid transfers;
* :mod:`~repro_torch.kernels.spmv` — K5, the BTCS SpMV with its fused dot;
* :mod:`~repro_torch.kernels.stencil7` — K6/K7, the legacy 7-point
  stencils (padded brick; brick + halo planes);
* :mod:`~repro_torch.kernels.ops` — the device dispatch;
* :mod:`~repro_torch.kernels.build` — ``nvcc`` at first use, ``ctypes``.
"""
