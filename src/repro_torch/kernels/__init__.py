"""repro_torch.kernels — hand-written Hopper kernels and their plain versions.

* :mod:`~repro_torch.kernels.fused` — K1, the fused loop-body stencil
  (CUDA C++ in ``csrc/fused_stencil.cu``) and ``fused_step_ref``;
* :mod:`~repro_torch.kernels.ops` — the device dispatch;
* :mod:`~repro_torch.kernels.build` — ``nvcc`` at first use, ``ctypes``.
"""
