"""Carry field state between NumPy (the JAX side's ``init_data`` / env) and
torch tensors on a device, preserving dtype.

>>> import numpy as np
>>> env = {"T": np.arange(8, dtype=np.float64).reshape(2, 2, 2)}
>>> back = env_to_numpy(env_from_numpy(env, "cpu"))
>>> back["T"].dtype, bool((back["T"] == env["T"]).all())
(dtype('float64'), True)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (or dtype name), or of a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` (and for its NumPy spellings)."""
    return str(torch_dtype(dtype)).removeprefix("torch.")


def env_from_numpy(env: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Fresh contiguous tensors on ``device``; never aliases the arrays."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in env.items()}


def env_to_numpy(env: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host NumPy copies of the tensors (waits for the device)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in env.items()}
