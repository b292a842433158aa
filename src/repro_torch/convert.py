"""Carry field state between NumPy (the JAX side's ``init_data`` / env) and
torch tensors on a device, preserving dtype: whole fields
(:func:`env_from_numpy` / :func:`env_to_numpy`) and the brick state of the
legacy drivers (:func:`state_from_numpy` / :func:`state_to_numpy`: a field,
or an iteration state of fields and scalars), so that both packages start
from the same arrays.

>>> import numpy as np
>>> env = {"T": np.arange(8, dtype=np.float64).reshape(2, 2, 2)}
>>> back = env_to_numpy(env_from_numpy(env, "cpu"))
>>> back["T"].dtype, bool((back["T"] == env["T"]).all())
(dtype('float64'), True)
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


def state_from_numpy(state: Sequence[np.ndarray], sharding) -> Tuple:
    """An iteration state of the legacy brick harness
    (:func:`repro_torch.core.implicit.make_sharded_iteration`) from NumPy
    arrays (or tensors): 3-D fields become BrickArrays of ``sharding``,
    scalars fresh 0-d tensors on the mesh's home device."""
    out = []
    for a in state:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        if a.ndim == 3:
            out.append(sharding.shard(a))
        elif a.ndim == 0:
            out.append(a.to(sharding.mesh.home, copy=True))
        else:
            raise ValueError(f"state entries are (X, Y, Z) fields or scalars; "
                             f"got shape {a.shape}")
    return tuple(out)


def state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    """Host NumPy copies of an iteration state (fields gathered)."""
    from repro_torch.core.mesh import device_get

    return tuple(device_get(x) for x in state)
