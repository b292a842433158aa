"""Carry field state between NumPy (the JAX side's ``init_data`` / env) and
torch tensors on a device, preserving dtype: whole fields
(:func:`env_from_numpy` / :func:`env_to_numpy`) and the brick state of the
legacy drivers (:func:`state_from_numpy` / :func:`state_to_numpy`: a field,
or an iteration state of fields and scalars), so that both packages start
from the same arrays; and LM parameter trees (:func:`lm_params_from_numpy`
/ :func:`lm_params_to_numpy`), the reference's stacked segments split into
per-layer modules.

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


def _leaf_from_numpy(a, device) -> torch.Tensor:
    """A tensor of ``a``'s values on ``device``; NumPy bfloat16 (the
    reference's ``ml_dtypes``) goes through float32, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree, cfg, device):
    """The port's :class:`~repro_torch.models.model.ParamTree` from the
    reference's parameter pytree as NumPy arrays
    (``jax.tree.map(np.asarray, init_params(key, cfg))``): each segment's
    stacked arrays split into its ``count`` layers, the shared block,
    embeddings (tied or per codebook) and heads as they are."""
    from repro_torch.models.model import ParamTree

    out = {}
    for name, value in tree.items():
        if name == "segments":
            out[name] = [
                [_map(lambda a, i=i: _leaf_from_numpy(np.asarray(a)[i],
                                                      device), seg)
                 for i in range(count)]
                for (_, count), seg in zip(cfg.segments, value)]
        else:
            out[name] = _map(lambda a: _leaf_from_numpy(a, device), value)
    return ParamTree(out)


def lm_params_to_numpy(params):
    """The reference's pytree layout from a ParamTree: each segment's
    layers stacked along a leading axis.  bfloat16 tensors come back as
    float32 arrays of the same values (NumPy has no bfloat16 of its own)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    tree = params.tree()
    out = {}
    for name, value in tree.items():
        if name == "segments":
            out[name] = [_stack([_map(leaf, layer) for layer in seg])
                         for seg in value]
        else:
            out[name] = _map(leaf, value)
    return out


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers]) for k in layers[0]}
    return np.stack(layers)
