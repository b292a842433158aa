"""Shared layer primitives: norms, rotary embeddings, MLPs, initialisers.

The port of ``repro/models/layers.py``.  Parameters are nested dicts of
tensors (:class:`repro_torch.models.model.ParamTree` holds them as a
module); every layer is an (init, apply) pair of functions.  ``init`` draws
from an explicit ``torch.Generator`` on its device; ``apply`` is
functional.  Norms and rotations compute in float32 and cast back, as the
reference does.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F


def einsum(eq: str, *operands) -> torch.Tensor:
    """``torch.einsum`` under ``jnp.einsum``'s dtype rule: the operands are
    promoted to their common dtype first (bfloat16 with float32 → float32),
    where ``torch.einsum`` would refuse mixed dtypes."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(eq, *(o.to(dt) for o in operands))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class MetaDraws:
    """What the initialisers take in place of a generator on the ``meta``
    device: every draw is an empty meta tensor of its shape and dtype, so
    a model's shapes come from its own initialiser with nothing drawn or
    allocated (the reference's ``jax.eval_shape`` over ``init_params``)."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``N(0, scale²)`` drawn in float32 on ``gen``'s device, cast to
    ``dtype`` (the reference's ``normal(key, shape, f32) * scale``)."""
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """``U[0, 1)`` drawn in float32 on ``gen``'s device, cast to ``dtype``."""
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return normal(gen, (vocab, d), 0.02, dtype)


def full(gen, shape, value: float, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(gen, d: int, dtype):
    return {"scale": full(gen, (d,), 1.0, dtype)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def head_rmsnorm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3 / Chameleon): x is (..., head_dim)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(rot_dim: int, theta: float, device=None):
    """Inverse frequencies in float32 (never float64: the reference's bits)."""
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                         device=device) / rot_dim))


def apply_rope(x, pos, theta: float = 1e4, fraction: float = 1.0):
    """Rotate the first ``fraction`` of head_dim; interleaved-pair convention.

    x: (..., S, H, D) — the head axis is required (use H=1 for single-head
    rope streams such as MLA's shared k_rope).  pos: (..., S) integer.
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    if rot == 0:
        return x
    rot -= rot % 2
    freqs = rope_freqs(rot, theta, x.device)             # (rot/2,)
    angles = pos[..., None].float() * freqs              # (..., S, rot/2)
    angles = angles[..., None, :]                        # broadcast over H
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": _gelu, "relu": F.relu}


def mlp_init(gen, d: int, d_ff: int, dtype, gated: bool = True):
    p = {"up": dense_init(gen, d, d_ff, dtype),
         "down": dense_init(gen, d_ff, d, dtype)}
    if gated:
        p["gate"] = dense_init(gen, d, d_ff, dtype)
    return p


def mlp_apply(params, x, act: str = "silu"):
    f = _ACTS[act]
    up = x @ params["up"]
    if "gate" in params:
        up = f(x @ params["gate"]) * up
    else:
        up = f(up)
    return up @ params["down"]
