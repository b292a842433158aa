"""Gradient compression: int8 quantization with error feedback.

The port of ``repro/optim/compression.py``.  ``compress_error_feedback``
is the transform the train step applies (the residual rides along with the
optimizer state).  The reference's ``psum_compressed``, the all-reduce of
the quantized payload over a named mesh axis, comes with the port's mesh
parallelism.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.optim.tree import leaves, unflatten


def quantize_int8(x):
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_error_feedback(grads, residual):
    """Quantize grads (+carry residual), return (decompressed, new_residual).

    residual is a tree like grads (float32); pass zeros on first use.
    """
    def one(g, r):
        gf = g.float() + r
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, (o[0] for o in outs)),
            unflatten(grads, (o[1] for o in outs)))
