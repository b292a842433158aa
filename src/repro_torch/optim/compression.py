"""Gradient compression: int8 quantization with error feedback.

The port of ``repro/optim/compression.py``.  ``compress_error_feedback``
is the transform the train step applies (the residual rides along with the
optimizer state).  ``psum_compressed`` is the all-reduce of the quantized
payload over a named mesh axis, one part per mesh position (the reference's
``shard_map`` building block; its train step does not call it).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.mesh import axis_groups, psum_axes
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


def psum_compressed(parts, mesh, axis_name: str) -> list:
    """int8 all-reduce of one part per position of ``mesh`` across
    ``axis_name``: each part quantized with its own scale, the int8
    payloads summed as int32 (:func:`~repro_torch.core.mesh.psum_axes`),
    the sum dequantized with the largest scale along the axis — the
    reference's semantics exactly, which is not the sum of the parts where
    their scales differ.  Returns one tensor per position, in each part's
    dtype."""
    quant = [quantize_int8(g) for g in parts]
    total = psum_axes([q.to(torch.int32) for q, _ in quant], mesh, axis_name)
    s_max = _pmax([s for _, s in quant], mesh, axis_name)
    return [(t.float() * s).to(g.dtype)
            for t, s, g in zip(total, s_max, parts)]


def _pmax(scales, mesh, axis_name: str) -> list:
    """The reference's ``lax.pmax`` of one 0-d tensor per position."""
    out = [None] * mesh.size
    for group in axis_groups(mesh, axis_name):
        for b in group:
            out[b] = torch.stack([scales[p].to(scales[b].device)
                                  for p in group]).max()
    return out
