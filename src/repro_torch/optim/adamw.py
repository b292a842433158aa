"""AdamW with float32 moments over parameters of any dtype (e.g. bfloat16).

The port of ``repro/optim/adamw.py``.  The state is
``AdamWState(step, m, v)``: an int32 0-d step and float32 moments in trees
shaped as the parameters (``ParamTree.tree()``).  There are no master
weights: each update computes in float32 and is cast back to the
parameter's dtype, as the reference's is.

The reference returns new parameters and moments, and its train step
donates the old ones.  Here :func:`adamw_update` writes them in place (the
parameters and ``m``/``v`` are updated, the returned tree and state hold
the same tensors), which keeps one copy of each on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def adamw_init(params) -> AdamWState:
    """Zero moments on each parameter's device; step 0."""
    first = leaves(params)[0]
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      zeros, tree_map(torch.clone, zeros))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / ‖g‖)`` (``‖g‖`` over all
    leaves in float32), the scale cast to each gradient's dtype.  Returns
    (clipped grads, ‖g‖)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and the moments (see the
    module docstring); ``lr`` a float or a float32 0-d tensor.  Returns
    (params, the state with step + 1)."""
    step = state.step + 1
    b1c = 1.0 - torch.pow(b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(b2, step.to(torch.float32))
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
        pf = p.float()
        upd.add_(weight_decay * pf)
        p.copy_(pf - lr * upd)
    return params, AdamWState(step, state.m, state.v)
