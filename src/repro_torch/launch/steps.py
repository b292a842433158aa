"""Step builders: train (grad-accum + AdamW), prefill, decode.

The port of ``repro/launch/steps.py``.  ``make_train_step`` is the
production step: microbatched gradient accumulation (float32), global-norm
clip, cosine LR, AdamW, optional int8 error-feedback gradient compression.
The serving functions are called once per prompt batch and once per token.
All run on the device of their parameters.

The reference's jitted step donates the parameters and optimizer state;
here the step updates them in place under ``torch.no_grad()`` and returns
the same objects (the residual of compression is a new tree each step).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_error_feedback, cosine_schedule)
from repro_torch.optim.tree import leaves, tree_map, unflatten


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip: float = 1.0,
                    compress: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})`` for a :class:`ParamTree` ``params`` and
    a batch of int64 tensors on its device.

    With ``cfg.num_microbatches = mb > 1`` microbatch ``i`` is batch rows
    ``[i·B/mb, (i+1)·B/mb)``; each one's gradients are added into float32
    accumulators and the sum divided by ``mb``, the loss likewise.  At
    ``mb = 1`` the gradients stay in the parameters' dtype, so the clip
    of bfloat16 parameters runs in bfloat16, as the reference's does."""
    mb = cfg.num_microbatches

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        if mb > 1:
            split = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                     for k, v in batch.items()}
            tree = params.tree()
            gacc = leaves(tree_map(_zeros32, tree))
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=gacc[0].device)
            for i in range(mb):
                (loss, _), grads = M.value_and_grad(
                    params, {k: v[i] for k, v in split.items()}, cfg)
                for a, g in zip(gacc, leaves(grads)):
                    a.add_(g.float())
                del grads
                loss_sum = loss_sum + loss
            grads = unflatten(tree, (a.div_(mb) for a in gacc))
            loss = loss_sum / mb
        else:
            (loss, _), grads = M.value_and_grad(params, batch, cfg)

        if compress:
            grads, resid = compress_error_feedback(grads,
                                                   opt_state["residual"])
            opt_state = dict(opt_state, residual=resid)

        grads, gnorm = clip_by_global_norm(grads, clip)
        adam = opt_state["adam"] if isinstance(opt_state, dict) else opt_state
        lr = cosine_schedule(adam.step + 1, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        _, adam = adamw_update(params.tree(), grads, adam, lr)
        if isinstance(opt_state, dict):
            opt_state = dict(opt_state, adam=adam)
        else:
            opt_state = adam
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_opt_state(params, *, compress: bool = False):
    """AdamW's state for a :class:`ParamTree` (with a float32 zero residual
    per parameter when ``compress``), on the parameters' device."""
    tree = params.tree()
    adam = adamw_init(tree)
    if not compress:
        return adam
    return {"adam": adam, "residual": tree_map(_zeros32, tree)}


def make_prefill_step(cfg):
    def prefill_step(params, tokens):
        logits, _ = M.forward(params, tokens, cfg, last_only=True)
        return logits
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg)
    return decode_step
