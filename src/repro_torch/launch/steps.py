"""Step builders: train (grad-accum + AdamW), prefill, decode.

The port of ``repro/launch/steps.py``.  ``make_train_step`` is the
production step: microbatched gradient accumulation (float32), global-norm
clip, cosine LR, AdamW, optional int8 error-feedback gradient compression.
The serving functions are called once per prompt batch and once per token.
All run on the device of their parameters.

The reference's jitted step donates the parameters and optimizer state;
here the step updates them in place under ``torch.no_grad()`` and returns
the same objects (the residual of compression is a new tree each step).

On a mesh (``use_sharding(rules)``) the reference leaves the parallelism to
GSPMD; the port does it by hand, in one process (``_accumulate``):

* the batch is sharded over the rules' ``batch`` axes (``("pod",
  "data")`` where they are in the mesh and divide a microbatch's rows, the
  reference's ``pshard(x, None, "batch", …)``): replica ``r`` (its
  coordinates along those axes, x-major) takes the ``r``-th block of
  ``B/(mb·dp)`` rows of every microbatch and runs its own forward and
  backward; its gradients and loss go into the float32 accumulators of
  its device, which the replicas on that device share, added in the order
  microbatch, then replica, and divided by ``dp·mb`` once a step;
  compression, the clip and AdamW then run once, on the mean gradients.
  The reference's ``psum`` over the batch axes sums across devices: every
  position is on one card here, so it holds one set of accumulators,
  whatever ``dp``, and there is nothing to reduce (multi-card transport
  would sum the devices' accumulators with
  :func:`~repro_torch.core.mesh.psum_axes`);
* parameters, AdamW's moments and the compute are replicated over
  ``model`` (the reference's tensor parallelism over ``model`` is ported
  for serving only, :mod:`repro_torch.parallel.tensor`): every position of
  the mesh must be on the parameters' device, which holds the state once;
* where the batch axes do not divide the rows, or span one position, the
  step is the one-device step, bit for bit.

So the step on ``dp`` replicas is the one-device step at ``dp·mb``
microbatches, bit for bit.  Against the one-device step at ``mb`` only
the order of the sums differs, but for MoE: its load-balance term is not
linear in the rows (``E·Σ pe·fe`` over the tokens a pass sees), so the
mean of the replicas' terms is not the term of the whole microbatch
(``tests/test_torch_parallel.py`` measures it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import model as M
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_error_feedback, cosine_schedule)
from repro_torch.optim.tree import leaves, tree_map, unflatten
from repro_torch.parallel.sharding import current_rules, pshard


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _split(batch, mb: int) -> dict:
    """Each batch tensor as (mb, B/mb, …): microbatch ``i`` its rows
    ``[i·B/mb, (i+1)·B/mb)``."""
    out = {}
    for k, v in batch.items():
        x = v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
        out[k] = pshard(x, None, "batch", *([None] * (x.ndim - 2)))
    return out


def batch_axes(rules, rows: int):
    """The mesh axes a microbatch of ``rows`` rows is sharded over under
    ``rules`` and their positions ``dp``, or None where the step runs as on
    one device (no rules, the axes do not divide the rows, or dp = 1)."""
    if rules is None:
        return None
    axes = rules.mesh_axes("batch", rows)
    if axes is None:
        return None
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    dp = math.prod(rules.mesh.shape[a] for a in names)
    return (names, dp) if dp > 1 else None


def _accumulate(params, batch, cfg, mb: int, dp: int = 1, mesh=None):
    """(mean gradients, mean loss) of the step's ``mb`` microbatches, each
    split over ``dp`` replicas on ``mesh`` (module docstring): float32
    gradients, in the parameters' dtype at mb = 1."""
    tree = params.tree()
    dev = leaves(tree)[0].device
    if mesh is not None and any(d != dev for d in mesh.devices):
        raise ValueError(f"the data-parallel step runs every position of "
                         f"the mesh on the parameters' device {dev}; got "
                         f"{[str(d) for d in mesh.devices]}")
    split = _split(batch, mb)
    per = split["tokens"].shape[1] // dp
    acc = leaves(tree_map(_zeros32, tree)) + [
        torch.zeros((), dtype=torch.float32, device=dev)]
    for i in range(mb):
        for r in range(dp):
            rows = slice(r * per, (r + 1) * per)
            (loss, _), grads = M.value_and_grad(
                params, {k: v[i, rows] for k, v in split.items()}, cfg)
            for a, g in zip(acc, leaves(grads)):
                a.add_(g.float())
            del grads
            acc[-1].add_(loss)
    n = dp * mb
    sums = (t.div_(n) for t in acc[:-1])
    if mb == 1:
        sums = (g.to(p.dtype) for g, p in zip(sums, leaves(tree)))
    return unflatten(tree, sums), acc[-1] / n


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip: float = 1.0,
                    compress: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})`` for a :class:`ParamTree` ``params`` and
    a batch of int64 tensors on its device.

    With ``cfg.num_microbatches = mb > 1`` microbatch ``i`` is batch rows
    ``[i·B/mb, (i+1)·B/mb)``; each one's gradients are added into float32
    accumulators and the sum divided by ``mb``, the loss likewise.  At
    ``mb = 1`` the gradients are cast back to the parameters' dtype (on
    one replica the bits of the pass's own gradients), so the clip
    of bfloat16 parameters runs in bfloat16, as the reference's does.
    Under ``use_sharding(rules)`` whose batch axes divide a microbatch's
    rows the step is data-parallel over them (module docstring)."""
    mb = cfg.num_microbatches

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        rules = current_rules()
        plan = batch_axes(rules, batch["tokens"].shape[0] // mb)
        grads, loss = _accumulate(params, batch, cfg, mb,
                                  *((plan[1], rules.mesh) if plan else ()))

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
    """``prefill_step(params, tokens)``: the last token's logits.  With
    placed parameters (:func:`~repro_torch.parallel.tensor.place_params`)
    under ``use_sharding(rules)`` it runs the model split, as the model
    functions it calls do; the train step above never does."""
    def prefill_step(params, tokens):
        logits, _ = M.forward(params, tokens, cfg, last_only=True)
        return logits
    return prefill_step


def make_decode_step(cfg):
    """``decode_step(params, cache, tokens, pos)``: one token, the cache
    written in place; split over ``model`` as :func:`make_prefill_step`."""
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg)
    return decode_step
