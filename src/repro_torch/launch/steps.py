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
* parameters placed by their specs
  (:class:`~repro_torch.parallel.tensor.PlacedParams`, what
  :func:`repro_torch.launch.train.build` returns where the rules split a
  leaf over ``model``) split each pass over ``model`` as the reference's
  GSPMD step does: replica ``r``'s pass runs the model split bound to its
  row block and positions (:meth:`~repro_torch.parallel.tensor.ModelSplit.
  bind`), its backward through the collectives' transposes; the
  gradients, the float32 accumulators, AdamW's ``m`` and ``v`` and the
  compression residual are :class:`~repro_torch.parallel.ShardedTensor` s
  with the parameters' shardings, held once on the one device of every
  position; the clip's sum of squares is each unit's over its distinct
  blocks, summed over ``model`` (one ``all-reduce``), and AdamW and
  compression update each distinct block once (on one device: each
  element once);
* a :class:`~repro_torch.models.model.ParamTree` is replicated over
  ``model``: every position of the mesh must be on the parameters'
  device, which holds the state once;
* where the batch axes do not divide the rows, or span one position, the
  step on a ``ParamTree`` is the one-device step, bit for bit.

So the step on ``dp`` replicas is the step on one replica at ``dp·mb``
microbatches, bit for bit, placed or not.  Against ``mb`` on one replica
only the order of the sums differs, but for MoE: its load-balance term is
not linear in the rows (``E·Σ pe·fe`` over the tokens a pass sees), so the
mean of the replicas' terms is not the term of the whole microbatch
(``tests/test_torch_parallel.py`` measures it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.mesh import psum_axes
from repro_torch.models import model as M
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_error_feedback, cosine_schedule)
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.tree import leaves, tree_map, unflatten
from repro_torch.parallel.sharding import (ShardedTensor, _axes,
                                           current_rules, pshard)
from repro_torch.parallel.tensor import MODEL, PlacedParams, zeros


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


def _zeros_placed(st, dtype=torch.float32) -> ShardedTensor:
    """A zeroed tensor placed as ``st`` is."""
    return zeros(st.shape, dtype, st.mesh, st.spec)


def _accumulate_placed(params: PlacedParams, batch, cfg, mb: int):
    """:func:`_accumulate` on placed parameters, under the rules of their
    mesh: microbatch ``i``, then replica ``r``, each pass the model split
    bound to replica ``r`` (module docstring); float32 accumulators placed
    by the parameters' specs, one set whatever ``dp``."""
    split = _split(batch, mb)
    whole = M.model_split(params, split["tokens"][0], cfg)
    dp, per = whole.dp, whole.rows
    acc = tree_map(_zeros_placed, params)
    total = torch.zeros((), dtype=torch.float32, device=params.mesh.home)
    for i in range(mb):
        for r in range(dp):
            rows = slice(r * per, (r + 1) * per)
            (loss, _), grads = M.value_and_grad(
                params, {k: v[i, rows] for k, v in split.items()}, cfg,
                split=whole.bind(r))
            for a, g in zip(leaves(acc), leaves(grads)):
                a.local().add_(g.local().float())
            del grads
            total.add_(loss)
    n = dp * mb
    for a in leaves(acc):
        a.local().div_(n)
    if mb == 1:
        acc = tree_map(lambda a, p: a.like(a.local().to(p.dtype)), acc,
                       params)
    return acc, total / n


def clip_placed(grads, max_norm: float):
    """:func:`~repro_torch.optim.clip_by_global_norm` on placed gradients:
    unit ``j`` of ``model`` takes the float32 sum of squares of its
    distinct blocks (its ``model`` block of each leaf split there, and at
    ``j = 0`` each leaf replicated over ``model``, so that such a leaf
    counts once), and the units' sums are summed over ``model`` (one
    counted ``all-reduce``).  Returns (clipped grads, ‖g‖)."""
    gl = leaves(grads)
    mesh = gl[0].mesh
    m = mesh.shape[MODEL]
    axis = mesh.axis_names.index(MODEL)
    sq = []
    for j in range(m):
        coords = tuple(j if a == axis else 0 for a in range(len(mesh.dims)))
        split_only = j > 0
        sq.append(sum((torch.sum(torch.square(st.block(coords).float()))
                       for st in gl if not split_only
                       or any(MODEL in _axes(e) for e in st.spec)),
                      torch.zeros((), dtype=torch.float32,
                                  device=mesh.devices[mesh.brick(*coords)])))
    parts = [sq[c[axis]] for c in (mesh.coords(b) for b in range(mesh.size))]
    norm = torch.sqrt(psum_axes(parts, mesh, MODEL)[0])
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda st: st.like(st.local() * scale.to(st.dtype)),
                    grads), norm


def _held(tree):
    """The one tensor of each placed leaf (a tensor leaf as it is)."""
    return tree_map(lambda t: t.local() if isinstance(t, ShardedTensor)
                    else t, tree)


def _like(like, values):
    """``values`` (tensors) placed as the leaves of ``like`` are, where
    those are placed."""
    return tree_map(lambda a, t: a.like(t) if isinstance(a, ShardedTensor)
                    else t, like, values)


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip: float = 1.0,
                    compress: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})`` for a :class:`ParamTree` ``params``
    (or placed ones) and a batch of int64 tensors on its device.

    With ``cfg.num_microbatches = mb > 1`` microbatch ``i`` is batch rows
    ``[i·B/mb, (i+1)·B/mb)``; each one's gradients are added into float32
    accumulators and the sum divided by ``mb``, the loss likewise.  At
    ``mb = 1`` the gradients are cast back to the parameters' dtype (on
    one replica the bits of the pass's own gradients), so the clip
    of bfloat16 parameters runs in bfloat16, as the reference's does.
    Under ``use_sharding(rules)`` whose batch axes divide a microbatch's
    rows the step is data-parallel over them; placed parameters
    (:class:`~repro_torch.parallel.tensor.PlacedParams`, under the rules
    of their mesh) also split each pass over ``model`` (module
    docstring)."""
    mb = cfg.num_microbatches

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        placed = isinstance(params, PlacedParams)
        if placed:
            grads, loss = _accumulate_placed(params, batch, cfg, mb)
        else:
            rules = current_rules()
            plan = batch_axes(rules, batch["tokens"].shape[0] // mb)
            grads, loss = _accumulate(params, batch, cfg, mb,
                                      *((plan[1], rules.mesh) if plan
                                        else ()))

        if compress:
            g, resid = compress_error_feedback(_held(grads),
                                               _held(opt_state["residual"]))
            grads = _like(grads, g)
            opt_state = dict(opt_state, residual=_like(grads, resid))

        grads, gnorm = (clip_placed if placed else clip_by_global_norm)(
            grads, clip)
        adam = opt_state["adam"] if isinstance(opt_state, dict) else opt_state
        step = _held(adam.step)
        lr = cosine_schedule(step + 1, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        # in place on the parameters' and moments' tensors (placed: their
        # one tensor each); the moments stay the trees they were
        _, held = adamw_update(_held(params if placed else params.tree()),
                               _held(grads), AdamWState(step, _held(adam.m),
                                                        _held(adam.v)), lr)
        adam = AdamWState(held.step, adam.m, adam.v)
        if isinstance(opt_state, dict):
            opt_state = dict(opt_state, adam=adam)
        else:
            opt_state = adam
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def make_opt_state(params, *, compress: bool = False):
    """AdamW's state for a :class:`ParamTree` (with a float32 zero residual
    per parameter when ``compress``), on the parameters' device.  For
    placed parameters ``m``, ``v`` and the residual are placed by the
    parameters' specs (the reference's ``adamw_init`` over placed
    parameters), the step on the mesh's home device."""
    if isinstance(params, PlacedParams):
        adam = AdamWState(torch.zeros((), dtype=torch.int32,
                                      device=params.mesh.home),
                          tree_map(_zeros_placed, params),
                          tree_map(_zeros_placed, params))
        if not compress:
            return adam
        return {"adam": adam, "residual": tree_map(_zeros_placed, params)}
    tree = params.tree()
    adam = adamw_init(tree)
    if not compress:
        return adam
    return {"adam": adam, "residual": tree_map(_zeros32, tree)}


def make_prefill_step(cfg):
    """``prefill_step(params, tokens)``: the last token's logits.  With
    placed parameters (:func:`~repro_torch.parallel.tensor.place_params`)
    under ``use_sharding(rules)`` it runs the model split, as the model
    functions it calls do, and as the train step above does."""
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
