"""Model-level API: init, forward/loss, prefill, decode.

The port of ``repro/models/model.py``.  Parameters are a :class:`ParamTree`
(a module whose parameters mirror the reference's pytree)::

    {"embed": (V, D) | (K, V, D),
     "segments": [per segment, per layer: block params],
     "shared": zamba2 shared block | absent,
     "final_ln": rmsnorm,
     "lm_head": (D, V) | (K, D, V) | absent (tied)}

The reference stacks a segment's layers and scans them; here each layer is
its own module in a ``ModuleList`` per segment and the layers run in a
Python loop, so ``scan_layers`` changes nothing.  ``remat`` acts where the
reference's does, on each layer of :func:`forward` while autograd records
(the train step): ``"full"`` recomputes the whole layer in the backward,
``"dots"`` saves the layer's products with no batch dims (the projections
``x @ W``, which dispatch as ``aten.mm``) and recomputes the rest (the
attention and expert einsums, ``aten.bmm``, and every elementwise op).
Neither changes a gradient.  Serving records nothing and runs the layers
as they are.  ``num_microbatches`` is read by the train step
(:func:`repro_torch.launch.steps.make_train_step`).  Caches are a list per
segment of per-layer caches.  Every entry point runs on the device of its
parameters; :func:`init_params` puts them on the card unless the caller
asks for the CPU, and raises where there is no card.

The parameters are frozen (``requires_grad=False``), so serving builds no
autograd graph; the train step records gradients for its own duration
only (:func:`value_and_grad`).

On a mesh: parameters placed by their specs
(:func:`repro_torch.parallel.tensor.place_params`) make :func:`forward`,
:func:`prefill`, :func:`decode_step` and :func:`value_and_grad` run the
model split by hand under ``use_sharding(rules)`` (:func:`model_split`):
GSPMD's split in the reference, for every block kind, in serving and in
the train step, the backward through the collectives' transposes
(:mod:`repro_torch.parallel.tensor`) and ``remat`` applied to each layer
as on one device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (MetaDraws, embed_init, rmsnorm,
                                      rmsnorm_init)
from repro_torch.optim.tree import leaves, unflatten
from repro_torch.parallel.sharding import current_rules, pshard
from repro_torch.parallel.tensor import ModelSplit, PlacedParams, place_cache


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each tensor a (frozen)
    ``nn.Parameter``, each dict a child ``ParamTree``, each list a
    ``ModuleList``.  ``tree[name]`` and ``name in tree`` read it as the
    reference's functions read a dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _as_module(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The plain nested dict of tensors, each cast to ``dtype`` (the
        reference's per-layer ``astype(compute_dtype)``) unless None."""
        out: Dict[str, Any] = {
            k: p if dtype is None else p.to(dtype)
            for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = _tree(m, dtype)
        return out


def _tree(module: nn.Module, dtype):
    if isinstance(module, ParamTree):
        return module.tree(dtype)
    return [_tree(m, dtype) for m in module]


def _as_module(value) -> nn.Module:
    if isinstance(value, dict):
        return ParamTree(value)
    return nn.ModuleList([_as_module(v) for v in value])


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters with the reference's distributions and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    On ``device="meta"`` nothing is drawn: every leaf is an empty meta
    tensor of its shape and dtype (:class:`~repro_torch.models.layers.
    MetaDraws`), the dry-run's parameters."""
    dev = resolve_device(device)
    gen = (MetaDraws() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dtype = _dtype(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.n_codebooks > 1:
        params["embed"] = torch.stack([
            embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
            for _ in range(cfg.n_codebooks)])
    else:
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    params["segments"] = [[tfm.block_init(gen, kind, cfg, dtype)
                           for _ in range(count)]
                          for kind, count in cfg.segments]
    if any(kind == "mamba_shared" for kind, _ in cfg.segments):
        params["shared"] = tfm.shared_block_init(gen, cfg, dtype)
    params["final_ln"] = rmsnorm_init(gen, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        if cfg.n_codebooks > 1:
            params["lm_head"] = torch.stack([
                embed_init(gen, cfg.d_model, cfg.vocab_size, dtype)
                for _ in range(cfg.n_codebooks)])
        else:
            params["lm_head"] = embed_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype)
    return ParamTree(params)


def _shared_ctx(params, cfg, cdt):
    if "shared" not in params:
        return None
    return params["shared"].tree(cdt), tfm.shared_config(cfg)


def _embed(params, tokens, cfg):
    if cfg.n_codebooks > 1:                      # (B, S, K) EnCodec frames
        x = params["embed"][0][tokens[..., 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + params["embed"][k][tokens[..., k]]
        return x
    return params["embed"][tokens]


def _layers(params, cfg, cdt):
    """(kind, layer params cast to ``cdt``) for every layer in order."""
    for (kind, _), seg in zip(cfg.segments, params["segments"]):
        for layer in seg:
            yield kind, layer.tree(cdt)


#: the products that ``remat="dots"`` saves: ``x @ W`` of an activation
#: and a weight (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)
SAVED_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, cfg, *, early_stop: bool = True):
    """``fn`` under ``cfg.remat`` while autograd records; else ``fn``.
    ``early_stop=False`` makes the backward's recompute run the whole of
    ``fn`` again, as the reference's rematerialized layer does: the model
    split's reductions with it, so a step counts each of them twice
    whatever the layer saves."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": _dots_contexts}
    else:
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def run(*a):
        with set_checkpoint_early_stop(early_stop):
            return checkpoint(fn, *a, use_reentrant=False, **kw)
    return run


def forward(params, tokens, cfg, *, last_only: bool = False, split=None):
    """Causal forward.  tokens (B, S[, K]) → (logits (B, S|1, V[, K])
    in the compute dtype, MoE aux loss (float32 scalar)).  Placed
    parameters run the model split (:func:`model_split`), or ``split``
    where the caller gives one (a replica's, :meth:`~repro_torch.parallel.
    tensor.ModelSplit.bind`)."""
    split = split or model_split(params, tokens, cfg)
    if split is not None:
        return _forward_split(split, params, tokens, cfg, last_only)
    cdt = _dtype(cfg.compute_dtype)
    x = pshard(_embed(params, tokens, cfg).to(cdt), "batch", "seq", "embed")
    x_embed = x
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    shared = _shared_ctx(params, cfg, cdt)

    def body(x, kind, layer):
        return tfm.block_apply(kind, layer.tree(cdt), x, cfg, pos,
                               shared=shared, x_embed=x_embed)

    body = _remat(body, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, _), seg in zip(cfg.segments, params["segments"]):
        for layer in seg:
            x, aux = body(x, kind, layer)
            if aux is not None:
                aux_total = aux_total + aux

    x = rmsnorm(params["final_ln"], x)
    if last_only:
        x = x[:, -1:, :]
    return _lm_head(params, x, cfg), aux_total


def _lm_head(params, x, cfg):
    cdt = x.dtype
    if cfg.n_codebooks > 1:
        return torch.einsum("bsd,kdv->bskv", x, params["lm_head"].to(cdt))
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cdt).T
    return x @ params["lm_head"].to(cdt)


def loss_fn(params, batch, cfg, split=None):
    """batch: {tokens (B,S[,K]), labels (B,S[,K])} → (loss, metrics);
    ``split`` as in :func:`forward`."""
    logits, aux = forward(params, batch["tokens"], cfg, split=split)
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, batch["labels"][..., None])
    ce = -ll.mean()
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params, batch, cfg, split=None):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the loss and metrics detached.  On a :class:`ParamTree` the
    grads are a tree shaped as ``params.tree()`` in the parameters'
    dtypes.  On :class:`~repro_torch.parallel.tensor.PlacedParams` (every
    position on one device) the pass runs the model split (``split``, or
    the batch's under the current rules) and records gradients on each
    leaf's one tensor, whose blocks the units compute with; the grads are
    a tree of :class:`~repro_torch.parallel.ShardedTensor` s with the
    parameters' shardings.  The leaves record gradients only inside this
    call."""
    placed = isinstance(params, PlacedParams)
    if placed:
        split = split or model_split(params, batch["tokens"], cfg)
        held = [_recording(st) for st in leaves(params)]
    else:
        held = list(params.parameters())
    with torch.enable_grad():
        for p in held:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch, cfg, split=split)
            grads = torch.autograd.grad(loss, held)
        finally:
            for p in held:
                p.requires_grad_(False)
    if placed:
        grads = unflatten(params, (st.like(g) for st, g
                                   in zip(leaves(params), grads)))
    else:
        grads = unflatten(params.tree(), grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def _recording(st) -> torch.Tensor:
    """The one tensor that holds placed leaf ``st``: what its gradient is
    recorded on."""
    try:
        return st.local()
    except ValueError:
        raise ValueError("the placed train step records gradients on the "
                         "one tensor of each leaf: every position of the "
                         "mesh on one device") from None


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_max: int, device="cuda",
               rules=None) -> List[list]:
    """Zeroed caches: per segment, per layer (the reference's is stacked).
    With ``rules`` each leaf is placed on ``rules.mesh`` by
    ``cache_specs_for`` (the decode cache of placed parameters)."""
    dev = resolve_device(device)
    cdt = _dtype(cfg.compute_dtype)
    cache = [[tfm.cache_init(kind, cfg, batch, s_max, cdt, dev)
              for _ in range(count)] for kind, count in cfg.segments]
    return cache if rules is None else place_cache(cache, rules, cfg)


def decode_step(params, cache, tokens, pos: int, cfg, *, split=None):
    """One token for the whole batch.  tokens (B, 1[, K]); pos the
    position it takes.  Attention caches are written in place; returns
    (logits (B, 1, V[, K]), the caches).  Placed parameters run the model
    split on the placed cache that their prefill returned, or ``split``
    where the caller gives one (a replica's, as :func:`forward`)."""
    split = split or model_split(params, tokens, cfg)
    if split is not None:
        return _decode_split(split, params, cache, tokens, pos, cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(params, tokens, cfg).to(cdt)
    x_embed = x
    shared = _shared_ctx(params, cfg, cdt)
    flat = [c for seg in cache for c in seg]
    new = []
    for (kind, layer), lc in zip(_layers(params, cfg, cdt), flat):
        x, lc = tfm.block_decode(kind, layer, x, lc, cfg, pos, shared=shared,
                                 x_embed=x_embed)
        new.append(lc)
    x = rmsnorm(params["final_ln"], x)
    return _lm_head(params, x, cfg), _regroup(new, cfg)


def _regroup(flat, cfg) -> List[list]:
    out, i = [], 0
    for _, count in cfg.segments:
        out.append(flat[i:i + count])
        i += count
    return out


def prefill(params, tokens, cfg, s_max: int):
    """Run the prompt, return (last-token logits, filled caches).

    Attention/MLA caches hold positions [0, S) of ``s_max``; recurrent
    states carry their end-of-prompt value.  Placed parameters run the
    model split, and their caches come back placed: the sequence over
    ``model``, the rows over the batch axes (the reference's
    ``cache_specs_for``).
    """
    split = model_split(params, tokens, cfg)
    if split is not None:
        return _prefill_split(split, params, tokens, cfg, s_max)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(params, tokens, cfg).to(cdt)
    x_embed = x
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    shared = _shared_ctx(params, cfg, cdt)
    caches = []
    for kind, layer in _layers(params, cfg, cdt):
        x, lc, _ = tfm.block_prefill(kind, layer, x, cfg, pos, s_max,
                                     shared=shared, x_embed=x_embed)
        caches.append(lc)
    x = rmsnorm(params["final_ln"], x[:, -1:, :])
    return _lm_head(params, x, cfg), _regroup(caches, cfg)


# ---------------------------------------------------------------------------
# the model split: serving on a mesh, the model axis by hand
# ---------------------------------------------------------------------------

def model_split(params, tokens, cfg) -> Optional[ModelSplit]:
    """The model split of a call (:mod:`repro_torch.parallel.tensor`), or
    None for a :class:`ParamTree`, which runs as on one device under any
    rules (the data-parallel train step's passes too).  Placed parameters
    (:func:`~repro_torch.parallel.tensor.place_params`) run under
    ``use_sharding(rules)`` of their mesh, in serving and in the train
    step alike."""
    if not isinstance(params, PlacedParams):
        return None
    rules = current_rules()
    if rules is None or rules.mesh is not params.mesh:
        raise ValueError("placed parameters run under use_sharding(rules) "
                         "of the mesh they are placed on")
    return ModelSplit(rules, tokens.shape[0], _dtype(cfg.compute_dtype))


def _split_layers(params, cfg):
    for (kind, _), seg in zip(cfg.segments, params["segments"]):
        for layer in seg:
            yield kind, layer


def _shared_split(params, cfg):
    """The placed zamba2 shared block and its config, or None."""
    if "shared" not in params:
        return None
    return params["shared"], tfm.shared_config(cfg)


def _embed_split(split, params, tokens, cfg):
    """:func:`_embed` on the vocab-sharded table, lists a row block in the
    compute dtype: each unit looks up the ids in its vocab rows and writes
    zeros elsewhere, and the units' lookups are summed over ``model`` —
    one non-zero term a token, so the sum is the lookup bit for bit (the
    codebooks' lookups are summed over ``model`` each, then over codebooks
    in order, as on one device)."""
    emb = params["embed"]
    vdim = len(emb.shape) - 2
    parts = []
    for r, t in enumerate(split.rows_of(tokens)):
        row = []
        for j in range(split.parts(emb, vdim)):
            blk = split.block(emb, r, j)
            first = split.index(emb, r, j)[vdim].start or 0
            ids = split.on(t, r, j) - first
            hit = (ids >= 0) & (ids < blk.shape[vdim])
            ids = torch.where(hit, ids, 0)
            if cfg.n_codebooks > 1:
                row.append(torch.stack([
                    torch.where(hit[..., k, None], blk[k][ids[..., k]], 0.0)
                    for k in range(cfg.n_codebooks)]))
            else:
                row.append(torch.where(hit[..., None], blk[ids], 0.0))
        parts.append(row)
    xs = split.psum(parts)
    if cfg.n_codebooks > 1:
        xs = [functools.reduce(torch.add, x.unbind(0)) for x in xs]
    return [x.to(split.dtype) for x in xs]


def _lm_head_split(split, params, xs, cfg):
    """:func:`_lm_head` with each unit's vocab block of the logits (tied,
    untied, per codebook), gathered over ``model`` a row block, so that an
    ``argmax`` breaks ties at the lowest id as on one device."""
    if cfg.n_codebooks > 1:
        w, vdim = params["lm_head"], 2
        head = lambda x, blk: torch.einsum("bsd,kdv->bskv", x, blk)  # noqa: E731
    elif cfg.tie_embeddings:
        w, vdim = params["embed"], 0
        head = lambda x, blk: x @ blk.T                              # noqa: E731
    else:
        w, vdim = params["lm_head"], 1
        head = lambda x, blk: x @ blk                                # noqa: E731
    return [split.gather([head(xj, split.block(w, r, j).to(x.dtype))
                          for j, xj in enumerate(
                              split.fan(x, r, split.parts(w, vdim)))], -1, r)
            for r, x in enumerate(xs)]


def _final(split, params, xs, cfg, last_only: bool):
    xs = [rmsnorm(split.local(params["final_ln"], r, 0),
                  x[:, -1:, :] if last_only else x) for r, x in enumerate(xs)]
    return split.join(_lm_head_split(split, params, xs, cfg))


def _forward_split(split, params, tokens, cfg, last_only: bool):
    """:func:`forward` on the model split, ``cfg.remat`` on each layer
    while autograd records (its recompute runs the whole layer, its
    reductions included: :func:`_remat` without early stop)."""
    xs = x_embed = _embed_split(split, params, tokens, cfg)
    pos = torch.arange(xs[0].shape[1], dtype=torch.int32, device=xs[0].device)
    aux_total = torch.zeros((), dtype=torch.float32, device=split.mesh.home)
    shared = _shared_split(params, cfg)

    def body(xs, kind, layer):
        xs, _, aux = tfm.block_prefill_split(kind, split, layer, xs, cfg, pos,
                                             None, shared, x_embed)
        return xs, aux

    body = _remat(body, cfg, early_stop=False)
    for kind, layer in _split_layers(params, cfg):
        xs, aux = body(xs, kind, layer)
        if aux is not None:
            aux_total = aux_total + aux
    return _final(split, params, xs, cfg, last_only), aux_total


def _prefill_split(split, params, tokens, cfg, s_max: int):
    xs = x_embed = _embed_split(split, params, tokens, cfg)
    pos = torch.arange(xs[0].shape[1], dtype=torch.int32, device=xs[0].device)
    shared = _shared_split(params, cfg)
    caches = []
    for kind, layer in _split_layers(params, cfg):
        xs, lc, _ = tfm.block_prefill_split(kind, split, layer, xs, cfg, pos,
                                            s_max, shared, x_embed)
        caches.append(lc)
    return _final(split, params, xs, cfg, True), _regroup(caches, cfg)


def _decode_split(split, params, cache, tokens, pos: int, cfg):
    xs = x_embed = _embed_split(split, params, tokens, cfg)
    shared = _shared_split(params, cfg)
    flat = [c for seg in cache for c in seg]
    new = []
    for (kind, layer), lc in zip(_split_layers(params, cfg), flat):
        xs, lc = tfm.block_decode_split(kind, split, layer, xs, lc, cfg, pos,
                                        shared, x_embed)
        new.append(lc)
    return _final(split, params, xs, cfg, False), _regroup(new, cfg)
