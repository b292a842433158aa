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
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (MetaDraws, embed_init, rmsnorm,
                                      rmsnorm_init)
from repro_torch.optim.tree import unflatten
from repro_torch.parallel.sharding import pshard


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


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` while autograd records; else ``fn``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_contexts)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def forward(params, tokens, cfg, *, last_only: bool = False):
    """Causal forward.  tokens (B, S[, K]) → (logits (B, S|1, V[, K])
    in the compute dtype, MoE aux loss (float32 scalar))."""
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


def loss_fn(params, batch, cfg):
    """batch: {tokens (B,S[,K]), labels (B,S[,K])} → (loss, metrics)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, batch["labels"][..., None])
    ce = -ll.mean()
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params, batch, cfg):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on a
    :class:`ParamTree`: ((loss, metrics), grads) with the grads a tree shaped
    as ``params.tree()`` in the parameters' dtypes, the loss and metrics
    detached.  The leaves record gradients only inside this call."""
    leaves = list(params.parameters())
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(params.tree(), grads))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_max: int, device="cuda") -> List[list]:
    """Zeroed caches: per segment, per layer (the reference's is stacked)."""
    dev = resolve_device(device)
    cdt = _dtype(cfg.compute_dtype)
    return [[tfm.cache_init(kind, cfg, batch, s_max, cdt, dev)
             for _ in range(count)] for kind, count in cfg.segments]


def decode_step(params, cache, tokens, pos: int, cfg):
    """One token for the whole batch.  tokens (B, 1[, K]); pos the
    position it takes.  Attention caches are written in place; returns
    (logits (B, 1, V[, K]), the caches)."""
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
    states carry their end-of-prompt value.
    """
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
