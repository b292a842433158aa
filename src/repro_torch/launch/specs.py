"""Meta stand-ins and per-leaf specs for every (arch × shape) cell.

The port of ``repro/launch/specs.py``.  Nothing is allocated on any
device: the parameters, AdamW's state and the decode caches are ``meta``
tensors built by the port's own initialisers (``init_params(cfg,
device="meta")`` draws nothing, ``make_opt_state`` and ``init_cache``
follow it there), the batch is synthesized, and the specs come from the
rule tables (:mod:`repro_torch.parallel.params`).  Where the reference
hands ``jax.jit`` its ``in_shardings`` / ``out_shardings``, a cell here
carries the per-leaf :class:`~repro_torch.parallel.PartitionSpec` trees
(``in_specs`` / ``out_specs``, congruent with ``args`` / ``outs``), and
:func:`block_bytes` sums what one mesh position holds of them: the
counterpart of XLA's ``memory_analysis``.

The token stand-ins are int32, the reference's dtype and the one the data
pipeline (:class:`repro_torch.data.TokenDataset`) yields; the decode
position is the reference's int32 0-d argument.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs import SHAPES, ShapeCfg, get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel.params import (cache_specs_for, param_specs_for,
                                         rules_for)
from repro_torch.parallel.sharding import NamedSharding, PartitionSpec as P

META = torch.device("meta")

#: bytes of one entry of the index table of a tuple-shaped XLA result: the
#: reference's ``output_size_in_bytes`` counts it once per output leaf
TUPLE_ENTRY_BYTES = 8


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_spec(cfg, shape: ShapeCfg, rules):
    """({tokens, labels} int32 meta stand-ins, their specs)."""
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    sds = {"tokens": _meta(tok_shape, torch.int32),
           "labels": _meta(tok_shape, torch.int32)}
    spec = rules.spec(("batch", "seq") + (None,) * (len(tok_shape) - 2),
                      tok_shape)
    return sds, {"tokens": spec, "labels": spec}


def _logits(cfg, rows: int, batch_axis: str, rules):
    """The last-token logits (rows, 1, V) | (rows, 1, K, V) in the compute
    dtype, and their spec: rows over the batch axes, the vocabulary over
    ``model`` (what GSPMD gives the reference's unconstrained output)."""
    if cfg.n_codebooks == 1:
        shape, axes = (rows, 1, cfg.vocab_size), (batch_axis, None, "vocab")
    else:
        shape = (rows, 1, cfg.n_codebooks, cfg.vocab_size)
        axes = (batch_axis, None, None, "vocab")
    return (_meta(shape, getattr(torch, cfg.compute_dtype)),
            rules.spec(axes, shape))


def cell_specs(arch: str, shape_name: str, mesh,
               overrides: dict | None = None,
               cfg=None) -> Dict[str, Any]:
    """Everything needed to count one dry-run cell (``shape_name`` a name
    of ``SHAPES`` or a :class:`~repro_torch.configs.ShapeCfg`).

    Returns {fn, args (meta), in_specs, outs (meta), out_specs,
    donate_argnums, rules, cfg, shape}: ``fn`` is the port's step,
    ``args`` its arguments (the parameters a meta
    :class:`~repro_torch.models.model.ParamTree`), ``outs`` the results the
    reference's step returns (train: parameters, optimizer state and the
    three float32 metrics; prefill: the logits; decode: the logits and the
    cache).  Spec trees mirror ``args`` (parameters as ``.tree()``) and
    ``outs``.
    """
    cfg = cfg or get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeCfg)
             else SHAPES[shape_name])
    rules = rules_for(cfg, mesh, overrides)

    params = M.init_params(cfg, device=META)
    p_specs = param_specs_for(cfg, params.tree(), rules)

    if shape.kind == "train":
        opt = steps_mod.make_opt_state(params)
        # moments share the param specs + ZeRO data-axis extension
        o_specs = _opt_specs(p_specs, opt, mesh)
        b_sds, b_specs = batch_spec(cfg, shape, rules)
        metrics = {k: _meta((), torch.float32)
                   for k in ("loss", "grad_norm", "lr")}
        return dict(
            fn=steps_mod.make_train_step(cfg),
            args=(params, opt, b_sds),
            in_specs=(p_specs, o_specs, b_specs),
            outs=(params.tree(), opt, metrics),
            out_specs=(p_specs, o_specs, {k: P() for k in metrics}),
            donate_argnums=(0, 1), rules=rules, cfg=cfg, shape=shape)

    if shape.kind == "prefill":
        b_sds, b_specs = batch_spec(cfg, shape, rules)
        logits, l_spec = _logits(cfg, shape.global_batch, "batch", rules)
        return dict(
            fn=steps_mod.make_prefill_step(cfg),
            args=(params, b_sds["tokens"]),
            in_specs=(p_specs, b_specs["tokens"]),
            outs=logits, out_specs=l_spec,
            donate_argnums=(), rules=rules, cfg=cfg, shape=shape)

    # decode: one new token against a seq_len cache
    b, s = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, b, s, device=META)
    c_specs = cache_specs_for(cfg, cache, rules)
    tok_shape = (b, 1) if cfg.n_codebooks == 1 else (b, 1, cfg.n_codebooks)
    tok_spec = rules.spec(
        ("cache_batch",) + (None,) * (len(tok_shape) - 1), tok_shape)
    logits, l_spec = _logits(cfg, b, "cache_batch", rules)
    return dict(
        fn=steps_mod.make_decode_step(cfg),
        args=(params, cache, _meta(tok_shape, torch.int32),
              _meta((), torch.int32)),
        in_specs=(p_specs, c_specs, tok_spec, P()),
        outs=(logits, cache), out_specs=(l_spec, c_specs),
        donate_argnums=(1,), rules=rules, cfg=cfg, shape=shape)


def _zero_extend(spec: P, shape, mesh) -> P:
    """ZeRO-style optimizer-state sharding: additionally shard one free dim
    of each moment over the data axes.  Moments are touched once per step
    (the AdamW update is elementwise), so the extra layout costs nothing in
    the step and divides optimizer memory by the DP degree — without it,
    deepseek-v2's float32 moments are 121 GB a chip (the reference's
    measurement) and cannot deploy.
    """
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not dp_axes:
        return spec
    dp = 1
    for a in dp_axes:
        dp *= mesh.shape[a]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p_ in parts:
        for a in ((p_,) if isinstance(p_, str) else (p_ or ())):
            used.add(a)
    if any(a in used for a in dp_axes):
        return spec
    # largest free, divisible dim gets the data axes
    cands = [(shape[i], i) for i, p_ in enumerate(parts)
             if p_ is None and shape[i] % dp == 0]
    if not cands:
        return spec
    _, i = max(cands)
    parts[i] = dp_axes[0] if len(dp_axes) == 1 else dp_axes
    return P(*parts)


def _opt_specs(p_specs, opt_shape, mesh=None):
    """Adam state specs: moments mirror params + ZeRO data-axis extension;
    scalar step replicated."""
    if mesh is not None:
        moments = (opt_shape.m if isinstance(opt_shape, AdamWState)
                   else opt_shape["adam"].m)
        m_specs = tree_map(lambda s, l: _zero_extend(s, l.shape, mesh),
                           p_specs, moments)
    else:
        m_specs = p_specs
    if isinstance(opt_shape, AdamWState):
        return AdamWState(P(), m_specs, m_specs)
    return {"adam": AdamWState(P(), m_specs, m_specs),
            "residual": m_specs}


def _tree(x):
    """A ParamTree as its plain tree; anything else as it is."""
    return x.tree() if isinstance(x, M.ParamTree) else x


def block_bytes(tree, specs, mesh, coords=None) -> int:
    """Bytes of the blocks of every leaf of ``tree`` that mesh position
    ``coords`` (default the first) holds under ``specs`` (a congruent tree
    of specs): each block is the one
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives that
    position, computed for it alone (``NamedSharding.index``)."""
    coords = mesh.coords(0) if coords is None else tuple(coords)
    total = 0
    for leaf, spec in zip(leaves(_tree(tree)), leaves(specs)):
        shape = tuple(leaf.shape)
        block = NamedSharding(mesh, spec).index(coords, shape)
        n = math.prod(len(range(*sl.indices(d))) for sl, d in zip(block, shape))
        total += n * leaf.element_size()
    return total


def stacked_leaves(tree) -> int:
    """Leaves of ``tree`` as the reference lays it out: it stacks each
    segment's layers, so a list of per-layer subtrees (a segment of the
    parameters, moments or caches) counts as one layer's leaves."""
    tree = _tree(tree)
    if isinstance(tree, list) and tree and all(
            isinstance(t, dict) or hasattr(t, "_fields") for t in tree):
        return stacked_leaves(tree[0])
    if isinstance(tree, dict):
        return sum(stacked_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return sum(stacked_leaves(v) for v in tree)
    return 1


def memory_fields(spec, mesh) -> Dict[str, int]:
    """The reference's three ``memory_analysis`` sizes for one position:
    ``argument_size_in_bytes`` (every argument's block),
    ``alias_size_in_bytes`` (the donated arguments': the port updates them
    in place) and ``output_size_in_bytes`` (every result's block, plus
    :data:`TUPLE_ENTRY_BYTES` a leaf where the result has more than one
    leaf: XLA's tuple index table, kept so that the number is the
    reference's, counted over the reference's stacked leaves
    (:func:`stacked_leaves`); the port's step returns Python objects)."""
    args, in_specs = spec["args"], spec["in_specs"]
    arg = sum(block_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    alias = sum(block_bytes(args[i], in_specs[i], mesh)
                for i in spec["donate_argnums"])
    out = block_bytes(spec["outs"], spec["out_specs"], mesh)
    n_out = stacked_leaves(spec["outs"])
    if n_out > 1:
        out += TUPLE_ENTRY_BYTES * n_out
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "alias_size_in_bytes": alias}
