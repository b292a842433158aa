"""Parameter logical axes, resolved by leaf name (the model is the repo's
own, so the name table is exhaustive; anything unknown is replicated).

The port of ``repro/parallel/params.py``, over the port's trees:
``param_specs_for(cfg, params_like, rules)`` gives a tree of
:class:`~repro_torch.parallel.sharding.PartitionSpec` shaped as
``params_like`` (``ParamTree.tree()``), ``cache_specs_for`` the same for a
decode cache (per segment, per layer, ``NamedTuple`` leaves by field).  A
leaf's name is its last dict key or ``NamedTuple`` field.  The port's
layers are not stacked, so a per-layer leaf's spec is the reference's
without its leading ``None``.  Leaves need only ``.shape``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.optim.tree import leaves_with_path, unflatten
from repro_torch.parallel.sharding import ShardingRules

# leaf name → logical axes (without the stacked-layer leading axis)
_NAME_AXES = {
    # attention
    "wq": ("embed", "heads_flat"), "wk": ("embed", "heads_flat"),
    "wv": ("embed", "heads_flat"), "wo": ("heads_flat", "embed"),
    "q_norm": (None,), "k_norm": (None,),
    # mlp
    "up": ("embed", "mlp"), "gate": ("embed", "mlp"),
    "down": ("mlp", "embed"),
    # moe
    "router": ("embed", None),
    "w_gate": ("experts", "embed", "expert_mlp"),
    "w_up": ("experts", "embed", "expert_mlp"),
    "w_down": ("experts", "expert_mlp", "embed"),
    # mla
    "wq_a": ("embed", "q_lora"), "wq_b": ("q_lora", "heads_flat"),
    "wkv_a": ("embed", None), "wkv_b": ("kv_lora", "heads_flat"),
    # mamba2
    "in_proj": ("embed", "conv_dim"), "out_proj": ("ssm_inner", "embed"),
    "conv_w": (None, "conv_dim"), "conv_b": ("conv_dim",),
    "dt_bias": (None,), "a_log": (None,), "d_skip": (None,),
    # rwkv6
    "wr": ("embed", "heads_flat"), "wg": ("embed", "heads_flat"),
    "mu": (None, None), "ts_a": ("embed", None), "ts_b": (None, None, None),
    "w0": (None,), "w_a": ("embed", None), "w_b": (None, None),
    "u": (None,), "mu_k": (None,), "mu_r": (None,),
    # norms / embeddings / heads
    "scale": (None,),
    "embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
    "out": (None, "embed"),       # zamba shared out-proj (2D → D)
}

# extra logical axes used only here
_EXTRA_RULES = {
    "heads_flat": "model",
    "ssm_inner": "model",
}


def rules_for(cfg, mesh, overrides: Optional[dict] = None) -> ShardingRules:
    """Build the rule table for a config (applying its overrides)."""
    table = dict(_EXTRA_RULES)
    table.update(dict(cfg.sharding_overrides))
    if overrides:
        table.update(overrides)
    return ShardingRules(mesh, table)


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _specs(table, tree, rules: ShardingRules):
    specs = []
    for path, leaf in leaves_with_path(tree):
        axes = table.get(_leaf_name(path))
        shape = tuple(leaf.shape)
        if axes is None:
            specs.append(rules.spec([None] * len(shape), shape))
            continue
        if len(axes) < len(shape):     # codebooks prefix
            axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
        specs.append(rules.spec(axes, shape))
    return unflatten(tree, specs)


def param_specs_for(cfg, params_like, rules: ShardingRules):
    """PartitionSpec tree congruent with ``params_like``."""
    return _specs(_NAME_AXES, params_like, rules)


# cache leaf axes by (named-tuple field) name
_CACHE_AXES = {
    "k": ("cache_batch", "cache_seq", "cache_heads", None),
    "v": ("cache_batch", "cache_seq", "cache_heads", None),
    "c_kv": ("cache_batch", "cache_seq", None),
    "k_rope": ("cache_batch", "cache_seq", None),
    "tm_shift": ("cache_batch", None),
    "cm_shift": ("cache_batch", None),
    "wkv": ("cache_batch", "rwkv_heads", None, None),
    "conv": ("cache_batch", None, "conv_dim"),
    "ssm": ("cache_batch", "ssm_heads", None, None),
}


def cache_specs_for(cfg, cache_like, rules: ShardingRules):
    """PartitionSpec tree congruent with ``cache_like``."""
    return _specs(_CACHE_AXES, cache_like, rules)
