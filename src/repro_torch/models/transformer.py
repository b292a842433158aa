"""Block definitions + per-kind (init, apply, prefill, decode, cache)
dispatch.

The port of ``repro/models/transformer.py`` (with ``_block_prefill`` of
``repro/models/model.py``).  Every block kind is pre-norm residual.
``mamba_shared`` is the zamba2 shared-attention step: a Mamba2 block
followed by the globally-shared attention+MLP block applied to
``concat(x, x_embed)``; its parameters live once at model level and come
in as ``shared = (params, config)``.  ``block_prefill_split`` /
``block_decode_split`` run every kind over the model axis
(:mod:`repro_torch.parallel.tensor`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, mlp_apply_split, mlp_init,
                                      normal, rmsnorm, rmsnorm_init)

ATTN_KINDS = ("attn", "attn_moe", "mla", "mla_moe")
SSM_KINDS = ("mamba", "mamba_shared")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def block_init(gen, kind: str, cfg, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    if kind in ATTN_KINDS:
        p = {"ln1": rmsnorm_init(gen, d, dtype),
             "ln2": rmsnorm_init(gen, d, dtype)}
        if kind.startswith("mla"):
            p["attn"] = mla_mod.mla_init(gen, cfg, dtype)
        else:
            p["attn"] = attn.attn_init(gen, cfg, dtype)
        if kind.endswith("moe"):
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, gated=cfg.gated_mlp)
        return p
    if kind == "rwkv":
        return {"ln1": rmsnorm_init(gen, d, dtype),
                "ln2": rmsnorm_init(gen, d, dtype),
                "tm": rwkv_mod.rwkv_init(gen, cfg, dtype),
                "cm": rwkv_mod.rwkv_ffn_init(gen, cfg, dtype)}
    if kind in SSM_KINDS:
        return {"ln1": rmsnorm_init(gen, d, dtype),
                "ssm": ssm_mod.ssm_init(gen, cfg, dtype)}
    raise ValueError(f"unknown block kind {kind}")


def shared_config(cfg):
    """The zamba2 shared block's attention config: width 2D over
    concat(x, x_embed), ``shared_n_heads`` full-MHA heads, full RoPE."""
    d2 = 2 * cfg.d_model
    return dataclasses.replace(
        cfg, d_model=d2, n_heads=cfg.shared_n_heads,
        n_kv_heads=cfg.shared_n_heads, head_dim=d2 // cfg.shared_n_heads,
        qk_norm=False, sliding_window=None, rope_fraction=1.0)


def shared_block_init(gen, cfg, dtype):
    """zamba2 shared attention+MLP over concat(x, x_embed) (width 2D)."""
    d2 = 2 * cfg.d_model
    return {
        "ln1": rmsnorm_init(gen, d2, dtype), "ln2": rmsnorm_init(gen, d2, dtype),
        "attn": attn.attn_init(gen, shared_config(cfg), dtype),
        "mlp": mlp_init(gen, d2, cfg.shared_d_ff, dtype, gated=True),
        "out": normal(gen, (d2, cfg.d_model), d2 ** -0.5, dtype),
    }


# ---------------------------------------------------------------------------
# apply (training / prefill)
# ---------------------------------------------------------------------------

def _ffn(kind, params, x, cfg):
    """The second residual half of an attention block: (x, aux)."""
    h = rmsnorm(params["ln2"], x)
    if kind.endswith("moe"):
        h, aux = moe_mod.moe_apply(params["moe"], h, cfg)
        return x + h, aux
    return x + mlp_apply(params["mlp"], h, act=cfg.mlp_act), None


def _shared_mlp(sp, x, xc):
    """The zamba2 shared block after its attention: the MLP on ``xc``
    (concat(x, x_embed) plus attention) projected back onto ``x``."""
    h = mlp_apply(sp["mlp"], rmsnorm(sp["ln2"], xc), act="silu")
    return x + (xc + h) @ sp["out"]


def block_apply(kind: str, params, x, cfg, pos, shared=None, x_embed=None):
    """Returns (x, aux) where aux is the MoE load-balance loss (or None)."""
    x, _, aux = block_prefill(kind, params, x, cfg, pos, None, shared,
                              x_embed)
    return x, aux


def _pad_cache(arr, s_max: int):
    """``arr`` (B, S, …) zero-padded along S to ``s_max``."""
    pad = arr.new_zeros((arr.shape[0], s_max - arr.shape[1]) + arr.shape[2:])
    return torch.cat([arr, pad], dim=1)


def block_prefill(kind: str, params, x, cfg, pos, s_max, shared=None,
                  x_embed=None):
    """One block over the whole sequence: (x, cache, aux).  With ``s_max``
    None no cache is built (the forward); else attention / MLA caches hold
    positions [0, S) of ``s_max`` and recurrent states their end-of-prompt
    value."""
    keep = s_max is not None
    cache = None
    if kind in ATTN_KINDS:
        prefill = (mla_mod.mla_prefill if kind.startswith("mla")
                   else attn.attn_prefill)
        h, *kv = prefill(params["attn"], rmsnorm(params["ln1"], x), cfg, pos)
        if keep:
            cache = (mla_mod.MLACache if kind.startswith("mla")
                     else attn.KVCache)(*(_pad_cache(a, s_max) for a in kv))
        x, aux = _ffn(kind, params, x + h, cfg)
        return x, cache, aux
    if kind == "rwkv":
        h = rmsnorm(params["ln1"], x)
        hh, _ = rwkv_mod.rwkv_time_mix(params["tm"], h, cfg)
        x = x + hh
        h2 = rmsnorm(params["ln2"], x)
        hh, _ = rwkv_mod.rwkv_channel_mix(params["cm"], h2)
        if keep:
            cache = rwkv_mod.RWKVState(h[:, -1, :], h2[:, -1, :],
                                       rwkv_final_state(params["tm"], h, cfg))
        return x + hh, cache, None
    if kind in SSM_KINDS:
        y, st = ssm_mod.ssm_prefill(params["ssm"], rmsnorm(params["ln1"], x),
                                    cfg)
        x = x + y
        if kind == "mamba":
            return x, st if keep else None, None
        sp, acfg = shared
        xc = torch.cat([x, x_embed], dim=-1)
        h, k, v = attn.attn_prefill(sp["attn"], rmsnorm(sp["ln1"], xc), acfg,
                                    pos)
        x = _shared_mlp(sp, x, xc + h)
        if keep:
            cache = {"ssm": st, "shared_kv": attn.KVCache(
                _pad_cache(k, s_max), _pad_cache(v, s_max))}
        return x, cache, None
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the model split (repro_torch.parallel.tensor): lists a row block
# ---------------------------------------------------------------------------

def _ffn_split(kind, split, params, xs, cfg):
    """:func:`_ffn` over the model axis: (xs, aux)."""
    hs = _norm_split(split, params["ln2"], xs)
    aux = None
    if kind.endswith("moe"):
        hs, aux = moe_mod.moe_apply_split(split, params["moe"], hs, cfg)
    else:
        hs = mlp_apply_split(split, params["mlp"], hs, cfg.mlp_act)
    return [x + h for x, h in zip(xs, hs)], aux


def block_prefill_split(kind: str, split, params, xs, cfg, pos, s_max,
                        shared=None, x_embed=None):
    """:func:`block_prefill` over the model axis: (xs, cache, aux), the
    norms once a row block on the replicated activations; ``shared`` the
    placed shared block and its config, ``x_embed`` the embedded tokens a
    row block (``mamba_shared``).  With ``s_max`` the attention caches'
    leaves are placed sequence-sharded (:func:`_place_kv`), the recurrent
    states by their heads or channels (:func:`_place_state`)."""
    keep = s_max is not None
    if kind == "rwkv":
        return _rwkv_prefill_split(split, params, xs, cfg, keep) + (None,)
    if kind in SSM_KINDS:
        return _ssm_prefill_split(kind, split, params, xs, cfg, pos, s_max,
                                  shared, x_embed) + (None,)
    hs = _norm_split(split, params["ln1"], xs)
    if kind.startswith("mla"):
        hs, *kv = mla_mod.mla_prefill_split(split, params["attn"], hs, cfg,
                                            pos)
        cache_type = mla_mod.MLACache
    else:
        hs, *kv = attn.attn_prefill_split(split, params["attn"], hs, cfg, pos)
        cache_type = attn.KVCache
    cache = None
    if keep:
        cache = cache_type(*(_place_kv(split, name, rows, s_max) for name, rows
                             in zip(cache_type._fields, kv)))
    xs, aux = _ffn_split(kind, split, params, [x + h for x, h in zip(xs, hs)],
                         cfg)
    return xs, cache, aux


def _norm_split(split, params, xs):
    """``rmsnorm`` of the replicated activations, once a row block."""
    return [rmsnorm(split.local(params, r, 0), x) for r, x in enumerate(xs)]


def _rwkv_prefill_split(split, params, xs, cfg, keep: bool):
    hs = _norm_split(split, params["ln1"], xs)
    out, wkv = rwkv_mod.rwkv_time_mix_split(split, params["tm"], hs, cfg,
                                            keep)
    xs = [x + h for x, h in zip(xs, out)]
    h2s = _norm_split(split, params["ln2"], xs)
    out = rwkv_mod.rwkv_channel_mix_split(split, params["cm"], h2s)
    cache = None
    if keep:
        cache = rwkv_mod.RWKVState(
            _place_state(split, "tm_shift", [[h[:, -1]] for h in hs], 1),
            _place_state(split, "cm_shift", [[h[:, -1]] for h in h2s], 1),
            _place_state(split, "wkv", wkv, 1))
    return [x + h for x, h in zip(xs, out)], cache


def _ssm_prefill_split(kind, split, params, xs, cfg, pos, s_max, shared,
                       x_embed):
    keep = s_max is not None
    ys, states = ssm_mod.ssm_prefill_split(
        split, params["ssm"], _norm_split(split, params["ln1"], xs), cfg,
        keep)
    xs = [x + y for x, y in zip(xs, ys)]
    st = None
    if keep:
        st = ssm_mod.SSMState(
            _place_state(split, "conv", [c for c, _ in states], 2),
            _place_state(split, "ssm", [s for _, s in states], 1))
    if kind == "mamba":
        return xs, st
    sp, acfg = shared
    xcs = [torch.cat([x, e], dim=-1) for x, e in zip(xs, x_embed)]
    hs, ks, vs = attn.attn_prefill_split(
        split, sp["attn"], _norm_split(split, sp["ln1"], xcs), acfg, pos)
    xs = _shared_mlp_split(split, sp, xs, [xc + h for xc, h in zip(xcs, hs)])
    cache = None
    if keep:
        cache = {"ssm": st, "shared_kv": attn.KVCache(
            _place_kv(split, "k", ks, s_max),
            _place_kv(split, "v", vs, s_max))}
    return xs, cache


def _shared_mlp_split(split, sp, xs, xcs):
    """:func:`_shared_mlp` over the model axis: the MLP split by ``mlp``
    (one reduction); ``out`` (``(None, "embed")``) is replicated, so each
    row block applies it whole."""
    hs = mlp_apply_split(split, sp["mlp"], _norm_split(split, sp["ln2"], xcs),
                         "silu")
    return [x + (xc + h) @ split.local(sp["out"], r, 0)
            for r, (x, xc, h) in enumerate(zip(xs, xcs, hs))]


def _place_kv(split, name: str, rows, s_max: int):
    """:func:`_pad_cache` on the mesh: cache leaf ``name`` (B, s_max, …)
    placed by the rules' cache axes (the sequence over ``model``), with
    each row block's prefill values written into the blocks that own their
    positions and zeros after them."""
    shape = (split.dp * split.rows, s_max) + tuple(rows[0].shape[2:])
    st = split.cache_zeros(name, shape, rows[0].dtype)
    for r, a in enumerate(rows):
        split.write_seq(st, r, a, 0)
    return st


def _place_state(split, name: str, rows, dim: int):
    """A recurrent state leaf ``name`` placed by the rules' cache axes:
    ``rows[r]`` is row block ``r``'s value as equal blocks along ``dim``
    (a unit's heads or channels; one block where it is whole), each
    written into the placed blocks that hold it
    (:meth:`~repro_torch.parallel.tensor.ModelSplit.blocks_along`)."""
    first = rows[0]
    shape = list(first[0].shape)
    shape[0] = split.dp * split.rows
    shape[dim] *= len(first)
    st = split.cache_zeros(name, tuple(shape), first[0].dtype)
    for r, parts in enumerate(rows):
        for blk, p in zip(split.blocks_along(st, r, dim, len(parts)), parts):
            blk.copy_(p)
    return st


def block_decode_split(kind: str, split, params, xs, cache, cfg, pos: int,
                       shared=None, x_embed=None):
    """:func:`block_decode` over the model axis on the placed cache
    (written in place): (xs, cache).  The attention caches are
    sequence-sharded; rwkv's and mamba's states are held by heads and
    channels (:mod:`repro_torch.models.rwkv`, :mod:`repro_torch.models.
    ssm`)."""
    if kind == "rwkv":
        hs = _norm_split(split, params["ln1"], xs)
        out = rwkv_mod.rwkv_time_mix_decode_split(split, params["tm"], hs,
                                                  cache, cfg)
        xs = [x + h for x, h in zip(xs, out)]
        out = rwkv_mod.rwkv_channel_mix_decode_split(
            split, params["cm"], _norm_split(split, params["ln2"], xs), cache)
        return [x + h for x, h in zip(xs, out)], cache
    if kind in SSM_KINDS:
        st = cache["ssm"] if kind == "mamba_shared" else cache
        ys = ssm_mod.ssm_decode_split(
            split, params["ssm"], _norm_split(split, params["ln1"], xs), st,
            cfg)
        xs = [x + y for x, y in zip(xs, ys)]
        if kind == "mamba":
            return xs, cache
        sp, acfg = shared
        xcs = [torch.cat([x, e], dim=-1) for x, e in zip(xs, x_embed)]
        hs, _ = attn.attn_decode_split(
            split, sp["attn"], _norm_split(split, sp["ln1"], xcs),
            cache["shared_kv"], acfg, pos)
        return _shared_mlp_split(split, sp, xs, [xc + h for xc, h
                                                 in zip(xcs, hs)]), cache
    hs = _norm_split(split, params["ln1"], xs)
    decode = (mla_mod.mla_decode_split if kind.startswith("mla")
              else attn.attn_decode_split)
    hs, cache = decode(split, params["attn"], hs, cache, cfg, pos)
    xs, _ = _ffn_split(kind, split, params, [x + h for x, h in zip(xs, hs)],
                       cfg)
    return xs, cache


def rwkv_final_state(params, h, cfg):
    """End-of-prompt WKV state via a cheap rescan (B,H,K,V)."""
    xx = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    _, xk, xv, xw, _ = rwkv_mod._ddlerp(params, h, xx)
    return rwkv_mod.wkv_end_state(xk @ params["wk"], xv @ params["wv"],
                                  rwkv_mod._decay(params, xw), cfg.n_heads)


# ---------------------------------------------------------------------------
# cache init + decode
# ---------------------------------------------------------------------------

def cache_init(kind: str, cfg, batch: int, s_max: int, dtype, device):
    """One layer's cache (the reference stacks them per segment)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("attn", "attn_moe"):
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        return attn.KVCache(zeros(batch, s_max, kv, hd),
                            zeros(batch, s_max, kv, hd))
    if kind in ("mla", "mla_moe"):
        return mla_mod.MLACache(zeros(batch, s_max, cfg.kv_lora_rank),
                                zeros(batch, s_max, cfg.qk_rope_dim))
    if kind == "rwkv":
        d = cfg.d_model
        hk = d // cfg.n_heads
        return rwkv_mod.RWKVState(zeros(batch, d), zeros(batch, d),
                                  zeros(batch, cfg.n_heads, hk, hk,
                                        dt=torch.float32))
    if kind in SSM_KINDS:
        s = cfg.ssm
        st = ssm_mod.SSMState(
            zeros(batch, s.d_conv - 1, s.d_inner + 2 * s.d_state),
            zeros(batch, s.n_heads, s.d_state, s.headdim, dt=torch.float32))
        if kind == "mamba_shared":
            acfg = shared_config(cfg)
            shape = (batch, s_max, acfg.n_kv_heads, acfg.head_dim)
            return {"ssm": st, "shared_kv": attn.KVCache(zeros(*shape),
                                                         zeros(*shape))}
        return st
    raise ValueError(kind)


def block_decode(kind: str, params, x, cache, cfg, pos, shared=None,
                 x_embed=None):
    """One-token step.  x: (B, 1, D) → (x, new_cache)."""
    if kind in ATTN_KINDS:
        h = rmsnorm(params["ln1"], x)
        if kind.startswith("mla"):
            h, cache = mla_mod.mla_decode(params["attn"], h, cache, cfg, pos)
        else:
            h, cache = attn.attn_decode(params["attn"], h, cache, cfg, pos)
        x, _ = _ffn(kind, params, x + h, cfg)
        return x, cache
    if kind == "rwkv":
        h, cache = rwkv_mod.rwkv_time_mix_decode(
            params["tm"], rmsnorm(params["ln1"], x), cache, cfg)
        x = x + h
        h, cache = rwkv_mod.rwkv_channel_mix_decode(
            params["cm"], rmsnorm(params["ln2"], x), cache)
        return x + h, cache
    if kind in SSM_KINDS:
        st = cache["ssm"] if kind == "mamba_shared" else cache
        h, st = ssm_mod.ssm_decode(params["ssm"],
                                   rmsnorm(params["ln1"], x), st, cfg, pos)
        x = x + h
        if kind == "mamba":
            return x, st
        sp, acfg = shared
        xc = torch.cat([x, x_embed], dim=-1)
        h, kv = attn.attn_decode(sp["attn"], rmsnorm(sp["ln1"], xc),
                                 cache["shared_kv"], acfg, pos)
        return _shared_mlp(sp, x, xc + h), {"ssm": st, "shared_kv": kv}
    raise ValueError(kind)
