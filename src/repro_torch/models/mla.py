"""Multi-head Latent Attention (DeepSeek-V2 §2.1; also MiniCPM3).

The port of ``repro/models/mla.py``.  Queries and KV project through
low-rank latents; the decode cache stores only the compressed latent
``c_kv`` (kv_lora_rank) plus the shared single-head rotary key — 576
values a token for deepseek-v2 instead of 32k for full MHA.

Two decode paths:

* naive (baseline): re-expand K/V from every cached latent each step;
* absorbed (``cfg.mla_absorbed``): fold ``W_uk`` into the query and
  ``W_uv`` into the output projection so attention runs in latent space.

``mla_prefill_split`` / ``mla_decode_split`` split them over the model axis
(:mod:`repro_torch.parallel.tensor`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.attention import (NEG_INF, chunked_attention,
                                         decode_mask, heads_split)
from repro_torch.parallel.sharding import pshard
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)


def mla_init(gen, cfg, dtype):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": dense_init(gen, d, rq, dtype),
        "q_norm": rmsnorm_init(gen, rq, dtype),
        "wq_b": dense_init(gen, rq, h * (dn + dr), dtype),
        "wkv_a": dense_init(gen, d, rkv + dr, dtype),
        "kv_norm": rmsnorm_init(gen, rkv, dtype),
        "wkv_b": dense_init(gen, rkv, h * (dn + dv), dtype),
        "wo": dense_init(gen, h * dv, d, dtype),
    }


def _latents(params, x, cfg, pos, mm=None):
    """x: (B,S,D) → q (B,S,H,dn+dr), c_kv (B,S,rkv), k_rope (B,S,1,dr).
    ``mm(a, "wq_b")`` is the query's up-projection (default
    ``a @ params["wq_b"]``; the model split passes its gathered
    column-parallel product)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    mm = mm or (lambda a, name: a @ params[name])
    cq = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = mm(cq, "wq_b").reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)

    kv_a = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], pos,
                        cfg.rope_theta)
    return q, c_kv, k_rope


def _expand_kv(params, c_kv, cfg, mm=None):
    """c_kv (..., rkv) → k_nope (..., H, dn), v (..., H, dv); ``mm`` as
    in :func:`_latents`, for ``wkv_b``."""
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    mm = mm or (lambda a, name: a @ params[name])
    kv = mm(c_kv, "wkv_b").reshape(*c_kv.shape[:-1], h, dn + dv)
    return kv[..., :dn], kv[..., dn:]


def mla_apply(params, x, cfg, pos):
    """Full-sequence MLA (training / prefill)."""
    return mla_prefill(params, x, cfg, pos)[0]


def mla_prefill(params, x, cfg, pos):
    """:func:`mla_apply` and what the prefill caches: the latents c_kv
    (B, S, rkv) and the rotary keys (B, S, dr)."""
    out, c_kv, k_rope = _mla_context(params, x, cfg, pos)
    return out @ params["wo"], c_kv, k_rope


def _mla_context(params, x, cfg, pos, mm=None):
    """The heads' outputs (B, S, H·dv) before ``wo``, c_kv and k_rope."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q, c_kv, k_rope = _latents(params, x, cfg, pos, mm)
    k_nope, v = _expand_kv(params, c_kv, cfg, mm)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q = pshard(q.reshape(b, s, h, 1, dn + dr), "batch", "seq", "heads",
               None, None)
    k = pshard(k, "batch", "seq", "heads", None)
    out = chunked_attention(q, k, v, pos, pos, window=None,
                            scale=(dn + dr) ** -0.5)
    return out.reshape(b, s, h * dv), c_kv, k_rope[:, :, 0]


def mla_prefill_split(split, params, xs, cfg, pos):
    """:func:`mla_prefill` over the model axis: each unit its heads'
    columns of ``wq_b`` / ``wkv_b`` (``heads_flat``) and its rows of
    ``wo``, the output's partials summed over ``model``.  Under a heads
    split each unit computes the latents itself, from the replicated
    ``wq_a`` / ``wkv_a`` and norms, which it reads through
    :meth:`~repro_torch.parallel.tensor.ModelSplit.unit_params`; else they
    are computed once a row block.  Lists a row block, as
    :func:`repro_torch.models.attention.attn_prefill_split`."""
    h, m = cfg.n_heads, split.m
    if heads_split(split, params, "heads", h, ("wq_b", "wkv_b")):
        lcfg = dataclasses.replace(cfg, n_heads=h // m)
        res = []
        for r, x in enumerate(xs):
            ps, xj = split.unit_params(params, r, m), split.fan(x, r, m)
            res.append([mla_prefill(ps[j], xj[j], lcfg, split.on(pos, r, j))
                        for j in range(m)])
        return (split.psum([[o for o, _, _ in row] for row in res]),
                [row[0][1] for row in res], [row[0][2] for row in res])
    parts, c_kvs, k_ropes = [], [], []
    for r, x in enumerate(xs):
        out, c_kv, k_rope = _mla_context(split.local(params, r, 0), x, cfg,
                                         split.on(pos, r),
                                         split.mm_cols(params, r))
        parts.append(split.mm_rows(out, params["wo"], r))
        c_kvs.append(c_kv)
        k_ropes.append(k_rope)
    return split.psum(parts), c_kvs, k_ropes


class MLACache(NamedTuple):
    c_kv: torch.Tensor      # (B, S_max, rkv)
    k_rope: torch.Tensor    # (B, S_max, dr)


def mla_decode(params, x, cache: MLACache, cfg, pos: int):
    """One-token decode over the compressed cache (written in place at
    ``pos``, as :func:`repro_torch.models.attention.attn_decode`)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, c_new, kr_new = _latents(params, x, cfg, pos_arr)

    cache.c_kv[:, pos] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, pos] = kr_new[:, 0, 0].to(cache.k_rope.dtype)
    c_kv = pshard(cache.c_kv, "cache_batch", "cache_seq", None)
    k_rope = pshard(cache.k_rope, "cache_batch", "cache_seq", None)

    s_max = c_kv.shape[1]
    scale = (dn + dr) ** -0.5
    q_nope, q_rope = q[:, 0, :, :dn], q[:, 0, :, dn:]   # (B,H,dn),(B,H,dr)
    mask = (torch.arange(s_max, device=x.device) <= pos)[None, None, :]

    if cfg.mla_absorbed:
        # fold W_uk into q: scores in latent space, context stays latent.
        wkv_b = params["wkv_b"].reshape(cfg.kv_lora_rank, h, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope, w_uk)        # (B,H,rkv)
        s_ = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                             k_rope.float())) * scale
        p = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", p.to(c_kv.dtype).float(),
                           c_kv.float())                          # (B,H,rkv)
        out = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype), w_uv)
    else:
        k_nope, v = _expand_kv(params, c_kv, cfg)                 # (B,S,H,·)
        s_ = (torch.einsum("bhd,bshd->bhs", q_nope.float(), k_nope.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                             k_rope.float())) * scale
        p = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
        out = torch.einsum("bhs,bshv->bhv", p.to(v.dtype).float(),
                           v.float()).to(x.dtype)

    out = out.reshape(b, 1, h * dv)
    return out @ params["wo"], cache


def mla_decode_split(split, params, xs, cache: MLACache, cfg, pos: int):
    """:func:`mla_decode` over the model axis on the sequence-sharded
    ``c_kv`` / ``k_rope`` caches, with
    :func:`repro_torch.models.attention.attn_decode_split`'s reductions:
    each unit scores its block of positions (expanding it with the whole
    ``wkv_b``, or in latent space when absorbed), GSPMD's softmax over the
    sharded axis, the blocks' contexts summed, then ``wo`` by rows on the
    output's ``heads_flat`` blocks, summed."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    scores, values, w_uv = [], [], []
    for r, x in enumerate(xs):
        pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q, c_new, kr_new = _latents(split.local(params, r, 0), x, cfg,
                                    pos_arr, split.mm_cols(params, r))
        split.write_seq(cache.c_kv, r, c_new, pos)
        split.write_seq(cache.k_rope, r, kr_new[:, :, 0], pos)
        q_nope, q_rope = q[:, 0, :, :dn], q[:, 0, :, dn:]
        wkv_b = split.whole(params["wkv_b"], r)
        if cfg.mla_absorbed:
            w_ukv = wkv_b.reshape(cfg.kv_lora_rank, h, dn + dv)
            q_nope = torch.einsum("bhd,rhd->bhr", q_nope, w_ukv[..., :dn])
            w_uv.append(w_ukv[..., dn:])
        row_s, row_v = [], []
        for j, ((off, c_kv), (_, k_rope)) in enumerate(zip(
                split.seq_blocks(cache.c_kv, r),
                split.seq_blocks(cache.k_rope, r))):
            qn, qr = split.on(q_nope, r, j), split.on(q_rope, r, j)
            if cfg.mla_absorbed:
                k, v = c_kv, c_kv
                s_ = torch.einsum("bhr,bsr->bhs", qn.float(), c_kv.float())
            else:
                k, v = _expand_kv({"wkv_b": split.on(wkv_b, r, j)}, c_kv,
                                  cfg)
                s_ = torch.einsum("bhd,bshd->bhs", qn.float(), k.float())
            s_ = (s_ + torch.einsum("bhd,bsd->bhs", qr.float(),
                                    k_rope.float())) * scale
            mask = decode_mask(split, off, c_kv.shape[1], pos, None,
                               c_kv.device)
            row_s.append(torch.where(mask[None, None, :], s_, NEG_INF))
            row_v.append(v)
        scores.append(row_s)
        values.append(row_v)
    probs = split.softmax(scores)
    eq = "bhs,bsr->bhr" if cfg.mla_absorbed else "bhs,bshv->bhv"
    ctx = split.psum([[torch.einsum(eq, p.to(v.dtype).float(), v.float())
                       for p, v in zip(prow, vrow)]
                      for prow, vrow in zip(probs, values)])
    outs = []
    for r, (c, x) in enumerate(zip(ctx, xs)):
        if cfg.mla_absorbed:
            c = torch.einsum("bhr,rhv->bhv", c.to(x.dtype), w_uv[r])
        outs.append(split.mm_rows(c.to(x.dtype).reshape(x.shape[0], 1, h * dv),
                                  params["wo"], r))
    return split.psum(outs), cache
