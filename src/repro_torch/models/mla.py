"""Multi-head Latent Attention (DeepSeek-V2 §2.1; also MiniCPM3).

The port of ``repro/models/mla.py``.  Queries and KV project through
low-rank latents; the decode cache stores only the compressed latent
``c_kv`` (kv_lora_rank) plus the shared single-head rotary key — 576
values a token for deepseek-v2 instead of 32k for full MHA.

Two decode paths:

* naive (baseline): re-expand K/V from every cached latent each step;
* absorbed (``cfg.mla_absorbed``): fold ``W_uk`` into the query and
  ``W_uv`` into the output projection so attention runs in latent space.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.attention import NEG_INF, chunked_attention
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


def _latents(params, x, cfg, pos):
    """x: (B,S,D) → q (B,S,H,dn+dr), c_kv (B,S,rkv), k_rope (B,S,1,dr)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (cq @ params["wq_b"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)

    kv_a = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], pos,
                        cfg.rope_theta)
    return q, c_kv, k_rope


def _expand_kv(params, c_kv, cfg):
    """c_kv (..., rkv) → k_nope (..., H, dn), v (..., H, dv)."""
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kv = (c_kv @ params["wkv_b"]).reshape(*c_kv.shape[:-1], h, dn + dv)
    return kv[..., :dn], kv[..., dn:]


def mla_apply(params, x, cfg, pos):
    """Full-sequence MLA (training / prefill)."""
    return mla_prefill(params, x, cfg, pos)[0]


def mla_prefill(params, x, cfg, pos):
    """:func:`mla_apply` and what the prefill caches: the latents c_kv
    (B, S, rkv) and the rotary keys (B, S, dr)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q, c_kv, k_rope = _latents(params, x, cfg, pos)
    k_nope, v = _expand_kv(params, c_kv, cfg)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q = pshard(q.reshape(b, s, h, 1, dn + dr), "batch", "seq", "heads",
               None, None)
    k = pshard(k, "batch", "seq", "heads", None)
    out = chunked_attention(q, k, v, pos, pos, window=None,
                            scale=(dn + dr) ** -0.5)
    out = out.reshape(b, s, h * dv)
    return out @ params["wo"], c_kv, k_rope[:, :, 0]


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
