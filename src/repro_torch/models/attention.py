"""GQA/MHA attention: chunked (flash-style) full-sequence path + cached
decode.

The port of ``repro/models/attention.py``, in plain torch ops (no fused
library attention): grouped KV heads (GQA), per-head qk-norm (qwen3 /
chameleon), partial RoPE (glm4), sliding-window masks (mixtral), full MHA
(musicgen).  The full-sequence path streams KV in chunks with the same
online softmax and float32 scores as the reference, so a long prefill never
materialises an S×S score matrix.  The reference's einsums with
``preferred_element_type=float32`` are einsums of operands cast to float32
(exact products of the compute-dtype values, float32 sums).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, full, head_rmsnorm
from repro_torch.parallel.sharding import pshard

NEG_INF = -1e30


def attn_init(gen, cfg, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, h * hd, dtype),
         "wk": dense_init(gen, d, kv * hd, dtype),
         "wv": dense_init(gen, d, kv * hd, dtype),
         "wo": dense_init(gen, h * hd, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = full(gen, (hd,), 1.0, dtype)
        p["k_norm"] = full(gen, (hd,), 1.0, dtype)
    return p


def _project_qkv(params, x, cfg, pos):
    """x: (B, S, D) → q (B,S,KV,G,hd), k/v (B,S,KV,hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    q = (x @ params["wq"]).reshape(b, s, kv, g, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    if cfg.rope_fraction > 0:
        q = apply_rope(q.reshape(b, s, h, hd), pos, cfg.rope_theta,
                       cfg.rope_fraction).reshape(b, s, kv, g, hd)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _chunk(n: int, want: int) -> int:
    """The largest chunk ≤ ``want`` that divides ``n`` (the reference's)."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                      chunk_q: int = 512, chunk_k: int = 1024,
                      scale: Optional[float] = None):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, KV, G, hd);  k, v: (B, Sk, KV, hd);
    q_pos: (Sq,), k_pos: (Sk,) global positions (causal mask uses them).
    Returns (B, Sq, KV, G, hd_v) in q's dtype.
    """
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    hdv = v.shape[-1]                      # v head dim may differ (MLA)
    scale = scale if scale is not None else hd ** -0.5
    cq, ck = _chunk(sq, chunk_q), _chunk(sk, chunk_k)
    kf = [k[:, j:j + ck].float() for j in range(0, sk, ck)]
    vs = [v[:, j:j + ck] for j in range(0, sk, ck)]
    kps = [k_pos[j:j + ck] for j in range(0, sk, ck)]

    outs = []
    for i in range(0, sq, cq):
        qi = (q[:, i:i + cq] * scale).float()   # scaled in q's dtype
        qpi = q_pos[i:i + cq]
        m = torch.full((b, cq, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, cq, kvh, g), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, cq, kvh, g, hdv), dtype=torch.float32,
                          device=q.device)
        for kj, vj, kpj in zip(kf, vs, kps):
            s_ = torch.einsum("bqkgd,bckd->bqkgc", qi, kj)
            mask = qpi[:, None] >= kpj[None, :]          # causal
            if window is not None:
                mask &= (qpi[:, None] - kpj[None, :]) < window
            s_ = torch.where(mask[None, :, None, None, :], s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_apply(params, x, cfg, pos):
    """Full-sequence causal attention (training / prefill). x: (B, S, D)."""
    return attn_prefill(params, x, cfg, pos)[0]


def attn_prefill(params, x, cfg, pos):
    """:func:`attn_apply` and its keys and values (B, S, KV, hd), which
    the prefill caches."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, pos)
    q = pshard(q, "batch", "seq", "kv_heads", None, None)
    k = pshard(k, "batch", "seq", "kv_heads", None)
    out = chunked_attention(q, k, v, pos, pos, window=cfg.sliding_window)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], k, v


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, KV, hd)
    v: torch.Tensor


def attn_decode(params, x, cache: KVCache, cfg, pos: int):
    """One-token decode. x: (B, 1, D); pos: the current position.

    Writes the new key and value into ``cache`` at ``pos`` in place (the
    reference donates the cache to its jitted step) and returns it."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos_arr)

    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    k = pshard(cache.k, "cache_batch", "cache_seq", "cache_heads", None)
    v = pshard(cache.v, "cache_batch", "cache_seq", "cache_heads", None)

    s_max = k.shape[1]
    scale = hd ** -0.5
    s_ = torch.einsum("bkgd,bskd->bkgs", (q[:, 0] * scale).float(), k.float())
    idx = torch.arange(s_max, device=x.device)
    mask = idx <= pos
    if cfg.sliding_window is not None:
        mask &= idx > pos - cfg.sliding_window
    s_ = torch.where(mask[None, None, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ params["wo"], cache
