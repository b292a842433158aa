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

The ``*_split`` functions are the model axis's split by hand
(:mod:`repro_torch.parallel.tensor`), GSPMD's work in the reference: heads
over ``model`` in the prefill, the decode cache's sequence over ``model``
with the softmax reduced across its blocks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, full, head_rmsnorm
from repro_torch.parallel.sharding import pshard
from repro_torch.parallel.tensor import MODEL

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


def _project_qkv(params, x, cfg, pos, mm=None):
    """x: (B, S, D) → q (B,S,KV,G,hd), k/v (B,S,KV,hd).  ``mm(x, name)``
    is the projection by weight ``name`` (default ``x @ params[name]``; the
    model split passes its gathered column-parallel product)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    mm = mm or (lambda a, name: a @ params[name])
    q = mm(x, "wq").reshape(b, s, kv, g, hd)
    k = mm(x, "wk").reshape(b, s, kv, hd)
    v = mm(x, "wv").reshape(b, s, kv, hd)
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
    out, k, v = _attn_context(params, x, cfg, pos)
    return out @ params["wo"], k, v


def _attn_context(params, x, cfg, pos, mm=None):
    """The heads' outputs (B, S, H·hd) before ``wo``, and k, v."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, pos, mm)
    q = pshard(q, "batch", "seq", "kv_heads", None, None)
    k = pshard(k, "batch", "seq", "kv_heads", None)
    out = chunked_attention(q, k, v, pos, pos, window=cfg.sliding_window)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim), k, v


def heads_split(split, params, axis: str, heads: int, names) -> bool:
    """Whether the model split runs the attention core a position on its
    own whole heads: the rules put logical ``axis`` of ``heads`` heads (the
    kv heads, or MLA's heads) on ``model``, and the weights ``names`` (by
    columns) and ``wo`` (by rows) are split there.  Otherwise the core runs
    on the gathered projections, as GSPMD's replication of it does."""
    return (split.rules.mesh_axes(axis, heads) == MODEL
            and all(split.parts(params[w], 1) == split.m for w in names)
            and split.parts(params["wo"], 0) == split.m)


def attn_prefill_split(split, params, xs, cfg, pos):
    """:func:`attn_prefill` over the model axis (:mod:`repro_torch.parallel.
    tensor`): ``xs`` and the results are lists a row block; each unit takes
    its ``heads_flat`` columns of ``wq`` / ``wk`` / ``wv`` and its rows of
    ``wo``, and the output's partials are summed over ``model`` (the units
    read ``x`` and the qk-norm scales through :meth:`~repro_torch.parallel.
    tensor.ModelSplit.fan`).  Returns
    (outputs, keys, values), the keys and values whole (B, S, KV, hd) a row
    block, for the caches."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    m = split.m
    if heads_split(split, params, "kv_heads", kv, ("wq", "wk", "wv")):
        lcfg = dataclasses.replace(cfg, n_heads=h // m, n_kv_heads=kv // m)
        res = []
        for r, x in enumerate(xs):
            ps, xj = split.unit_params(params, r, m), split.fan(x, r, m)
            res.append([attn_prefill(ps[j], xj[j], lcfg, split.on(pos, r, j))
                        for j in range(m)])
        return (split.psum([[o for o, _, _ in row] for row in res]),
                [split.gather([k for _, k, _ in row], 2, r)
                 for r, row in enumerate(res)],
                [split.gather([v for _, _, v in row], 2, r)
                 for r, row in enumerate(res)])
    parts, ks, vs = [], [], []
    for r, x in enumerate(xs):
        out, k, v = _attn_context(split.local(params, r, 0), x, cfg,
                                  split.on(pos, r), split.mm_cols(params, r))
        parts.append(split.mm_rows(out, params["wo"], r))
        ks.append(k)
        vs.append(v)
    return split.psum(parts), ks, vs


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


def attn_decode_split(split, params, xs, cache: KVCache, cfg, pos: int):
    """:func:`attn_decode` over the model axis with the cache held
    sequence-sharded (:func:`repro_torch.parallel.tensor.ModelSplit.
    seq_blocks`): the projections by gathered column blocks, the new key
    and value written in place into the block that owns ``pos``; each unit
    scores its block of positions (``NEG_INF`` outside ``idx ≤ pos`` and the
    window), then GSPMD's softmax over a sharded axis
    (:meth:`~repro_torch.parallel.tensor.ModelSplit.softmax`), the blocks'
    contexts summed over ``model``, and ``wo`` by rows on the context's
    ``heads_flat`` blocks, summed over ``model``: four reductions.  A block
    wholly past ``pos`` or outside the window adds exactly 0."""
    h, hd = cfg.n_heads, cfg.head_dim
    scale = hd ** -0.5
    scores, values = [], []
    for r, x in enumerate(xs):
        pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q, k_new, v_new = _project_qkv(split.local(params, r, 0), x, cfg,
                                       pos_arr, split.mm_cols(params, r))
        split.write_seq(cache.k, r, k_new, pos)
        split.write_seq(cache.v, r, v_new, pos)
        qs = (q[:, 0] * scale).float()
        row_s, row_v = [], []
        for j, ((off, k), (_, v)) in enumerate(zip(
                split.seq_blocks(cache.k, r), split.seq_blocks(cache.v, r))):
            s_ = torch.einsum("bkgd,bskd->bkgs", split.on(qs, r, j), k.float())
            mask = decode_mask(split, off, k.shape[1], pos,
                               cfg.sliding_window, k.device)
            row_s.append(torch.where(mask[None, None, None, :], s_, NEG_INF))
            row_v.append(v)
        scores.append(row_s)
        values.append(row_v)
    probs = split.softmax(scores)
    ctx = split.psum([[torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(),
                                    v.float()) for p, v in zip(prow, vrow)]
                      for prow, vrow in zip(probs, values)])
    return split.psum([
        split.mm_rows(c.reshape(x.shape[0], 1, h * hd).to(x.dtype),
                      params["wo"], r)
        for r, (c, x) in enumerate(zip(ctx, xs))]), cache


def decode_mask(split, off: int, n: int, pos: int, window, device):
    """Which of cache positions ``off … off + n − 1`` a decode step at
    ``pos`` attends to (within ``window`` of it, where not None): computed
    once a call, for every layer (``split.scratch``)."""
    key = ("decode_mask", off, n, pos, window, device)
    mask = split.scratch.get(key)
    if mask is None:
        idx = off + torch.arange(n, device=device)
        mask = idx <= pos
        if window is not None:
            mask &= idx > pos - window
        split.scratch[key] = mask
    return mask
