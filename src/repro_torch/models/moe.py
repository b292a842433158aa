"""Mixture-of-Experts: top-k router + capacity-bounded sorted dispatch.

The port of ``repro/models/moe.py``: mixtral (8 experts, top-2) and
deepseek-v2 (2 shared + 160 routed, top-6).  Per sequence (the reference's
data-parallel group, here a batched leading axis), token→expert
assignments are ranked inside each expert with a stable argsort and a
``searchsorted`` pass, written into an (E, C, D) buffer, processed with one
grouped einsum per projection and combined back with the gate weights.

Determinism: the dispatch's ``index_add_`` writes each kept assignment
into its own slot and adds exact zeros for dropped ones, so its result
does not depend on the order of the (atomic, on CUDA) adds.  The combine
gathers each token's k expert outputs and sums them left to right in
expert order — the order of the reference's scatter-add over the sorted
assignments — instead of a scatter-add, so a token's sum is the same on
every run and device.

:func:`moe_apply_split` splits the experts (or each expert's hidden
width) over the model axis (:mod:`repro_torch.parallel.tensor`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import (_ACTS, dense_init, mlp_apply,
                                      mlp_apply_split, mlp_init, normal)
from repro_torch.parallel.sharding import pshard


def moe_init(gen, cfg, dtype):
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(gen, d, m.n_experts, dtype, scale=0.02),
        "w_gate": _experts_init(gen, m.n_experts, d, m.d_expert, dtype),
        "w_up": _experts_init(gen, m.n_experts, d, m.d_expert, dtype),
        "w_down": _experts_init(gen, m.n_experts, m.d_expert, d, dtype),
    }
    if m.n_shared:
        p["shared"] = mlp_init(gen, d, m.n_shared * m.d_expert, dtype,
                               gated=True)
    return p


def _experts_init(gen, e, d_in, d_out, dtype):
    return normal(gen, (e, d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def capacity(s: int, m) -> int:
    """Slots per expert for a group of ``s`` tokens, padded to 8."""
    c = int(s * m.top_k / m.n_experts * m.capacity_factor) + 1
    return -(-c // 8) * 8


def _route(logits, k: int, norm_topk: bool):
    """logits (T, E) → (weights (T,k), experts (T,k), probs (T,E))."""
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    if norm_topk:
        topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return topw, topi, probs


def _dispatch(x, topw, topi, n_experts: int, capacity: int):
    """Per group.  x (G, T, D); topw/topi (G, T, k) → (buf (G,E,C,D), meta)."""
    g, t, d = x.shape
    k = topi.shape[-1]
    n = t * k
    eid = topi.reshape(g, n)
    wgt = topw.reshape(g, n)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)

    order = torch.argsort(eid, dim=-1, stable=True)
    s_eid = torch.gather(eid, 1, order)
    s_tok = tok[order]
    s_wgt = torch.gather(wgt, 1, order)
    first = torch.searchsorted(s_eid, s_eid, side="left")
    rank = torch.arange(n, device=x.device) - first
    keep = rank < capacity
    slot = s_eid * capacity + torch.clamp_max(rank, capacity - 1)

    vals = torch.gather(x, 1, s_tok[..., None].expand(g, n, d)) \
        * keep[..., None].to(x.dtype)
    base = torch.arange(g, device=x.device)[:, None] * (n_experts * capacity)
    buf = torch.zeros((g * n_experts * capacity, d), dtype=x.dtype,
                      device=x.device).index_add_(
        0, (slot + base).reshape(-1), vals.reshape(g * n, d))
    return buf.reshape(g, n_experts, capacity, d), (order, s_wgt, slot, keep)


def _combine(y_buf, meta, t: int, d: int):
    """Per group: each token's k weighted expert outputs, summed in expert
    order.  y_buf (G, E, C, D) → (G, T, D)."""
    order, s_wgt, slot, keep = meta
    g, n = slot.shape
    k = n // t
    y = torch.gather(y_buf.reshape(g, -1, d), 1,
                     slot[..., None].expand(g, n, d))
    y = y * (s_wgt * keep).to(y.dtype)[..., None]
    # the sorted positions of token i's k assignments, ascending = by expert
    where = torch.argsort(order, dim=-1).reshape(g, t, k)
    where = torch.sort(where, dim=-1).values
    out = None
    for j in range(k):
        yj = torch.gather(y, 1, where[..., j, None].expand(g, t, d))
        out = yj if out is None else out + yj
    return out


def moe_apply(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B,S,D), aux load-balance loss (scalar))."""
    m = cfg.moe
    b, s, d = x.shape
    logits = x @ params["router"]
    topw, topi, probs = _route(logits.reshape(b * s, m.n_experts), m.top_k,
                               m.norm_topk)

    # route per-sequence group
    bufs, meta = _dispatch(x, topw.reshape(b, s, m.top_k),
                           topi.reshape(b, s, m.top_k), m.n_experts,
                           capacity(s, m))
    bufs = pshard(bufs, "batch", "experts", None, "embed")
    y_buf = _experts(params, bufs, m.act)
    y_buf = pshard(y_buf, "batch", "experts", None, "embed")
    out = _combine(y_buf, meta, s, d).to(x.dtype)

    if m.n_shared:
        out = out + mlp_apply(params["shared"], x, act=m.act)
    return out, _aux(probs, topi, m.n_experts)


def _experts(params, bufs, act: str):
    """The experts' gated MLPs on their slots: (B, E, C, D) → (B, E, C, D)."""
    f = _ACTS[act]
    h = f(torch.einsum("becd,edf->becf", bufs, params["w_gate"])) \
        * torch.einsum("becd,edf->becf", bufs, params["w_up"])
    return torch.einsum("becf,efd->becd", h, params["w_down"])


def _aux(probs, topi, n_experts: int):
    """Switch-style load-balance aux loss over every routed token."""
    pe = probs.mean(dim=0)                                      # (E,)
    onehot = torch.nn.functional.one_hot(topi[:, 0], n_experts).float()
    fe = onehot.mean(dim=0)
    return n_experts * torch.sum(pe * fe)


def moe_apply_split(split, params, xs, cfg):
    """:func:`moe_apply` over the model axis, lists a row block.  The router
    and the dispatch run replicated, once a row block; the aux term is
    over every row, as the one-device (and GSPMD's) is.  Experts on
    ``model`` (deepseek-v2): each unit runs its experts' slice of the slots
    and the outputs are gathered over experts, no sum split.  ``expert_mlp``
    on ``model`` (mixtral): each unit its columns of every expert's
    ``w_gate`` / ``w_up`` and rows of ``w_down``, the slot outputs summed
    over ``model``.  Shared experts split as an MLP does."""
    m = cfg.moe
    routed = []
    for r, x in enumerate(xs):
        b, s, d = x.shape
        logits = x @ split.local(params["router"], r, 0)
        topw, topi, probs = _route(logits.reshape(b * s, m.n_experts),
                                   m.top_k, m.norm_topk)
        bufs, meta = _dispatch(x, topw.reshape(b, s, m.top_k),
                               topi.reshape(b, s, m.top_k), m.n_experts,
                               capacity(s, m))
        routed.append((bufs, meta, topi, probs))
    experts = {k: params[k] for k in ("w_gate", "w_up", "w_down")}
    ne = split.parts(params["w_gate"], 0)
    if ne > 1:
        y = [split.gather([_experts(
            split.local(experts, r, j),
            split.on(bufs[:, split.index(params["w_gate"], r, j)[0]], r, j),
            m.act) for j in range(ne)], 1, r)
             for r, (bufs, *_) in enumerate(routed)]
    else:
        nf = split.parts(params["w_gate"], 2)
        y = split.psum([[_experts(split.local(experts, r, j), bj, m.act)
                         for j, bj in enumerate(split.fan(bufs, r, nf))]
                        for r, (bufs, *_) in enumerate(routed)])
    outs = [_combine(yb, meta, x.shape[1], x.shape[2]).to(x.dtype)
            for yb, (_, meta, _, _), x in zip(y, routed, xs)]
    if m.n_shared:
        shared = mlp_apply_split(split, params["shared"], xs, m.act)
        outs = [o + sh for o, sh in zip(outs, shared)]
    aux = _aux(split.join([p for *_, p in routed]),
               split.join([t for *_, t, _ in routed]), m.n_experts)
    return outs, aux

