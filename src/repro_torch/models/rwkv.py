"""RWKV6 "Finch" — attention-free time mixing with data-dependent decay.

The port of ``repro/models/rwkv.py``: the v6 time-mix (DDLerp token-shift,
LoRA-conditioned per-channel decay ``w_t = exp(−exp(w0 + tanh(x·A)·B))``,
bonus ``u``) and channel-mix.  The WKV recurrence

    S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ ;   y_t = r_tᵀ·(S_{t−1} + diag(u)·k_t v_tᵀ)

is evaluated in chunks (GLA-style), in float32 with the reference's
chunking and cumulative log-decays: within a chunk a decay-weighted
lower-triangular attention; across chunks a loop carries the (H, K, V)
state.

The ``*_split`` functions run it over the model axis
(:mod:`repro_torch.parallel.tensor`): heads over ``model`` in the time mix
(a unit's columns of the projections, its heads' recurrence and group
norm, its rows of ``wo``), ``d_ff`` and ``d`` column blocks in the channel
mix, the WKV state held a unit's heads at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, full, normal,
                                      rmsnorm_init, uniform)
from repro_torch.parallel.sharding import pshard
from repro_torch.parallel.tensor import MODEL


def rwkv_init(gen, cfg, dtype):
    d = cfg.d_model
    lora = cfg.rwkv_lora
    return {
        # DDLerp token-shift: 5 streams (r, k, v, w, g)
        "mu": uniform(gen, (5, d), dtype),
        "ts_a": dense_init(gen, d, 5 * lora, dtype, scale=0.01),
        "ts_b": normal(gen, (5, lora, d), 0.01, dtype),
        # decay LoRA
        "w0": full(gen, (d,), -6.0, torch.float32),
        "w_a": dense_init(gen, d, lora * 2, dtype, scale=0.01),
        "w_b": normal(gen, (lora * 2, d), 0.01, dtype),
        "u": full(gen, (d,), 0.0, torch.float32),
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype),
        "ln_x": rmsnorm_init(gen, d, dtype),  # per-head group norm surrogate
    }


def rwkv_ffn_init(gen, cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": full(gen, (d,), 0.5, dtype),
        "mu_r": full(gen, (d,), 0.5, dtype),
        "wk": dense_init(gen, d, f, dtype),
        "wv": dense_init(gen, f, d, dtype),
        "wr": dense_init(gen, d, d, dtype),
    }


def _ddlerp(params, x, xx):
    """Data-dependent interpolation between x and shifted xx → 5 streams."""
    base = xx - x                                        # (B,S,D)
    mix = x + base * params["mu"][:, None, None, :]      # (5,B,S,D)
    lora = torch.tanh(x @ params["ts_a"])                # (B,S,5·L)
    lora = lora.reshape(*x.shape[:-1], 5, -1)            # (B,S,5,L)
    dyn = torch.einsum("bsfl,fld->fbsd", lora, params["ts_b"])
    return (mix + dyn * base[None]).unbind(0)


def _decay(params, xw):
    """Per-channel log-decay (≤0): log w = −exp(w0 + tanh(x·A)·B)."""
    lo = torch.tanh(xw @ params["w_a"]) @ params["w_b"]
    return -torch.exp(params["w0"] + lo.float())


def wkv_chunked(r, k, v, logw, u, n_heads: int, chunk: int = 64):
    """Chunked WKV6.  r,k,v (B,S,D); logw (B,S,D) ≤ 0; u (D,).

    Heads split D into (H, K) with K = D // H; V = K.
    Returns (B, S, D) in float32 from a zero state.
    """
    b, s, d = r.shape
    hk = d // n_heads
    c = min(chunk, s)
    while s % c:
        c -= 1
    nc = s // c

    def hshape(x):
        return x.reshape(b, nc, c, n_heads, hk)

    rr, kk, vv = hshape(r.float()), hshape(k.float()), hshape(v.float())
    lw = hshape(logw)
    uu = u.reshape(n_heads, hk)

    cl = torch.cumsum(lw, dim=2)                         # (B,nc,c,H,K)
    # A[i,j] = (r_i ⊙ exp(cl_{i-1}))·(k_j ⊙ exp(−cl_j)) for j < i
    r_dec = rr * torch.exp(cl - lw)                      # exp(cl_{i-1})
    k_dec = kk * torch.exp(-cl)
    scores = torch.einsum("bzihk,bzjhk->bzhij", r_dec, k_dec)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)                        # strictly lower
    scores = torch.where(tri[None, None, None], scores, 0.0)
    diag = torch.einsum("bzihk,bzihk->bzhi", rr * uu[None, None, None], kk)
    y_intra = (torch.einsum("bzhij,bzjhv->bzihv", scores, vv)
               + diag[..., None].transpose(2, 3) * vv)

    # chunk-state: S_z = Σ_j diag(exp(cl_c − cl_j)) k_j ⊗ v_j
    tail = torch.exp(cl[:, :, -1:, :, :] - cl)           # (B,nc,c,H,K)
    s_chunk = torch.einsum("bzjhk,bzjhv->bzhkv", kk * tail, vv)
    g_chunk = torch.exp(cl[:, :, -1])                    # (B,nc,H,K)

    S = torch.zeros((b, n_heads, hk, hk), dtype=torch.float32, device=r.device)
    prev = []
    for z in range(nc):
        prev.append(S)
        S = S * g_chunk[:, z, ..., None] + s_chunk[:, z]
    S_prev = torch.stack(prev, dim=1)                    # (B,nc,H,K,V)
    y_inter = torch.einsum("bzihk,bzhkv->bzihv", r_dec, S_prev)
    y = y_intra + y_inter
    return y.reshape(b, s, d)


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # (B, D) last token (time-mix)
    cm_shift: torch.Tensor   # (B, D) last token (channel-mix)
    wkv: torch.Tensor        # (B, H, K, V) fp32


def _group_norm(y, scale, n_heads):
    """Per-head group norm ≈ rmsnorm over the head dim, float32.  y (B, S,
    D') holds ``n_heads`` whole heads; ``scale`` their (D',) columns."""
    b, s, d = y.shape
    yh = y.reshape(b, s, n_heads, d // n_heads)
    var = torch.mean(yh * yh, dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + 1e-6)
    return yh.reshape(b, s, d) * scale.float()


def wkv_end_state(k, v, logw, n_heads: int):
    """The WKV state after a prompt from a zero state: k, v, logw (B, S,
    D') of ``n_heads`` whole heads → (B, H', K, V) float32."""
    b, s, d = k.shape
    hk = d // n_heads
    kk = k.float().reshape(b, s, n_heads, hk)
    vv = v.float().reshape(b, s, n_heads, hk)
    cl = torch.cumsum(logw.reshape(b, s, n_heads, hk), dim=1)
    tail = torch.exp(cl[:, -1:, :, :] - cl)
    return torch.einsum("bshk,bshv->bhkv", kk * tail, vv)


def _wkv_step(r, k, v, w, u, wkv, n_heads: int):
    """One token of the recurrence: r, k, v, w (B, 1, D') float32 of
    ``n_heads`` whole heads, u (D',), the state (B, H', K, V) → (y (B, 1,
    D'), the next state)."""
    b, _, d = r.shape
    hk = d // n_heads
    rh = r.reshape(b, n_heads, hk)
    kh = k.reshape(b, n_heads, hk)
    vh = v.reshape(b, n_heads, hk)
    wh = w.reshape(b, n_heads, hk)
    uh = u.reshape(n_heads, hk)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, wkv + uh[None, ..., None] * kv)
    return y.reshape(b, 1, d), wkv * wh[..., None] + kv


def rwkv_time_mix(params, x, cfg, shift_state=None):
    """x (B,S,D) → (B,S,D); shift_state (B,D) carries the previous token."""
    b, s, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(params, x, xx)
    # head-sharded projections in the reference (its WKV chunk math stays
    # local per head)
    r = pshard(xr @ params["wr"], "batch", "seq", "heads")
    k = pshard(xk @ params["wk"], "batch", "seq", "heads")
    v = pshard(xv @ params["wv"], "batch", "seq", "heads")
    g = F.silu(pshard(xg @ params["wg"], "batch", "seq", "heads"))
    logw = pshard(_decay(params, xw), "batch", "seq", "heads")
    y = wkv_chunked(r, k, v, logw, params["u"], cfg.n_heads, cfg.rwkv_chunk)
    y = _group_norm(y, params["ln_x"]["scale"], cfg.n_heads)
    return (y.to(x.dtype) * g) @ params["wo"], x[:, -1, :]


def rwkv_channel_mix(params, x, shift_state=None):
    b, s, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)
    xk = x + (xx - x) * params["mu_k"]
    xr = x + (xx - x) * params["mu_r"]
    k = torch.square(F.relu(xk @ params["wk"]))
    if x.shape[1] > 1:
        # the reference constrains training and prefill only (at S = 1 its
        # constraint made GSPMD gather the weight)
        k = pshard(k, "batch", "seq", "mlp")
        down = pshard(k @ params["wv"], "batch", "seq", "embed")
    else:
        down = k @ params["wv"]
    return torch.sigmoid(xr @ params["wr"]) * down, x[:, -1, :]


def rwkv_time_mix_decode(params, x, state: RWKVState, cfg):
    """One token.  x (B, 1, D)."""
    xx = state.tm_shift[:, None, :]
    xr, xk, xv, xw, xg = _ddlerp(params, x, xx)
    r = (xr @ params["wr"]).float()
    k = (xk @ params["wk"]).float()
    v = (xv @ params["wv"]).float()
    g = F.silu(xg @ params["wg"])
    w = torch.exp(_decay(params, xw))                    # (B,1,D)
    y, S = _wkv_step(r, k, v, w, params["u"], state.wkv, cfg.n_heads)
    y = _group_norm(y, params["ln_x"]["scale"], cfg.n_heads)
    out = (y.to(x.dtype) * g) @ params["wo"]
    return out, RWKVState(x[:, -1, :], state.cm_shift, S)


def rwkv_channel_mix_decode(params, x, state: RWKVState):
    y, last = rwkv_channel_mix(params, x, state.cm_shift)
    return y, RWKVState(state.tm_shift, last, state.wkv)


# ---------------------------------------------------------------------------
# the model split (repro_torch.parallel.tensor): lists a row block
# ---------------------------------------------------------------------------

_TM_COLS = ("wr", "wk", "wv", "wg")


def _tm_blocks(split, params, n_heads: int) -> int:
    """How many head blocks a row block's time mix runs in: ``m`` where
    the rules put ``rwkv_heads`` on ``model`` and ``wr`` / ``wk`` / ``wv``
    / ``wg`` (by columns) and ``wo`` (by rows) are split there, so that a
    unit's columns are its whole heads; else 1, every head on unit
    ``(r, 0)`` with the projections gathered."""
    m = split.m
    if (split.rules.mesh_axes("rwkv_heads", n_heads) == MODEL
            and all(split.parts(params[w], 1) == m for w in _TM_COLS)
            and split.parts(params["wo"], 0) == m):
        return m
    return 1


def _tm_units(split, params, x, xx, r: int, n: int):
    """Row block ``r``'s time-mix inputs, one entry a head block ``j`` of
    ``n``: (r, k, v, g, log-decay, the block's columns, the unit's
    parameters), each on unit ``(r, j)``.  The token shift and the LoRAs
    run once on the replicated ``mu`` / ``ts_*`` / ``w_a``; a unit takes
    its columns of ``w_b`` and ``w0``."""
    p0 = split.local(params, r, 0)
    xr, xk, xv, xw, xg = _ddlerp(p0, x, xx)
    lora = torch.tanh(xw @ p0["w_a"])
    # the units read the streams and the decay's LoRA whole
    streams = [split.fan(a, r, n) for a in (xr, xk, xv, xg, lora)]
    out = []
    for j in range(n):
        if n == 1:
            mm, cols, p = split.mm_cols(params, r), slice(None), p0
            ar, ak, av, ag = xr, xk, xv, xg
        else:
            p = split.local(params, r, j)
            cols = split.index(params["wr"], r, j)[1]
            mm = (lambda a, name, p=p: a @ p[name])
            ar, ak, av, ag = (s[j] for s in streams[:4])
        lo = streams[4][j] @ p["w_b"][:, cols]
        logw = -torch.exp(p["w0"][cols] + lo.float())
        out.append((mm(ar, "wr"), mm(ak, "wk"), mm(av, "wv"),
                    F.silu(mm(ag, "wg")), logw, cols, p))
    return out


def _wo_parts(split, params, ys, r: int, n: int) -> list:
    """Row block ``r``'s partials of ``wo``: each head block's output by
    its unit's rows where the heads are split, else by ``wo``'s row
    blocks (:meth:`~repro_torch.parallel.tensor.ModelSplit.mm_rows`)."""
    if n == 1:
        return split.mm_rows(ys[0], params["wo"], r)
    return [y @ split.local(params["wo"], r, j) for j, y in enumerate(ys)]


def rwkv_time_mix_split(split, params, hs, cfg, keep: bool = False):
    """:func:`rwkv_time_mix` from a zero shift (a prompt) over the model
    axis: each unit its heads' columns of ``wr`` / ``wk`` / ``wv`` / ``wg``
    (:func:`_tm_blocks`), its heads' WKV and group norm (per head: no
    reduction), its rows of ``wo``; the partials summed over ``model``,
    one reduction.  ``hs`` and the outputs are lists a row block; with
    ``keep`` also the end-of-prompt WKV state a row block, a list of the
    head blocks' (B_r, H/n, K, V) (:func:`wkv_end_state`)."""
    n = _tm_blocks(split, params, cfg.n_heads)
    hn = cfg.n_heads // n
    parts, states = [], []
    for r, x in enumerate(hs):
        xx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        ys, st = [], []
        for rr, k, v, g, logw, cols, p in _tm_units(split, params, x, xx, r,
                                                    n):
            y = wkv_chunked(rr, k, v, logw, p["u"][cols], hn, cfg.rwkv_chunk)
            y = _group_norm(y, p["ln_x"]["scale"][cols], hn)
            ys.append(y.to(x.dtype) * g)
            if keep:
                st.append(wkv_end_state(k, v, logw, hn))
        parts.append(_wo_parts(split, params, ys, r, n))
        states.append(st)
    return split.psum(parts), states if keep else None


def rwkv_time_mix_decode_split(split, params, hs, state: RWKVState, cfg):
    """:func:`rwkv_time_mix_decode` over the model axis on the placed
    state: each unit steps its heads' block of ``wkv`` in place
    (:meth:`~repro_torch.parallel.tensor.ModelSplit.blocks_along`), and
    ``tm_shift`` (replicated over ``model``) takes the token.  One
    reduction (``wo``)."""
    n = _tm_blocks(split, params, cfg.n_heads)
    hn = cfg.n_heads // n
    parts = []
    for r, x in enumerate(hs):
        shift = split.cache_block(state.tm_shift, r, 0)
        blocks = split.blocks_along(state.wkv, r, 1, n)
        ys = []
        for j, (rr, k, v, g, logw, cols, p) in enumerate(
                _tm_units(split, params, x, shift[:, None, :], r, n)):
            y, S = _wkv_step(rr.float(), k.float(), v.float(), torch.exp(logw),
                             p["u"][cols], split.on(blocks[j], r, j), hn)
            blocks[j].copy_(S)
            y = _group_norm(y, p["ln_x"]["scale"][cols], hn)
            ys.append(y.to(x.dtype) * g)
        shift.copy_(x[:, -1])
        parts.append(_wo_parts(split, params, ys, r, n))
    return split.psum(parts)


def rwkv_channel_mix_split(split, params, hs, shifts=None):
    """:func:`rwkv_channel_mix` over the model axis, by the reference's
    specs: ``wk`` (d × d_ff) by columns, so each unit squares its
    ``d_ff`` block and the blocks are gathered; ``wv`` (d_ff × d) matches
    the name table's ``"wv"`` and is split over its *output* columns, as
    ``wr`` is, so each unit takes the whole ``k`` and computes its ``d``
    block of the output, and the blocks are gathered.  No reduction.
    ``shifts``: the previous token a row block (a decode), else zeros."""
    n = split.parts(params["wv"], 1)       # wr's too: both d, "heads_flat"
    out = []
    for r, x in enumerate(hs):
        p0 = split.local(params, r, 0)
        prev = (torch.zeros_like(x[:, :1]) if shifts is None
                else shifts[r][:, None, :])
        xx = torch.cat([prev, x[:, :-1]], dim=1)
        xk = x + (xx - x) * p0["mu_k"]
        xr = x + (xx - x) * p0["mu_r"]
        k = torch.square(F.relu(split.mm_cols(params, r)(xk, "wk")))
        out.append(split.gather([
            torch.sigmoid(xrj @ split.local(params["wr"], r, j))
            * (kj @ split.local(params["wv"], r, j))
            for j, (xrj, kj) in enumerate(zip(split.fan(xr, r, n),
                                              split.fan(k, r, n)))], -1, r))
    return out


def rwkv_channel_mix_decode_split(split, params, hs, state: RWKVState):
    """:func:`rwkv_channel_mix_decode` over the model axis: the channel
    mix from ``cm_shift`` (replicated over ``model``), which takes the
    token in place."""
    shifts = [split.cache_block(state.cm_shift, r, 0)
              for r in range(len(hs))]
    out = rwkv_channel_mix_split(split, params, hs, shifts)
    for s, x in zip(shifts, hs):
        s.copy_(x[:, -1])
    return out
