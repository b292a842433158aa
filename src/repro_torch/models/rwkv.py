"""RWKV6 "Finch" — attention-free time mixing with data-dependent decay.

The port of ``repro/models/rwkv.py``: the v6 time-mix (DDLerp token-shift,
LoRA-conditioned per-channel decay ``w_t = exp(−exp(w0 + tanh(x·A)·B))``,
bonus ``u``) and channel-mix.  The WKV recurrence

    S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ ;   y_t = r_tᵀ·(S_{t−1} + diag(u)·k_t v_tᵀ)

is evaluated in chunks (GLA-style), in float32 with the reference's
chunking and cumulative log-decays: within a chunk a decay-weighted
lower-triangular attention; across chunks a loop carries the (H, K, V)
state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, full, normal, rmsnorm_init
from repro_torch.parallel.sharding import pshard


def rwkv_init(gen, cfg, dtype):
    d = cfg.d_model
    lora = cfg.rwkv_lora
    return {
        # DDLerp token-shift: 5 streams (r, k, v, w, g)
        "mu": torch.rand((5, d), generator=gen, device=gen.device,
                         dtype=torch.float32).to(dtype),
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


def _group_norm(y, params, b, s, d, n_heads):
    """Per-head group norm ≈ rmsnorm over the head dim, float32."""
    yh = y.reshape(b, s, n_heads, d // n_heads)
    var = torch.mean(yh * yh, dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + 1e-6)
    return yh.reshape(b, s, d) * params["ln_x"]["scale"].float()


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
    y = _group_norm(y, params, b, s, d, cfg.n_heads)
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
    b, _, d = x.shape
    xx = state.tm_shift[:, None, :]
    xr, xk, xv, xw, xg = _ddlerp(params, x, xx)
    r = (xr @ params["wr"]).float()
    k = (xk @ params["wk"]).float()
    v = (xv @ params["wv"]).float()
    g = F.silu(xg @ params["wg"])
    w = torch.exp(_decay(params, xw))                    # (B,1,D)
    hk = d // cfg.n_heads
    rh = r.reshape(b, cfg.n_heads, hk)
    kh = k.reshape(b, cfg.n_heads, hk)
    vh = v.reshape(b, cfg.n_heads, hk)
    wh = w.reshape(b, cfg.n_heads, hk)
    uh = params["u"].reshape(cfg.n_heads, hk)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = torch.einsum("bhk,bhkv->bhv", rh, state.wkv + uh[None, ..., None] * kv)
    S = state.wkv * wh[..., None] + kv
    y = _group_norm(y, params, b, 1, d, cfg.n_heads)
    out = (y.to(x.dtype) * g) @ params["wo"]
    return out, RWKVState(x[:, -1, :], state.cm_shift, S)


def rwkv_channel_mix_decode(params, x, state: RWKVState):
    y, last = rwkv_channel_mix(params, x, state.cm_shift)
    return y, RWKVState(state.tm_shift, last, state.wkv)
