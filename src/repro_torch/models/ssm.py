"""Mamba2 (SSD) block — the zamba2 backbone.

The port of ``repro/models/ssm.py``.  Chunked state-space-duality
formulation: within a chunk the recurrence is an attention-like masked
einsum; across chunks a loop carries the (H, N, P) state.  Decode carries
(conv_state, ssm_state) and advances in O(1).  Mixed-dtype einsums follow
``jnp.einsum``'s promotion (:func:`repro_torch.models.layers.einsum`).

Shapes: d_inner = expand·d_model, H = d_inner / headdim heads, state N,
single B/C group (n_groups=1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, einsum, full, normal,
                                       rmsnorm, rmsnorm_init)


def ssm_init(gen, cfg, dtype):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner
    h = s.n_heads
    conv_dim = di + 2 * s.d_state
    return {
        # order: [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * s.d_state + h, dtype),
        "conv_w": normal(gen, (s.d_conv, conv_dim), 0.1, dtype),
        "conv_b": full(gen, (conv_dim,), 0.0, dtype),
        "dt_bias": full(gen, (h,), 0.0, dtype),
        "a_log": full(gen, (h,), 0.0, torch.float32),
        "d_skip": full(gen, (h,), 1.0, torch.float32),
        "norm": rmsnorm_init(gen, di, dtype),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _split_proj(proj, cfg):
    s = cfg.ssm
    di, n = s.d_inner, s.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d; xbc (B, S, C), w (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _softplus_dt(dt, dt_bias):
    """softplus(dt + dt_bias) in float32."""
    return F.softplus(dt.float() + dt_bias.float())


def ssd_chunked(x, dt, a_log, B, C, chunk: int = 128):
    """SSD scan.  x (B,S,H,P), dt (B,S,H) (post-softplus), B/C (B,S,N).

    Returns y (B,S,H,P).  a = exp(dt·A) with A = −exp(a_log).
    """
    bsz, seq, h, p = x.shape
    n = B.shape[-1]
    c = min(chunk, seq)
    while seq % c:
        c -= 1
    nc = seq // c

    A = -torch.exp(a_log)                                # (H,)
    la = (dt * A).reshape(bsz, nc, c, h)                 # log decay / step
    xd = (x * dt[..., None]).reshape(bsz, nc, c, h, p)   # dt-weighted input
    Bc = B.reshape(bsz, nc, c, n)
    Cc = C.reshape(bsz, nc, c, n)

    cl = torch.cumsum(la, dim=2)                         # (B,nc,c,H)
    # intra-chunk: y[i] += Σ_{j≤i} (C_i·B_j)·exp(cl_i−cl_j)·xd_j
    scores = torch.einsum("bzin,bzjn->bzij", Cc, Bc)     # (B,nc,c,c)
    decay = torch.exp(cl[:, :, :, None, :] - cl[:, :, None, :, :])
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    m = torch.where(tri[None, None, :, :, None], decay, 0.0)
    y_intra = einsum("bzij,bzijh,bzjhp->bzihp", scores, m, xd)

    # chunk state: S_z = Σ_j exp(cl_c − cl_j)·B_j ⊗ xd_j   (B,nc,H,N,P)
    tail = torch.exp(cl[:, :, -1:, :] - cl)              # (B,nc,c,H)
    s_chunk = einsum("bzjh,bzjn,bzjhp->bzhnp", tail, Bc, xd).float()
    chunk_decay = torch.exp(cl[:, :, -1, :])             # (B,nc,H)

    S = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(S)
        S = S * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    S_prev = torch.stack(prev, dim=1)                    # (B,nc,H,N,P)

    # inter-chunk: y[i] += exp(cl_i)·C_i·S_prev
    y_inter = einsum("bzih,bzin,bzhnp->bzihp", torch.exp(cl), Cc,
                     S_prev.to(x.dtype))
    return (y_intra + y_inter).reshape(bsz, seq, h, p)


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim)
    ssm: torch.Tensor    # (B, H, N, P) fp32


def _gate_out(params, y, z, x_dtype, shape):
    """The skip-free tail of the block: gated rmsnorm and out_proj."""
    y = y.reshape(shape).to(x_dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"]


def ssm_apply(params, x, cfg):
    """Training / prefill path.  x: (B, S, D) → (B, S, D)."""
    return ssm_prefill(params, x, cfg)[0]


def ssm_prefill(params, x, cfg):
    """:func:`ssm_apply` and the end state (conv tail + final SSD state)."""
    s = cfg.ssm
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, cfg)
    xbc_c = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc_c[..., :s.d_inner]
    B = xbc_c[..., s.d_inner:s.d_inner + s.d_state]
    C = xbc_c[..., s.d_inner + s.d_state:]
    dtf = _softplus_dt(dt, params["dt_bias"])
    bsz, seq, _ = x.shape
    xh = xs.reshape(bsz, seq, s.n_heads, s.headdim)
    y = ssd_chunked(xh, dtf, params["a_log"], B, C, chunk=s.chunk)
    y = y + params["d_skip"][None, None, :, None] * xh.to(y.dtype)
    out = _gate_out(params, y, z, x.dtype, (bsz, seq, s.d_inner))
    # final state: rerun decay accumulation over the whole sequence
    A = -torch.exp(params["a_log"])
    cl = torch.cumsum(dtf * A, dim=1)                           # (B,S,H)
    tail = torch.exp(cl[:, -1:, :] - cl)
    xd = xh * dtf[..., None]
    S = einsum("bsh,bsn,bshp->bhnp", tail, B, xd.float())
    # the last d_conv − 1 inputs, zeros before the first
    conv_tail = F.pad(xbc, (0, 0, max(0, s.d_conv - 1 - seq), 0))
    return out, SSMState(conv_tail[:, -(s.d_conv - 1):, :], S)


def ssm_decode(params, x, state: SSMState, cfg, pos):
    """One-token decode.  x: (B, 1, D)."""
    s = cfg.ssm
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj[:, 0], cfg)            # (B, ·)
    conv_hist = torch.cat([state.conv, xbc[:, None, :]], dim=1)
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", conv_hist, params["conv_w"])
                   + params["conv_b"])
    new_conv = conv_hist[:, 1:, :]

    xs = xbc_c[..., :s.d_inner]
    B = xbc_c[..., s.d_inner:s.d_inner + s.d_state]
    C = xbc_c[..., s.d_inner + s.d_state:]
    dt = _softplus_dt(dt, params["dt_bias"])                     # (B,H)
    a = torch.exp(dt * -torch.exp(params["a_log"]))              # (B,H)
    xh = xs.reshape(-1, s.n_heads, s.headdim)
    xd = xh * dt[..., None]
    S = (state.ssm * a[..., None, None]
         + einsum("bn,bhp->bhnp", B, xd.float()))
    y = torch.einsum("bn,bhnp->bhp", C, S.to(x.dtype))
    y = y + params["d_skip"][None, :, None].to(x.dtype) * xh
    out = _gate_out(params, y, z[:, None, :], x.dtype, (-1, 1, s.d_inner))
    return out, SSMState(new_conv, S)
