"""Mamba2 (SSD) block — the zamba2 backbone.

The port of ``repro/models/ssm.py``.  Chunked state-space-duality
formulation: within a chunk the recurrence is an attention-like masked
einsum; across chunks a loop carries the (H, N, P) state.  Decode carries
(conv_state, ssm_state) and advances in O(1).  Mixed-dtype einsums follow
``jnp.einsum``'s promotion (:func:`repro_torch.models.layers.einsum`).

Shapes: d_inner = expand·d_model, H = d_inner / headdim heads, state N,
single B/C group (n_groups=1).

``ssm_prefill_split`` / ``ssm_decode_split`` run the block over the model
axis (:mod:`repro_torch.parallel.tensor`) by the reference's specs:
``in_proj`` and the conv by ``conv_dim`` blocks, the SSD by head blocks,
``out_proj`` by ``ssm_inner`` rows, with the gated RMSNorm's sum of squares
reduced over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, einsum, full, normal,
                                       rmsnorm, rmsnorm_init)
from repro_torch.parallel.tensor import MODEL


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
    y, S = _ssd_heads(xh, dtf, params["a_log"], params["d_skip"], B, C,
                      s.chunk)
    out = _gate_out(params, y, z, x.dtype, (bsz, seq, s.d_inner))
    return out, SSMState(_conv_tail(xbc, s.d_conv), S)


def _ssd_heads(xh, dtf, a_log, d_skip, B, C, chunk: int):
    """The SSD of whole heads over a prompt from a zero state, with the
    skip: xh (B, S, H', P), dtf (B, S, H') post-softplus, the heads' a_log
    and d_skip (H',), whole B / C (B, S, N) → (y (B, S, H', P), the end
    state (B, H', N, P) float32)."""
    y = ssd_chunked(xh, dtf, a_log, B, C, chunk=chunk)
    y = y + d_skip[None, None, :, None] * xh.to(y.dtype)
    # final state: rerun decay accumulation over the whole sequence
    A = -torch.exp(a_log)
    cl = torch.cumsum(dtf * A, dim=1)                           # (B,S,H)
    tail = torch.exp(cl[:, -1:, :] - cl)
    xd = xh * dtf[..., None]
    S = einsum("bsh,bsn,bshp->bhnp", tail, B, xd.float())
    return y, S


def _conv_tail(xbc, d_conv: int):
    """The last d_conv − 1 inputs of the conv, zeros before the first."""
    tail = F.pad(xbc, (0, 0, max(0, d_conv - 1 - xbc.shape[1]), 0))
    return tail[:, -(d_conv - 1):, :]


def _conv_step(conv, xbc, w, b):
    """One token of the depthwise conv: the state (B, d_conv − 1, C'),
    the token's xbc (B, C') and the channels' w (d_conv, C') / b (C') →
    (its output, the state shifted by one position)."""
    conv_hist = torch.cat([conv, xbc[:, None, :]], dim=1)
    out = F.silu(torch.einsum("bkc,kc->bc", conv_hist, w) + b)
    return out, conv_hist[:, 1:, :]


def _ssd_step(xh, dt, a_log, d_skip, B, C, ssm, dtype):
    """One token of the SSD for whole heads: xh (B, H', P), dt (B, H')
    post-softplus, the heads' a_log / d_skip, whole B / C (B, N) and
    state (B, H', N, P) → (y (B, H', P), the next state)."""
    a = torch.exp(dt * -torch.exp(a_log))                        # (B,H)
    xd = xh * dt[..., None]
    S = (ssm * a[..., None, None]
         + einsum("bn,bhp->bhnp", B, xd.float()))
    y = torch.einsum("bn,bhnp->bhp", C, S.to(dtype))
    return y + d_skip[None, :, None].to(dtype) * xh, S


def ssm_decode(params, x, state: SSMState, cfg, pos):
    """One-token decode.  x: (B, 1, D)."""
    s = cfg.ssm
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj[:, 0], cfg)            # (B, ·)
    xbc_c, new_conv = _conv_step(state.conv, xbc, params["conv_w"],
                                 params["conv_b"])
    xs = xbc_c[..., :s.d_inner]
    B = xbc_c[..., s.d_inner:s.d_inner + s.d_state]
    C = xbc_c[..., s.d_inner + s.d_state:]
    dt = _softplus_dt(dt, params["dt_bias"])                     # (B,H)
    xh = xs.reshape(-1, s.n_heads, s.headdim)
    y, S = _ssd_step(xh, dt, params["a_log"], params["d_skip"], B, C,
                     state.ssm, x.dtype)
    out = _gate_out(params, y, z[:, None, :], x.dtype, (-1, 1, s.d_inner))
    return out, SSMState(new_conv, S)


# ---------------------------------------------------------------------------
# the model split (repro_torch.parallel.tensor): lists a row block
# ---------------------------------------------------------------------------

def _ssd_blocks(split, cfg) -> int:
    """How many head blocks the SSD runs in a row block: ``m`` where the
    rules put ``ssm_heads`` on ``model`` (the ``ssm`` state's placement),
    else 1 (every head on unit ``(r, 0)``)."""
    h = cfg.ssm.n_heads
    return split.m if split.rules.mesh_axes("ssm_heads", h) == MODEL else 1


def _conv_blocks(split, params, r: int) -> list:
    """Row block ``r``'s ``conv_dim`` column slices of ``conv_w``'s blocks
    (one, whole, where ``conv_dim`` does not divide ``model``)."""
    return [split.index(params["conv_w"], r, j)[1]
            for j in range(split.parts(params["conv_w"], 1))]


def _gate_out_split(split, params, ys, zs, dtype):
    """:func:`_gate_out` over ``out_proj``'s row blocks (``ssm_inner`` on
    ``model``): ``ys[r]`` the SSD's output in blocks of ``d_inner`` (the
    head blocks, re-cut where they are not ``out_proj``'s), ``zs[r]`` the
    whole gate.  Each unit gates its ``d_inner`` block; the gated RMSNorm
    over all of ``d_inner`` sums the units' float32 sums of squares over
    ``model`` (one reduction, in float32); each unit scales its block by
    its slice of ``norm.scale`` and multiplies it by its rows of
    ``out_proj``, whose partials are summed (a second)."""
    w = params["out_proj"]
    n, di = split.parts(w, 0), w.shape[0]
    gated = []
    for r, (parts, z) in enumerate(zip(ys, zs)):
        rows = [split.index(w, r, j)[0] for j in range(n)]
        if len(parts) != n:
            y = split.gather(parts, -1, r)
            parts = [y[..., sl] for sl in rows]
        gated.append([split.on(y, r, j).to(dtype)
                      * F.silu(split.on(z[..., sl], r, j))
                      for j, (y, sl) in enumerate(zip(parts, rows))])
    ssq = split.psum([[torch.sum(torch.square(g.float()), dim=-1,
                                 keepdim=True) for g in row]
                      for row in gated])
    parts = []
    for r, row in enumerate(gated):
        out = []
        for j, (g, sq) in enumerate(zip(row, split.fan(ssq[r], r, len(row)))):
            p = split.local(params, r, j)
            scale = p["norm"]["scale"][split.index(w, r, j)[0]]
            inv = torch.rsqrt(sq / di + 1e-6)
            out.append((g.float() * inv * scale.float()).to(dtype)
                       @ p["out_proj"])
        parts.append(out)
    return split.psum(parts)


def ssm_prefill_split(split, params, hs, cfg, keep: bool = False):
    """:func:`ssm_prefill` over the model axis, by the reference's specs,
    which do not follow the heads: ``in_proj`` column-parallel (its
    ``[z | x | B | C | dt]`` columns cut contiguously), gathered; the
    depthwise conv a ``conv_dim`` block a unit (per channel: local),
    gathered; the SSD a head block a unit (:func:`_ssd_blocks`) with its
    slices of ``dt_bias`` / ``a_log`` / ``d_skip`` and whole ``B`` / ``C``
    (one group); then :func:`_gate_out_split`: two reductions.  ``hs`` and
    the outputs are lists a row block; with ``keep`` also the states a
    row block: (the conv tails a ``conv_dim`` block, the SSD end states
    a head block)."""
    s = cfg.ssm
    nh = _ssd_blocks(split, cfg)
    hn = s.n_heads // nh
    ys, zs, states = [], [], []
    for r, x in enumerate(hs):
        bsz, seq, _ = x.shape
        z, xbc, dt = _split_proj(split.mm_cols(params, r)(x, "in_proj"), cfg)
        cols = _conv_blocks(split, params, r)
        convs = []
        for j, sl in enumerate(cols):
            p = split.local(params, r, j)
            convs.append(_causal_conv(split.on(xbc[..., sl], r, j),
                                      p["conv_w"], p["conv_b"]))
        xbc_c = split.gather(convs, -1, r)
        xh = xbc_c[..., :s.d_inner].reshape(bsz, seq, s.n_heads, s.headdim)
        B = xbc_c[..., s.d_inner:s.d_inner + s.d_state]
        C = xbc_c[..., s.d_inner + s.d_state:]
        row_y, row_s = [], []
        for j, (Bj, Cj) in enumerate(zip(split.fan(B, r, nh),
                                         split.fan(C, r, nh))):
            p = split.local(params, r, j)
            heads = slice(j * hn, (j + 1) * hn)
            dtf = _softplus_dt(split.on(dt[..., heads], r, j),
                               p["dt_bias"][heads])
            y, S = _ssd_heads(split.on(xh[:, :, heads], r, j), dtf,
                              p["a_log"][heads], p["d_skip"][heads],
                              Bj, Cj, s.chunk)
            row_y.append(y.reshape(bsz, seq, hn * s.headdim))
            row_s.append(S)
        ys.append(row_y)
        zs.append(z)
        if keep:
            states.append(([_conv_tail(split.on(xbc[..., sl], r, j),
                                       s.d_conv)
                            for j, sl in enumerate(cols)], row_s))
    out = _gate_out_split(split, params, ys, zs, hs[0].dtype)
    return out, states if keep else None


def ssm_decode_split(split, params, hs, state: SSMState, cfg):
    """:func:`ssm_decode` over the model axis on the placed state, written
    in place: each unit shifts its ``conv_dim`` block of ``conv`` by one
    position and steps its head block of ``ssm``
    (:meth:`~repro_torch.parallel.tensor.ModelSplit.blocks_along`); the
    products and reductions as :func:`ssm_prefill_split`'s."""
    s = cfg.ssm
    nh = _ssd_blocks(split, cfg)
    hn = s.n_heads // nh
    ys, zs = [], []
    for r, x in enumerate(hs):
        proj = split.mm_cols(params, r)(x, "in_proj")
        z, xbc, dt = _split_proj(proj[:, 0], cfg)
        cols = _conv_blocks(split, params, r)
        convs = []
        for j, (sl, blk) in enumerate(zip(
                cols, split.blocks_along(state.conv, r, 2, len(cols)))):
            p = split.local(params, r, j)
            out, shifted = _conv_step(split.on(blk, r, j),
                                      split.on(xbc[:, sl], r, j),
                                      p["conv_w"], p["conv_b"])
            blk.copy_(shifted)
            convs.append(out)
        xbc_c = split.gather(convs, -1, r)
        xh = xbc_c[..., :s.d_inner].reshape(-1, s.n_heads, s.headdim)
        B = xbc_c[..., s.d_inner:s.d_inner + s.d_state]
        C = xbc_c[..., s.d_inner + s.d_state:]
        row = []
        for j, blk in enumerate(split.blocks_along(state.ssm, r, 1, nh)):
            p = split.local(params, r, j)
            heads = slice(j * hn, (j + 1) * hn)
            y, S = _ssd_step(split.on(xh[:, heads], r, j),
                             _softplus_dt(split.on(dt[:, heads], r, j),
                                          p["dt_bias"][heads]),
                             p["a_log"][heads], p["d_skip"][heads],
                             split.on(B, r, j), split.on(C, r, j),
                             split.on(blk, r, j), x.dtype)
            blk.copy_(S)
            row.append(y.reshape(-1, 1, hn * s.headdim))
        ys.append(row)
        zs.append(z[:, None, :])
    return _gate_out_split(split, params, ys, zs, hs[0].dtype)
