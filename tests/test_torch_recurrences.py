"""The port's chunked recurrences (``repro_torch.models.{rwkv,ssm}``)
against the JAX reference's and against the direct per-step recurrences,
on the CPU in float32.

``wkv_chunked`` and ``ssd_chunked`` take the reference's inputs at every
``(s, chunk)`` case of ``tests/test_recurrences.py`` (chunks that do and
don't divide the sequence): within 2e-5 of the reference's (the same
chunking and cumulative log-decays, other summation orders) and within
2e-4 of the sequential float64 recurrence (the reference test's bound).
The blocks' one-token decode steps, run over a sequence, reproduce their
full-sequence paths and end states within 2e-5·max|·|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import rwkv, ssm
from repro_torch.models.model import init_params

WKV_CASES = [(16, 4), (12, 5), (8, 8), (24, 6)]
SSD_CASES = [(16, 4), (12, 5), (8, 8)]
REF_ATOL = 2e-5
# jitted: one compile per case is cheaper than the eager scan's dispatch
ref_wkv = jax.jit(ref_rwkv.wkv_chunked, static_argnums=5,
                  static_argnames="chunk")
ref_ssd = jax.jit(ref_ssm.ssd_chunked, static_argnames="chunk")


def wkv_sequential(r, k, v, logw, u, n_heads):
    """S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ ; y_t = r_tᵀ(S_{t-1} + diag(u) k_t v_tᵀ)."""
    b, s, d = r.shape
    hk = d // n_heads
    rr, kk, vv = (np.asarray(a, np.float64).reshape(b, s, n_heads, hk)
                  for a in (r, k, v))
    ww = np.exp(np.asarray(logw, np.float64).reshape(b, s, n_heads, hk))
    uu = np.asarray(u, np.float64).reshape(n_heads, hk)
    S = np.zeros((b, n_heads, hk, hk))
    ys = []
    for t in range(s):
        kv = np.einsum("bhk,bhv->bhkv", kk[:, t], vv[:, t])
        ys.append(np.einsum("bhk,bhkv->bhv", rr[:, t],
                            S + uu[None, :, :, None] * kv))
        S = S * ww[:, t][..., None] + kv
    return np.stack(ys, axis=1).reshape(b, s, d)


def ssd_sequential(x, dt, a_log, B, C):
    """S_t = exp(dt_t A)·S_{t-1} + dt_t·x_t⊗B_t ; y_t = C_t·S_t."""
    bsz, s, h, p = x.shape
    A = -np.exp(np.asarray(a_log, np.float64))
    xx, dd, BB, CC = (np.asarray(a, np.float64) for a in (x, dt, B, C))
    S = np.zeros((bsz, h, B.shape[-1], p))
    ys = []
    for t in range(s):
        a = np.exp(dd[:, t] * A[None, :])
        xd = xx[:, t] * dd[:, t][..., None]
        S = S * a[..., None, None] + np.einsum("bn,bhp->bhnp", BB[:, t], xd)
        ys.append(np.einsum("bn,bhnp->bhp", CC[:, t], S))
    return np.stack(ys, axis=1)


def _wkv_inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    b, h, hk = 2, 2, 4
    d = h * hk
    r, k, v = (rng.normal(size=(b, s, d)).astype(np.float32)
               for _ in range(3))
    logw = (-np.exp(rng.normal(size=(b, s, d))) * 0.3).astype(np.float32)
    u = rng.normal(size=(d,)).astype(np.float32)
    return (r, k, v, logw, u), h


def _ssd_inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    bsz, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(bsz, s, h)).astype(np.float32)
    a_log = (rng.normal(size=(h,)) * 0.2).astype(np.float32)
    B = rng.normal(size=(bsz, s, n)).astype(np.float32)
    C = rng.normal(size=(bsz, s, n)).astype(np.float32)
    return x, dt, a_log, B, C


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", WKV_CASES)
def test_wkv_chunked_matches_reference(s, chunk):
    args, h = _wkv_inputs(s)
    want = np.asarray(ref_wkv(*map(jnp.asarray, args), h, chunk=chunk))
    got = rwkv.wkv_chunked(*_torch(args), h, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=REF_ATOL, rtol=REF_ATOL)


@pytest.mark.parametrize("s,chunk", WKV_CASES)
def test_wkv_chunked_matches_sequential(s, chunk):
    args, h = _wkv_inputs(s)
    got = rwkv.wkv_chunked(*_torch(args), h, chunk=chunk).numpy()
    np.testing.assert_allclose(got, wkv_sequential(*args, h), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("s,chunk", SSD_CASES)
def test_ssd_chunked_matches_reference(s, chunk):
    args = _ssd_inputs(s)
    want = np.asarray(ref_ssd(*map(jnp.asarray, args), chunk=chunk))
    got = ssm.ssd_chunked(*_torch(args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=REF_ATOL, rtol=REF_ATOL)


@pytest.mark.parametrize("s,chunk", SSD_CASES)
def test_ssd_chunked_matches_sequential(s, chunk):
    args = _ssd_inputs(s)
    got = ssm.ssd_chunked(*_torch(args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, ssd_sequential(*args), atol=2e-4,
                               rtol=2e-4)


def _block(arch, kind):
    cfg = get_config(arch).smoke()
    params = init_params(cfg, seed=11, device="cpu")
    layer = next(seg for (k, _), seg in zip(cfg.segments, params["segments"])
                 if k == kind)[0]
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    return cfg, layer.tree(), x


def _close(got, want, what):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= 2e-5 * scale, f"{what}: {err} > 2e-5·{scale}"


def test_rwkv_decode_steps_match_time_and_channel_mix():
    """``rwkv_time_mix_decode`` / ``rwkv_channel_mix_decode`` token by token
    equal the chunked full-sequence mixes; the final WKV state equals
    ``rwkv_final_state``'s rescan."""
    from repro_torch.models.transformer import rwkv_final_state
    cfg, p, x = _block("rwkv6-7b", "rwkv")
    tm, _ = rwkv.rwkv_time_mix(p["tm"], x, cfg)
    cm, _ = rwkv.rwkv_channel_mix(p["cm"], x)
    b, s, d = x.shape
    hk = d // cfg.n_heads
    st = rwkv.RWKVState(torch.zeros(b, d), torch.zeros(b, d),
                        torch.zeros(b, cfg.n_heads, hk, hk))
    for t in range(s):
        y, st = rwkv.rwkv_time_mix_decode(p["tm"], x[:, t:t + 1], st, cfg)
        _close(y, tm[:, t:t + 1], f"time mix step {t}")
        y, st = rwkv.rwkv_channel_mix_decode(p["cm"], x[:, t:t + 1], st)
        _close(y, cm[:, t:t + 1], f"channel mix step {t}")
    _close(st.wkv, rwkv_final_state(p["tm"], x, cfg), "final state")


def test_ssm_decode_steps_match_prefill():
    """``ssm_decode`` token by token equals ``ssm_prefill``'s outputs, and
    its conv tail and SSD state the prefill's end state — also for a
    prompt shorter than the conv window."""
    cfg, p, x = _block("zamba2-2.7b", "mamba")
    y, end = ssm.ssm_prefill(p["ssm"], x, cfg)
    s = cfg.ssm
    b = x.shape[0]
    st = ssm.SSMState(torch.zeros(b, s.d_conv - 1, s.d_inner + 2 * s.d_state),
                      torch.zeros(b, s.n_heads, s.d_state, s.headdim))
    for t in range(x.shape[1]):
        yt, st = ssm.ssm_decode(p["ssm"], x[:, t:t + 1], st, cfg, t)
        _close(yt, y[:, t:t + 1], f"ssm step {t}")
        if t == 1:
            _, short = ssm.ssm_prefill(p["ssm"], x[:, :2], cfg)
            _close(st.conv, short.conv, "short conv tail")
    _close(st.conv, end.conv, "conv tail")
    _close(st.ssm, end.ssm, "ssd state")
