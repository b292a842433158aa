"""The port's LM serving path (``repro_torch.{configs,models,launch}``)
against the JAX reference (``repro.{configs,models}``) on the CPU.

Both packages run the same weights — the reference's ``init_params``
carried across by :func:`repro_torch.convert.lm_params_from_numpy` — on
the same tokens, at every architecture's ``smoke()`` in float32.  The
reference runs jitted once per function and architecture (eager dispatch
of its scans would take longer than the compiles).  Tolerances:

* logits (forward, prefill, every teacher-forced decode step) within
  ``2e-4·max|logit|`` of the reference's, and every cache leaf within
  ``2e-4·max|leaf|``: float32 everywhere, the two libraries sum matrix
  products in other orders and XLA fuses ``a·b + c``;
* a teacher-forced decode within 3e-4 of the port's own forward (the
  reference test's bound), MoE at ``capacity_factor=64`` so that the
  forward drops nothing;
* bfloat16 (qwen3-0.6b's ``smoke()`` at its published dtypes): logits
  within ``0.05·max|logit|``, about 13 bfloat16 ulps (2⁻⁸ relative) —
  each library rounds each product to bfloat16 after its own float32
  sum, and two layers compound those roundings.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import mla as ref_mla
from repro.models import model as RM
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
import repro_torch.configs as port_configs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as port_attn
from repro_torch.models import mla as port_mla
from repro_torch.models import model as M
from repro_torch.models import moe as port_moe
from repro_torch.models import ssm as port_ssm

ARCHS = ref_configs.ARCHS
B, S, S0, S_MAX = 2, 12, 8, 16
REL = 2e-4
SELF_ATOL = 3e-4
BF16_REL = 0.05
MOE_ARCHS = ["mixtral-8x7b", "deepseek-v2-236b"]


def _tokens(cfg, seed, b, s):
    shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel}·{scale}"


def _stacked(segments):
    """The port's caches (per segment, per layer) in the reference's
    layout: each segment's leaves stacked along a leading axis."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([c[k] for c in layers]) for k in first}
        if isinstance(first, tuple):
            return type(first)(*(stack(list(xs)) for xs in zip(*layers)))
        return np.stack([_np(c) for c in layers])
    return [stack(seg) for seg in segments]


def _cache_close(port_cache, ref_cache, rel, what):
    got = jax.tree_util.tree_flatten_with_path(_stacked(port_cache))[0]
    want = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        _close(g, w, rel, f"{what} {jax.tree_util.keystr(path)}")


_REF = {}


def reference(arch):
    """The reference's params, tokens, forward, prefill and teacher-forced
    decode at ``smoke()``, computed once per architecture."""
    if arch in _REF:
        return _REF[arch]
    cfg = ref_configs.get_config(arch).smoke()
    params = RM.init_params(jax.random.PRNGKey(1), cfg)
    tokens = _tokens(cfg, 1, B, S)
    fwd = jax.jit(lambda p, t: RM.forward(p, t, cfg))
    pre = jax.jit(lambda p, t: RM.prefill(p, t, cfg, S_MAX))
    dec = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
    logits, aux = fwd(params, jnp.asarray(tokens))
    pre_logits, cache = pre(params, jnp.asarray(tokens[:, :S0]))
    pre_cache = jax.tree.map(np.asarray, cache)
    steps = []
    for t in range(S0, S):
        lg, cache = dec(params, cache, jnp.asarray(tokens[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    _REF[arch] = out = {
        "tree": jax.tree.map(np.asarray, params), "tokens": tokens,
        "logits": np.asarray(logits), "aux": float(aux),
        "prefill": np.asarray(pre_logits), "prefill_cache": pre_cache,
        "decode": steps, "cache": jax.tree.map(np.asarray, cache)}
    return out


def port(arch, **overrides):
    cfg = port_configs.get_config(arch).smoke(**overrides)
    return cfg, lm_params_from_numpy(reference(arch)["tree"], cfg, "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    """Field for field, the published config and its ``smoke()``."""
    ref = ref_configs.get_config(arch)
    got = port_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(ref.smoke())
    assert port_configs.cells_for(arch) == ref_configs.cells_for(arch)


def test_registry_equals_reference():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.arch_names() == sorted(ref_configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert port_configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_like_reference(arch):
    """The port's own ``init_params``: the reference's tree, shapes and
    dtypes (bfloat16 at ``param_dtype="bfloat16"``); every leaf the
    reference fills with one value holds that value, and every random leaf
    has the reference's scale (std within a factor 1.5)."""
    cfg = port_configs.get_config(arch).smoke(param_dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda k: RM.init_params(k, ref_configs.get_config(arch).smoke(
            param_dtype="bfloat16")), jax.random.PRNGKey(0))
    got = M.init_params(cfg, seed=3, device="cpu")
    got_leaves = jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(got))[0]
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] \
        == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got_leaves, want):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
    want_dtype = {jax.tree_util.keystr(p): str(w.dtype) for p, w in want}
    for path, t in jax.tree_util.tree_flatten_with_path(got.tree())[0]:
        if path[0].key == "segments":        # drop the layer index
            path = path[:2] + path[3:]
        name = jax.tree_util.keystr(path)
        assert str(t.dtype).removeprefix("torch.") == want_dtype[name], name

    ref_tree = reference(arch)["tree"]           # float32 smoke(), seeded
    mine = lm_params_to_numpy(M.init_params(
        port_configs.get_config(arch).smoke(), seed=3, device="cpu"))
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                            jax.tree.leaves(ref_tree)):
        name = jax.tree_util.keystr(path)
        if w.min() == w.max():
            assert (g == w.flat[0]).all(), name
        else:
            ratio = float(g.std()) / float(np.asarray(w, np.float32).std())
            assert 1 / 1.5 < ratio < 1.5, (name, ratio)


def test_params_round_trip():
    """lm_params_from_numpy ∘ lm_params_to_numpy is the identity; bfloat16
    reference arrays cross exactly."""
    arch = "zamba2-2.7b"
    tree = reference(arch)["tree"]
    cfg, params = port(arch)
    back = lm_params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    got = lm_params_from_numpy(bf, cfg, "cpu")
    assert {p.dtype for p in got.parameters()} == {torch.bfloat16}
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(got)),
                    jax.tree.leaves(bf)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref = reference(arch)
    cfg, params = port(arch)
    logits, aux = M.forward(params, _t(ref["tokens"]), cfg)
    _close(_np(logits), ref["logits"], REL, "logits")
    assert abs(float(aux) - ref["aux"]) <= 1e-5 * max(1.0, abs(ref["aux"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """The last-token logits and every cache leaf (attention / MLA caches
    at positions [0, S0) of S_MAX, recurrent end states)."""
    ref = reference(arch)
    cfg, params = port(arch)
    logits, cache = M.prefill(params, _t(ref["tokens"][:, :S0]), cfg, S_MAX)
    _close(_np(logits), ref["prefill"], REL, "prefill logits")
    _cache_close(cache, ref["prefill_cache"], REL, "prefill cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """Each teacher-forced step's logits, and the caches after the last."""
    ref = reference(arch)
    cfg, params = port(arch)
    tokens = _t(ref["tokens"])
    _, cache = M.prefill(params, tokens[:, :S0], cfg, S_MAX)
    for t, want in zip(range(S0, S), ref["decode"]):
        lg, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        _close(_np(lg), want, REL, f"decode step {t}")
    _cache_close(cache, ref["cache"], REL, "decode cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The reference's ``test_decode_matches_forward`` on the port."""
    cfg, params = port(arch)
    if cfg.moe:   # avoid forward capacity drops in the comparison
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    tokens = _t(_tokens(cfg, 5, B, S))
    full, _ = M.forward(params, tokens, cfg)
    logits, cache = M.prefill(params, tokens[:, :S0], cfg, S_MAX)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, S0 - 1]),
                               atol=SELF_ATOL)
    for t in range(S0, S):
        lg, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]),
                                   atol=SELF_ATOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium",
                                  "mixtral-8x7b"])
def test_loss_matches_reference(arch):
    """``loss_fn``: cross-entropy (one codebook and four) plus the MoE aux."""
    ref = reference(arch)
    rcfg = ref_configs.get_config(arch).smoke()
    batch = {"tokens": ref["tokens"], "labels": np.roll(ref["tokens"], 1, 1)}
    want, wm = jax.jit(lambda p, b: RM.loss_fn(p, b, rcfg))(
        jax.tree.map(jnp.asarray, ref["tree"]),
        jax.tree.map(jnp.asarray, batch))
    cfg, params = port(arch)
    got, gm = M.loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg)
    for g, w in ((got, want), (gm["ce"], wm["ce"]), (gm["aux"], wm["aux"])):
        assert abs(float(g) - float(w)) <= 1e-5 * max(1.0, abs(float(w)))


def test_bfloat16_qwen3_matches_reference():
    """qwen3-0.6b's ``smoke()`` at its published bfloat16 parameters and
    compute, the same bfloat16 weights: forward logits within
    ``BF16_REL·max|logit|``, the same greedy tokens for most positions."""
    arch = "qwen3-0.6b"
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rcfg = ref_configs.get_config(arch).smoke(**kw)
    rparams = RM.init_params(jax.random.PRNGKey(2), rcfg)
    tokens = _tokens(rcfg, 2, B, S)
    want, _ = jax.jit(lambda p, t: RM.forward(p, t, rcfg))(
        rparams, jnp.asarray(tokens))
    want = np.asarray(want, np.float32)
    cfg = port_configs.get_config(arch).smoke(**kw)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg,
                                  "cpu")
    got, _ = M.forward(params, _t(tokens), cfg)
    assert got.dtype == torch.bfloat16
    _close(_np(got), want, BF16_REL, "bfloat16 logits")
    same = (_np(got).argmax(-1) == want.argmax(-1)).mean()
    assert same >= 0.75, same


# ---------------------------------------------------------------------------
# MoE with and without drops, MLA, attention primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.25, 64.0])
def test_moe_layer_matches_reference(arch, capacity_factor):
    """``moe_apply`` on 2 × 64 tokens: at capacity factor 0.25 some
    assignments are dropped (counted), at 64 none; output and aux equal the
    reference's either way."""
    rcfg = ref_configs.get_config(arch).smoke()
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=capacity_factor))
    cfg = port_configs.get_config(arch).smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    tree = reference(arch)["tree"]
    kind_index = [k for k, _ in cfg.segments].index(
        next(k for k, _ in cfg.segments if k.endswith("moe")))
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         tree["segments"][kind_index]["moe"])
    x = np.random.default_rng(7).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, rcfg))(
        ref_p, jnp.asarray(x))
    p = lm_params_from_numpy(tree, cfg, "cpu")["segments"][kind_index][0]
    p = p.tree()["moe"]
    xt = torch.from_numpy(x)
    got, aux = port_moe.moe_apply(p, xt, cfg)
    _close(_np(got), np.asarray(want), REL, "moe out")
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    m = cfg.moe
    topw, topi, _ = port_moe._route((xt @ p["router"]).reshape(-1, m.n_experts),
                                    m.top_k, m.norm_topk)
    _, (_, _, _, keep) = port_moe._dispatch(
        xt, topw.reshape(2, 64, -1), topi.reshape(2, 64, -1), m.n_experts,
        port_moe.capacity(64, m))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


def test_mla_absorbed_decode_matches_naive():
    """The absorbed (latent-space) MLA decode equals the naive one."""
    cfg, params = port("minicpm3-4b")
    tokens = _t(_tokens(cfg, 6, 2, 10))
    _, cache_a = M.prefill(params, tokens[:, :8], cfg, 12)
    _, cache_b = M.prefill(params, tokens[:, :8], cfg, 12)
    cfg_abs = dataclasses.replace(cfg, mla_absorbed=True)
    for t in (8, 9):
        la, cache_a = M.decode_step(params, cache_a, tokens[:, t:t + 1], t,
                                    cfg)
        lb, cache_b = M.decode_step(params, cache_b, tokens[:, t:t + 1], t,
                                    cfg_abs)
        np.testing.assert_allclose(_np(la), _np(lb), atol=5e-4)


def test_sliding_window_limits_context():
    """The reference's sliding-window isolation test on the port's
    ``chunked_attention``: position 15 ignores K/V outside its window."""
    rng = np.random.default_rng(0)
    b, s, kv, g, hd, w = 1, 16, 2, 2, 8, 8
    q = torch.from_numpy(rng.normal(size=(b, s, kv, g, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, kv, hd)).astype(np.float32))
    pos = torch.arange(s)
    ca = port_attn.chunked_attention
    out1 = ca(q, k, v, pos, pos, window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, :2] += 3.0
    v2[:, :2] += 3.0
    out2 = ca(q, k2, v2, pos, pos, window=w)
    np.testing.assert_allclose(out1[:, 15].numpy(), out2[:, 15].numpy(),
                               atol=1e-6)
    assert float((out1[:, 3] - out2[:, 3]).abs().max()) > 1e-3
    out3 = ca(q, k, v, pos, pos, window=None)
    out4 = ca(q, k2, v2, pos, pos, window=None)
    assert float((out3[:, 15] - out4[:, 15]).abs().max()) > 1e-4


@pytest.mark.parametrize("chunk_q,chunk_k,window", [
    (4, 8, None), (6, 4, 5), (24, 24, None), (5, 7, 8)])
def test_chunked_attention_matches_reference(chunk_q, chunk_k, window):
    """Chunks that split the 24-token sequence (5 and 7 fall back to the
    reference's largest divisors, 4 and 6), causal and windowed."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in (
        (2, 24, 2, 3, 8), (2, 24, 2, 8), (2, 24, 2, 8)))
    pos = np.arange(24, dtype=np.int32)
    want = jax.jit(lambda *a: ref_attn.chunked_attention(
        *a, window=window, chunk_q=chunk_q, chunk_k=chunk_k))(
        *map(jnp.asarray, (q, k, v, pos, pos)))
    tp = torch.from_numpy(pos)
    got = port_attn.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), tp, tp, window=window,
        chunk_q=chunk_q, chunk_k=chunk_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("arch,key,ref_fn,port_fn", [
    ("qwen3-0.6b", "attn", ref_attn.attn_apply, port_attn.attn_apply),
    ("minicpm3-4b", "attn", ref_mla.mla_apply, port_mla.mla_apply),
    ("zamba2-2.7b", "ssm", ref_ssm.ssm_apply, port_ssm.ssm_apply),
], ids=["attn_apply", "mla_apply", "ssm_apply"])
def test_mixer_apply_matches_reference(arch, key, ref_fn, port_fn):
    """Each full-sequence mixer on its own, on the first layer's weights
    and the same activations, against the reference's."""
    rcfg = ref_configs.get_config(arch).smoke()
    cfg, params = port(arch)
    tree = reference(arch)["tree"]["segments"][0][key]
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree)
    p = params["segments"][0][0].tree()[key]
    x = np.random.default_rng(9).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(S, dtype=np.int32)
    args = (() if key == "ssm" else (jnp.asarray(pos),))
    want = jax.jit(lambda p, x: ref_fn(p, x, rcfg, *args))(
        ref_p, jnp.asarray(x))
    targs = (() if key == "ssm" else (torch.from_numpy(pos),))
    got = port_fn(p, torch.from_numpy(x), cfg, *targs)
    _close(_np(got), np.asarray(want), REL, arch)


# ---------------------------------------------------------------------------
# causality, steps, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "zamba2-2.7b"])
def test_causality(arch):
    """Future tokens do not move earlier logits (the reference's
    ``test_causality`` and ``test_recurrent_causality``)."""
    cfg, params = port(arch)
    t1 = _t(_tokens(cfg, 4, 1, 12))
    t2 = t1.clone()
    t2[:, 6:] = (t1[:, 6:] + 7) % (cfg.vocab_size - 1) + 1   # in range
    l1, _ = M.forward(params, t1, cfg)
    l2, _ = M.forward(params, t2, cfg)
    np.testing.assert_allclose(l1[:, :6].numpy(), l2[:, :6].numpy(),
                               atol=2e-5)


def test_steps_match_model():
    """``make_prefill_step`` is the forward's last position, and
    ``make_decode_step`` is ``decode_step``."""
    cfg, params = port("qwen3-0.6b")
    tokens = _t(_tokens(cfg, 8, B, S))
    full, _ = M.forward(params, tokens, cfg)
    last = make_prefill_step(cfg)(params, tokens)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), atol=1e-6)
    _, cache = M.prefill(params, tokens[:, :S0], cfg, S_MAX)
    _, cache2 = M.prefill(params, tokens[:, :S0], cfg, S_MAX)
    a, _ = make_decode_step(cfg)(params, cache, tokens[:, S0:S0 + 1], S0)
    b, _ = M.decode_step(params, cache2, tokens[:, S0:S0 + 1], S0, cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium"])
def test_serve_on_the_cpu(arch):
    """``serve`` on the host: tokens of the asked shape, in the vocabulary,
    the greedy continuation of its own prefill (the same run twice gives
    the same tokens)."""
    cfg = port_configs.get_config(arch).smoke()
    toks, rate = serve(cfg, batch=2, prompt_len=8, gen=5, seed=4,
                       device="cpu")
    want = (2, 5) if cfg.n_codebooks == 1 else (2, 5, cfg.n_codebooks)
    assert tuple(toks.shape) == want and rate > 0
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    again, _ = serve(cfg, batch=2, prompt_len=8, gen=5, seed=4, device="cpu")
    assert torch.equal(toks, again)


def test_entry_points_need_a_card():
    """``device="cuda"`` without a card raises; nothing falls back to the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(cfg, 1, 4)


def test_port_imports_no_jax():
    """No module of ``repro_torch/{models,configs,launch,optim,data}`` (nor
    ``convert.py``) imports ``jax`` or ``repro``."""
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    dirs = ("models", "configs", "launch", "optim", "data")
    files = [root / "convert.py"] + [
        f for d in dirs for f in sorted((root / d).glob("*.py"))]
    for d in dirs:
        assert (root / d / "__init__.py") in files, d
    for name in ("launch/train.py", "optim/adamw.py", "optim/compression.py",
                 "optim/schedule.py", "data/pipeline.py"):
        assert root / name in files, name
    assert len(files) >= 34
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (f.name, n)
