"""The port's LM serving on a mesh with the ``model`` axis split by hand
(``repro_torch.parallel.tensor`` and the models' split path) against the
JAX reference's GSPMD run on 4 host devices, on the CPU.

The reference side runs once, in three concurrent subprocesses with 4 fake
devices each (``REF_SCRIPT``): for each (arch, mesh) of :data:`CASES` at
``smoke()``, ``PRNGKey(1)`` weights placed by ``param_specs_for``, the
forward, the prefill of the first ``S0`` tokens and the teacher-forced
decode of the rest under ``use_sharding(rules_for(cfg, mesh))``.  The port
runs the same weights (``convert.lm_params_from_numpy``) placed on a CPU
mesh of the same shape.  Bounds:

* logits (forward, prefill, every decode step) within ``REL·max|logit|``
  of the reference's and every cache leaf, block by block of its placement
  (the attention caches' sequence, rwkv's heads, mamba's ``conv_dim`` and
  heads over ``model``), within ``REL·max|leaf|``: the single-device
  parity bound of ``tests/test_torch_models.py`` (float32; the libraries
  sum products, and the split sums partials, in other orders);
* the port's split against its own one-device path within the same bound;
* the vocab-sharded embedding lookup, and ``serve`` on a 1×1 mesh (and
  the recurrent archs' on 2×1), bitwise the one-device ones (one non-zero
  term a token; the same path);
* the number of ``all-reduce`` s one decode step counts, equal to the
  design's (:data:`DECODE_REDUCES`): one for the embedding, then a layer
  five for the attention kinds (max, denominator, context, ``wo``; one for
  the MLP — mixtral: the experts' ``expert_mlp`` partials; deepseek-v2: the
  shared experts, its routed experts gathered, not summed), one for rwkv
  (``wo``; the channel mix gathers), two for mamba (the gated norm's sum of
  squares, ``out_proj``) and seven for mamba_shared (mamba's two and the
  shared block's five).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import model as RM
import repro_torch.configs as port_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.mesh import make_mesh, pmax_axes
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as port_attn
from repro_torch.models import model as M
from repro_torch.models import ssm as port_ssm
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel import (ShardedTensor, cache_specs_for, rules_for,
                                  use_sharding)
from repro_torch.parallel.tensor import (ModelSplit, PlacedParams,
                                         place_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, S0, S_MAX = 2, 12, 8, 16
REL = 2e-4
SPLIT_ARCHS = ["qwen3-0.6b", "glm4-9b", "starcoder2-3b", "chameleon-34b",
               "musicgen-medium", "mixtral-8x7b", "deepseek-v2-236b",
               "minicpm3-4b"]
RECURRENT_ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
#: every arch on 2×2; on 1×4 the non-aligned kv split (qwen3-0.6b,
#: glm4-9b: 2 kv heads at smoke()), the window of 8 (mixtral-8x7b), two
#: of 8 experts a position (deepseek-v2-236b), one rwkv head a position and
#: zamba2's replicated leaves (``in_proj``'s 290 columns, its 2 SSM heads)
#: beside split ones (40 ``conv_dim`` channels, 32 ``out_proj`` rows)
CASES = [(a, (2, 2)) for a in SPLIT_ARCHS + RECURRENT_ARCHS] + [
    (a, (1, 4)) for a in ("qwen3-0.6b", "glm4-9b", "mixtral-8x7b",
                          "deepseek-v2-236b", *RECURRENT_ARCHS)]
#: the design's all-reduces a decode step, a layer of each kind (and one
#: for the embedding)
DECODE_REDUCES = {"attn": 5, "attn_moe": 5, "mla": 5, "mla_moe": 5,
                  "rwkv": 1, "mamba": 2, "mamba_shared": 7}
IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]

REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh2d
from repro.models import model as RM
from repro.parallel.params import param_specs_for, rules_for
from repro.parallel.sharding import use_sharding

CASES, (B, S, S0, S_MAX) = json.loads(sys.argv[2])
out = {}


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


for arch, dims in CASES:
    cfg = get_config(arch).smoke()
    mesh = make_mesh2d(*dims)
    rules = rules_for(cfg, mesh)
    params = RM.init_params(jax.random.PRNGKey(1), cfg)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    if f"{arch}|w0" not in out:
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{arch}|w{i}"] = np.asarray(leaf)
    specs = param_specs_for(cfg, params, rules)
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, jax.sharding.NamedSharding(mesh, s)), params, specs)
    shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    tokens = np.random.default_rng(1).integers(
        1, cfg.vocab_size, shape).astype(np.int32)
    with use_sharding(rules):
        fwd = jax.jit(lambda p, t: RM.forward(p, t, cfg))
        pre = jax.jit(lambda p, t: RM.prefill(p, t, cfg, S_MAX))
        dec = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
        logits, aux = fwd(placed, jnp.asarray(tokens))
        out[key + "logits"], out[key + "aux"] = np.asarray(logits), float(aux)
        lg, cache = pre(placed, jnp.asarray(tokens[:, :S0]))
        out[key + "prefill"] = np.asarray(lg)
        save(key + "prefill_cache", cache)
        for t in range(S0, S):
            lg, cache = dec(placed, cache, jnp.asarray(tokens[:, t:t + 1]), t)
            out[key + f"decode{t}"] = np.asarray(lg)
        save(key + "cache", cache)
np.savez(sys.argv[1], **out)
"""


def _tokens(cfg, b=B, s=S, seed=1):
    shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int64))


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel}·{scale}"


def _ref_groups():
    """:data:`CASES` in three groups of about the same reference time, one
    process each, run at once: the attention archs, and the recurrent
    archs by mesh (zamba2's 27 ``smoke()`` layers compile for about 25 s a
    mesh on a CPU)."""
    groups = {}
    for arch, dims in CASES:
        key = dims if arch in RECURRENT_ARCHS else "attention"
        groups.setdefault(key, []).append((arch, dims))
    return list(groups.values())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's GSPMD results for every case, from 4-device
    processes (:func:`_ref_groups`)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    runs = []
    try:
        for i, cases in enumerate(_ref_groups()):
            path = str(tmp / f"ref{i}.npz")
            runs.append((path, subprocess.Popen(
                [sys.executable, "-c", REF_SCRIPT, path,
                 json.dumps([cases, (B, S, S0, S_MAX)])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)))
        out = {}
        for path, run in runs:
            _, err = run.communicate(timeout=900)
            assert run.returncode == 0, err[-4000:]
            out.update(np.load(path))
        return out
    finally:
        for _, run in runs:
            if run.poll() is None:
                run.kill()
                run.wait()


_PARAMS = {}


def _params(ref, arch):
    """The reference's ``PRNGKey(1)`` weights (saved by the subprocess) as
    the port's ``ParamTree`` on the CPU."""
    if arch not in _PARAMS:
        cfg = ref_configs.get_config(arch).smoke()
        tree = jax.eval_shape(lambda k: RM.init_params(k, cfg),
                              jax.random.PRNGKey(1))
        leaves, treedef = jax.tree.flatten(tree)
        tree = jax.tree.unflatten(treedef, [ref[f"{arch}|w{i}"]
                                            for i in range(len(leaves))])
        _PARAMS[arch] = lm_params_from_numpy(
            tree, port_configs.get_config(arch).smoke(), "cpu")
    return _PARAMS[arch]


def _run(params, cfg, tokens, rules=None):
    """forward, prefill (logits, cache) and teacher-forced decode (logits
    a step, final cache) on ``params`` — split when they are placed — and
    the ``all-reduce`` count of each decode step."""
    out = {}
    with torch.no_grad(), use_sharding(rules):
        out["logits"], out["aux"] = M.forward(params, tokens, cfg)
        out["prefill"], cache = M.prefill(params, tokens[:, :S0], cfg, S_MAX)
        out["prefill_cache"] = tree_map(_snap, cache)
        out["decode"], out["reduces"] = [], []
        for t in range(S0, S):
            mesh_mod.reset_collectives()
            lg, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t,
                                      cfg)
            out["reduces"].append(mesh_mod.collectives["all-reduce"])
            out["decode"].append(lg)
        out["cache"] = cache
    return out


def _snap(x):
    """A copy of a cache leaf (decode writes the caches in place)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return ShardedTensor(x.sharding, x.shape, x.dtype,
                         whole=x.local().clone())


_RUNS = {}


def _case(ref, arch, dims):
    """The port's split run and its one-device run of a case, once."""
    if (arch, dims) not in _RUNS:
        cfg = port_configs.get_config(arch).smoke()
        params = _params(ref, arch)
        tokens = _tokens(cfg)
        rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
        placed = place_params(params, rules, cfg)
        _RUNS[(arch, dims)] = (cfg, rules, _run(placed, cfg, tokens, rules),
                               _run(params, cfg, tokens))
    return _RUNS[(arch, dims)]


def _cache_leaves(tree, path=""):
    """``(key, leaf)`` of one layer's cache, the key as JAX's ``keystr``
    spells the path below a segment (``.k``, ``['ssm'].conv``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, f"{path}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _cache_leaves(v, f"{path}.{f}")
    else:
        yield path, tree


def _blocks_close(port_cache, ref, key, rel, what, cfg, rules):
    """Each placed cache leaf, on the spec ``cache_specs_for`` gives it,
    block by block of its placement, against the reference's global
    (layer-stacked) leaf."""
    specs = cache_specs_for(cfg, port_cache, rules)
    for si, (seg, seg_specs) in enumerate(zip(port_cache, specs)):
        for li, (layer, layer_specs) in enumerate(zip(seg, seg_specs)):
            for (path, st), (_, spec) in zip(_cache_leaves(layer),
                                             _cache_leaves(layer_specs)):
                want = ref[f"{key}[{si}]{path}"][li]
                assert st.spec == spec, (what, path, st.spec, spec)
                scale = float(np.abs(want).max()) or 1.0
                for b in range(st.mesh.size):
                    coords = st.mesh.coords(b)
                    got = st.block(coords).numpy()
                    blk = want[st.sharding.index(coords, st.shape)]
                    err = float(np.abs(got - blk).max())
                    assert err <= rel * scale, \
                        f"{what} [{si}][{li}]{path} @ {coords}: {err}"


# ---------------------------------------------------------------------------
# the split against the reference's GSPMD run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_forward_matches_reference(ref, arch, dims):
    """The split forward's logits (and MoE aux term) against GSPMD's."""
    _, _, split, _ = _case(ref, arch, dims)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    _close(split["logits"], ref[key + "logits"], REL, "forward")
    np.testing.assert_allclose(float(split["aux"]), float(ref[key + "aux"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_prefill_matches_reference(ref, arch, dims):
    """The split prefill's last-token logits and its sequence-sharded
    caches, block by block, against GSPMD's."""
    cfg, rules, split, _ = _case(ref, arch, dims)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    _close(split["prefill"], ref[key + "prefill"], REL, "prefill")
    _blocks_close(split["prefill_cache"], ref, key + "prefill_cache", REL,
                  "prefill cache", cfg, rules)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_decode_matches_reference(ref, arch, dims):
    """Every teacher-forced decode step's logits and the final caches,
    block by block, against GSPMD's."""
    cfg, rules, split, _ = _case(ref, arch, dims)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    for t, lg in zip(range(S0, S), split["decode"]):
        _close(lg, ref[key + f"decode{t}"], REL, f"decode {t}")
    _blocks_close(split["cache"], ref, key + "cache", REL, "decode cache",
                  cfg, rules)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_split_matches_one_device(ref, arch, dims):
    """The port's split against its own one-device path on the same
    weights: forward, prefill, decode and every cache leaf."""
    _, _, split, one = _case(ref, arch, dims)
    for name in ("logits", "prefill"):
        _close(split[name], one[name].numpy(), REL, name)
    for got, want in zip(split["decode"], one["decode"]):
        _close(got, want.numpy(), REL, "decode")
    for st, t in zip(leaves(split["cache"]), leaves(one["cache"])):
        _close(st.gather(), t.numpy(), REL, "cache")


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_decode_all_reduce_count(ref, arch, dims):
    """One decode step counts the design's ``all-reduce`` s
    (:data:`DECODE_REDUCES`): the embedding's sum, then a layer five for
    the attention kinds, one for rwkv, two for mamba, seven for
    mamba_shared; the one-device path counts none."""
    cfg, _, split, one = _case(ref, arch, dims)
    want = 1 + sum(DECODE_REDUCES[k] * c for k, c in cfg.segments)
    assert split["reduces"] == [want] * (S - S0)
    assert one["reduces"] == [0] * (S - S0)


# ---------------------------------------------------------------------------
# the split's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium",
                                  "mixtral-8x7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
def test_embedding_lookup_is_bitwise(ref, arch, dims):
    """The vocab-sharded lookup (zeros outside a unit's rows, summed over
    ``model``) is the one-device lookup bit for bit, codebooks too."""
    cfg = port_configs.get_config(arch).smoke()
    params = _params(ref, arch)
    rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
    placed = place_params(params, rules, cfg)
    assert placed["embed"].spec[-2] == "model"
    tokens = _tokens(cfg, b=4, s=7, seed=5)
    split = ModelSplit(rules, 4, torch.float32)
    got = split.join(M._embed_split(split, placed, tokens, cfg))
    assert torch.equal(got, M._embed(params, tokens, cfg))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  *RECURRENT_ARCHS])
def test_serve_on_a_1x1_mesh_is_bitwise(arch):
    """``serve(cfg, make_mesh2d(1, 1))`` is ``serve(cfg)`` bit for bit; on
    2×2 the split serves the same greedy tokens."""
    cfg = port_configs.get_config(arch).smoke()
    kw = dict(batch=4, prompt_len=8, gen=6, seed=2, device="cpu")
    want, _ = serve(cfg, **kw)
    got, _ = serve(cfg, make_mesh2d(1, 1, device="cpu"), **kw)
    assert torch.equal(got, want)
    split, _ = serve(cfg, make_mesh2d(2, 2, device="cpu"), **kw)
    assert torch.equal(split, want)


def test_serve_refuses_a_mesh_off_its_device():
    """A device that disagrees with the mesh's positions raises."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    with pytest.raises(ValueError, match="position"):
        serve(cfg, make_mesh2d(2, 2, device="meta"), batch=2, prompt_len=4,
              gen=2, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_serve_on_a_2x1_mesh_is_bitwise(arch):
    """A model axis of 1 splits nothing: ``serve`` on a (2, 1) mesh is
    ``serve`` on one device bit for bit for the recurrent archs."""
    cfg = port_configs.get_config(arch).smoke()
    kw = dict(batch=2, prompt_len=4, gen=2, device="cpu")
    want, _ = serve(cfg, **kw)
    got, _ = serve(cfg, make_mesh2d(2, 1, device="cpu"), **kw)
    assert torch.equal(got, want)


def test_placed_parameters_need_their_rules():
    """Placed parameters outside ``use_sharding`` of their mesh raise."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    params = M.init_params(cfg, seed=0, device="cpu")
    rules = rules_for(cfg, make_mesh2d(2, 2, device="cpu"))
    placed = place_params(params, rules, cfg)
    assert isinstance(placed, PlacedParams) and placed.mesh is rules.mesh
    with pytest.raises(ValueError, match="use_sharding"):
        M.forward(placed, _tokens(cfg, b=2, s=4), cfg)
    other = rules_for(cfg, make_mesh2d(2, 2, device="cpu"))
    with use_sharding(other), pytest.raises(ValueError, match="use_sharding"):
        M.forward(placed, _tokens(cfg, b=2, s=4), cfg)


@pytest.mark.parametrize("dims,aligned", [((2, 2), True), ((1, 4), False)])
def test_heads_split_follows_the_rules(dims, aligned):
    """The core runs on whole kv-head groups a position where ``kv_heads``
    divides ``model`` (2 kv heads at smoke() on 2×2) and on the gathered
    projections otherwise (1×4: half a kv head a position)."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    params = M.init_params(cfg, seed=0, device="cpu")
    rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
    placed = place_params(params, rules, cfg)
    attn = placed["segments"][0][0]["attn"]
    split = ModelSplit(rules, 2, torch.float32)
    assert attn["wk"].spec == (None, "model")
    assert port_attn.heads_split(split, attn, "kv_heads", cfg.n_kv_heads,
                                 ("wq", "wk", "wv")) is aligned


@pytest.mark.parametrize("mesh_kw", [
    dict(shape=(2, 1, 2), axes=("pod", "data", "model"), rows=4),
    dict(shape=(2, 2), axes=("data", "model"), rows=3),
    dict(shape=(1, 2), axes=("data", "model"), rows=2)],
    ids=["pod-2x1x2", "rows-not-divided", "1x2"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "minicpm3-4b"])
def test_split_on_other_meshes_matches_one_device(ref, arch, mesh_kw):
    """Rows over ``pod`` × ``data``, rows that do not divide the batch
    axes (replicated, as the rules say) and a model axis alone: the split
    is the one-device path within ``REL``."""
    cfg = port_configs.get_config(arch).smoke()
    params = _params(ref, arch)
    mesh = make_mesh(mesh_kw["shape"], mesh_kw["axes"], device="cpu")
    rules = rules_for(cfg, mesh)
    tokens = _tokens(cfg, b=mesh_kw["rows"], s=S, seed=3)
    got = _run(place_params(params, rules, cfg), cfg, tokens, rules)
    want = _run(params, cfg, tokens)
    for name in ("logits", "prefill"):
        _close(got[name], want[name].numpy(), REL, name)
    for g, w in zip(got["decode"], want["decode"]):
        _close(g, w.numpy(), REL, "decode")


def test_absorbed_mla_decode_split_matches_one_device(ref):
    """deepseek-v2's absorbed MLA decode (latent-space scores) on the
    sequence-sharded cache, 1×4, against its one-device decode."""
    cfg = dataclasses.replace(port_configs.get_config(
        "deepseek-v2-236b").smoke(), mla_absorbed=True)
    params = _params(ref, "deepseek-v2-236b")
    rules = rules_for(cfg, make_mesh2d(1, 4, device="cpu"))
    tokens = _tokens(cfg)
    got = _run(place_params(params, rules, cfg), cfg, tokens, rules)
    want = _run(params, cfg, tokens)
    for g, w in zip(got["decode"], want["decode"]):
        _close(g, w.numpy(), REL, "decode")


def test_placed_init_cache_decodes_as_one_device(ref):
    """``init_cache(..., rules=)`` places a zero cache sequence-sharded;
    the split decodes from it as the one-device path does from its own."""
    cfg = port_configs.get_config("glm4-9b").smoke()
    params = _params(ref, "glm4-9b")
    rules = rules_for(cfg, make_mesh2d(2, 2, device="cpu"))
    placed = place_params(params, rules, cfg)
    cache = M.init_cache(cfg, B, S_MAX, device="cpu", rules=rules)
    assert cache[0][0].k.spec == ("data", "model", None, None)
    one = M.init_cache(cfg, B, S_MAX, device="cpu")
    tokens = _tokens(cfg)
    step = make_decode_step(cfg)
    with torch.no_grad():
        for t in range(4):
            with use_sharding(rules):
                got, cache = step(placed, cache, tokens[:, t:t + 1], t)
            want, one = step(params, one, tokens[:, t:t + 1], t)
            _close(got, want.numpy(), REL, f"decode {t}")
        with use_sharding(rules):
            last = make_prefill_step(cfg)(placed, tokens)
        _close(last, make_prefill_step(cfg)(params, tokens).numpy(), REL,
               "prefill step")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_placed_recurrent_init_cache_decodes_as_one_device(ref, arch):
    """``init_cache(..., rules=)`` places zero recurrent states by heads
    and channels (``wkv`` over ``rwkv_heads``, ``conv`` over
    ``conv_dim``, ``ssm`` over ``ssm_heads``); the split decodes from them
    as the one-device path does from its own."""
    cfg = port_configs.get_config(arch).smoke()
    params = _params(ref, arch)
    rules = rules_for(cfg, make_mesh2d(2, 2, device="cpu"))
    placed = place_params(params, rules, cfg)
    cache = M.init_cache(cfg, B, S_MAX, device="cpu", rules=rules)
    st = cache[0][0]
    if arch == "rwkv6-7b":
        assert st.wkv.spec == ("data", "model", None, None)
        assert st.tm_shift.spec == ("data", None)
    else:
        assert st.conv.spec == ("data", None, "model")
        assert st.ssm.spec == ("data", "model", None, None)
    one = M.init_cache(cfg, B, S_MAX, device="cpu")
    tokens = _tokens(cfg)
    step = make_decode_step(cfg)
    with torch.no_grad():
        for t in range(4):
            with use_sharding(rules):
                got, cache = step(placed, cache, tokens[:, t:t + 1], t)
            want, one = step(params, one, tokens[:, t:t + 1], t)
            _close(got, want.numpy(), REL, f"decode {t}")
    for g, w in zip(leaves(cache), leaves(one)):
        _close(g.gather(), w.numpy(), REL, "cache")


def test_softmax_over_blocks_past_pos_adds_zero():
    """A block wholly masked (``NEG_INF``) gets probability exactly 0 and no
    NaN; the blocks' softmax is the softmax of the concatenated scores."""
    rules = rules_for(port_configs.get_config("qwen3-0.6b").smoke(),
                      make_mesh2d(1, 4, device="cpu"))
    split = ModelSplit(rules, 2, torch.float32)
    g = torch.Generator().manual_seed(0)
    blocks = [torch.randn(2, 3, 4, generator=g) for _ in range(4)]
    blocks[2] = torch.full((2, 3, 4), port_attn.NEG_INF)
    blocks[3] = torch.full((2, 3, 4), port_attn.NEG_INF)
    probs = split.softmax([blocks])[0]
    assert all(torch.isfinite(p).all() for p in probs)
    assert torch.equal(probs[2], torch.zeros(2, 3, 4))
    want = torch.softmax(torch.cat(blocks, dim=-1), dim=-1)
    torch.testing.assert_close(torch.cat(probs, dim=-1), want, rtol=1e-6,
                               atol=1e-7)


def test_pmax_axes_is_an_all_reduce():
    """``pmax_axes`` is ``psum_axes`` with the maximum: the element-wise
    maximum over the named axes, one counted ``all-reduce``."""
    m = make_mesh2d(2, 2, device="cpu")
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0]),
             torch.tensor([0.0, -1.0]), torch.tensor([-2.0, 4.0])]
    mesh_mod.reset_collectives()
    out = pmax_axes(parts, m, "model")
    assert mesh_mod.collectives["all-reduce"] == 1
    assert torch.equal(out[0], torch.tensor([3.0, 5.0])) and out[0] is out[1]
    assert torch.equal(out[2], torch.tensor([0.0, 4.0]))
    assert torch.equal(parts[0], torch.tensor([1.0, 5.0]))


def _zamba_layer(dims, dtype):
    """zamba2's first mamba layer at ``smoke()`` in ``dtype``: its
    parameters (one device, cast as the model casts them), the same placed
    on a CPU mesh of ``dims``, the config and the rules."""
    name = str(dtype).removeprefix("torch.")
    cfg = port_configs.get_config("zamba2-2.7b").smoke(param_dtype=name,
                                                       compute_dtype=name)
    params = M.init_params(cfg, seed=3, device="cpu")
    rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
    placed = place_params(params, rules, cfg)
    return (params["segments"][0][0]["ssm"].tree(dtype),
            placed["segments"][0][0]["ssm"], cfg, rules)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
def test_gated_norm_sums_squares_over_model_in_float32(dims, dtype):
    """The gated RMSNorm over ``d_inner`` split by ``out_proj``'s rows: the
    first reduction sums the units' float32 sums of squares (never cast to
    the compute dtype), equal to one device's float32 sum within float32
    rounding (positive terms: ``d_inner``·2⁻²⁴ relative); in float32 the
    block's output is one device's within ``REL``."""
    one, placed, cfg, rules = _zamba_layer(dims, dtype)
    di = cfg.ssm.d_inner
    assert placed["out_proj"].spec[0] == "model"
    g = torch.Generator().manual_seed(4)
    y = torch.randn(4, 5, di, generator=g)              # the SSD's, float32
    z = torch.randn(4, 5, di, generator=g).to(dtype)
    split = ModelSplit(rules, 4, dtype)
    seen = []
    psum = split.psum
    split.psum = lambda parts: seen.append(parts) or psum(parts)
    got = split.join(port_ssm._gate_out_split(
        split, placed, [[b] for b in split.rows_of(y)], split.rows_of(z),
        dtype))
    assert all(p.dtype == torch.float32 for row in seen[0] for p in row)
    assert all(len(row) == split.m for row in seen[0])
    ssq = split.join(psum(seen[0]))
    gated = (y.to(dtype) * torch.nn.functional.silu(z)).float()
    want = torch.sum(gated * gated, dim=-1, keepdim=True)
    torch.testing.assert_close(ssq, want, rtol=di * 2.0 ** -24, atol=0)
    if dtype == torch.float32:
        _close(got, port_ssm._gate_out(one, y, z, dtype, y.shape).numpy(),
               REL, "gated norm and out_proj")


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
def test_conv_state_shifts_in_place_by_blocks(dims):
    """Decode steps shift the placed ``conv`` state by one position inside
    each ``conv_dim`` block, in place (the blocks keep their storage): after
    six steps the state, and each step's output, is one device's within
    ``REL``; the SSD state too."""
    one, placed, cfg, rules = _zamba_layer(dims, torch.float32)
    s = cfg.ssm
    split = ModelSplit(rules, B, torch.float32)
    state = port_ssm.SSMState(
        split.cache_zeros("conv", (B, s.d_conv - 1, s.d_inner + 2 * s.d_state),
                          torch.float32),
        split.cache_zeros("ssm", (B, s.n_heads, s.d_state, s.headdim),
                          torch.float32))
    assert state.conv.spec[2] == "model"
    storage = [blk.data_ptr() for blk in state.conv.blocks()]
    ref_state = port_ssm.SSMState(state.conv.gather(), state.ssm.gather())
    g = torch.Generator().manual_seed(6)
    for t in range(6):
        x = torch.randn(B, 1, cfg.d_model, generator=g)
        got = split.join(port_ssm.ssm_decode_split(
            split, placed, split.rows_of(x), state, cfg))
        want, ref_state = port_ssm.ssm_decode(one, x, ref_state, cfg, t)
        _close(got, want.numpy(), REL, f"step {t}")
    assert [blk.data_ptr() for blk in state.conv.blocks()] == storage
    _close(state.conv.gather(), ref_state.conv.numpy(), REL, "conv state")
    _close(state.ssm.gather(), ref_state.ssm.numpy(), REL, "ssm state")
