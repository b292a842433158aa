"""The port's LM training with the ``model`` axis split by hand (placed
parameters through ``launch/{steps,train}.py``, ``models/model.py::
value_and_grad`` and ``parallel/tensor.py``) against the JAX reference's
GSPMD step on 4 host devices, on the CPU.

The reference side runs once, in five concurrent subprocesses with 4 fake
devices each (``REF_SCRIPT``): for each (arch, mesh) of :data:`CASES` at
``smoke()`` (zamba2 cut to its first two periods, ``CUT``, as
``tests/test_torch_train.py`` does), ``PRNGKey(1)`` weights placed by
``param_specs_for`` and, under ``use_sharding(rules_for(cfg, mesh))``,
``jax.value_and_grad(loss_fn)`` of one batch and two steps of
``make_train_step``.  The reference steps at ``dp`` microbatches (2 on
2×2, 1 on 1×4): its microbatches are then the rows of the port's
replicas' passes at one microbatch, so MoE's load-balance term, which is
not linear in the rows, is the same term on both sides.  The port runs the
same weights (``convert.lm_params_from_numpy``) placed on a CPU mesh of
the same shape.  Bounds, ``tests/test_torch_train.py``'s:

* **gradients**: each leaf, gathered, within ``GRAD_REL·max|g|`` of the
  reference's; the loss and MoE aux term within ``LOSS_REL``;
* **two steps**: the loss and ``grad_norm`` within ``LOSS_REL`` relative,
  every update within ``2·lr`` of the reference's and, where the
  gradient matters (``|g| ≥ MASK_REL·max|g|`` of its leaf, at both
  steps), within ``UPDATE_REL·(lr + |Δp_ref|)``;
* **the port's own contracts**, bitwise: ``remat`` "none", "full" and
  "dots" on the split; gradients after a ``serve`` of the same placed
  weights (its cached block views); a kill-and-resume through ``train``;
  ``remesh`` 2×2 → 1×2 and the next step at twice the microbatches; a
  ``ParamTree`` on 2×2 stepping as before (the one-device step at
  ``dp·mb`` microbatches, no reduction);
* **the all-reduces** of a pass and of a step equal the design's count
  (:func:`design_reduces`, ``PERF.md`` §3).
"""
import dataclasses
import json
import math
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import mesh as mesh_mod
from repro_torch.data import TokenDataset, shard_batch
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.models import model as M
from repro_torch.models.model import ParamTree
from repro_torch.optim import clip_by_global_norm
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel import (PartitionSpec as P, ShardedTensor,
                                  param_specs_for, rules_for, use_sharding)
from repro_torch.parallel.tensor import (ModelSplit, PlacedParams,
                                         place_params)
from repro_torch.runtime import FaultInjector, remesh, shrink_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ref_configs.ARCHS
B, S = 4, 12
GRAD_REL = 1e-4
LOSS_REL = 1e-5
UPDATE_REL = 1e-3
MASK_REL = 1e-4
#: the updates held to the port's one-device step instead of the
#: reference's, as measured: (arch, mesh, leaf, step) → (elements at most,
#: ceiling on the update's distance from the reference's over the bound).
#: rwkv6-7b's one element of ``ts_b`` at step 1 on 2×2 reads 1.58× the
#: bound (its gradient 1.5e-4 of the leaf's largest); the one-device step
#: strays on it too, where the libraries' float32 roundings differ
ONE_DEVICE_STRAYS = {
    ("rwkv6-7b", (2, 2), "['segments'][0]['tm']['ts_b']", 1): (1, 2.0)}
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)
#: every arch on 2×2; on 1×4 qwen3-0.6b's two kv heads (gathered
#: projections, the core on one position) and rwkv6-7b's one head a
#: position
CASES = [(a, (2, 2)) for a in ARCHS] + [("qwen3-0.6b", (1, 4)),
                                        ("rwkv6-7b", (1, 4))]
IDS = [f"{a}-{d}x{m}" for a, (d, m) in CASES]
#: zamba2's first two periods (tests/test_torch_train.py's ``CUT``)
CUT = {"zamba2-2.7b": (("mamba", 2), ("mamba_shared", 1)) * 2}

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh2d
from repro.models import model as RM
from repro.parallel.params import param_specs_for, rules_for
from repro.parallel.sharding import use_sharding

CASES, CUT, (B, S), STEP_KW = json.loads(sys.argv[2])
out = {}


def batch(cfg, seed):
    shape = (B, S + 1) if cfg.n_codebooks == 1 else (B, S + 1,
                                                     cfg.n_codebooks)
    rows = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


for arch, dims in CASES:
    kw = {}
    if arch in CUT:
        seg = tuple(tuple(s) for s in CUT[arch])
        kw = dict(segments=seg, n_layers=sum(c for _, c in seg))
    cfg = get_config(arch).smoke(**kw)
    mesh = make_mesh2d(*dims)
    rules = rules_for(cfg, mesh)
    params = RM.init_params(jax.random.PRNGKey(1), cfg)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    if f"{arch}|w0" not in out:
        for i, leaf in enumerate(flat(params)):
            out[f"{arch}|w{i}"] = leaf
    specs = param_specs_for(cfg, params, rules)
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, jax.sharding.NamedSharding(mesh, s)), params, specs)
    dp = dims[0] if (B % dims[0] == 0) else 1
    scfg = dataclasses.replace(cfg, num_microbatches=dp)
    n = B // dp
    with use_sharding(rules):
        vg = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(p, b, cfg),
                                        has_aux=True))
        (loss, met), g = vg(placed, {kk: v[:n] for kk, v in
                                     batch(cfg, 0).items()})
        out[key + "loss"], out[key + "aux"] = float(loss), float(met["aux"])
        for i, leaf in enumerate(flat(g)):
            out[key + f"g{i}"] = leaf
        step = jax.jit(ref_steps.make_train_step(scfg, **STEP_KW))
        opt = ref_steps.make_opt_state(placed)
        p = placed
        for k in range(2):
            b = batch(cfg, 10 + k)
            gs = [flat(vg(p, {kk: v[i * n:(i + 1) * n]
                              for kk, v in b.items()})[1])
                  for i in range(dp)]
            for i, parts in enumerate(zip(*gs)):
                out[key + f"step{k}|g{i}"] = sum(parts) / dp
            p, opt, m = step(p, opt, b)
            for name in ("loss", "grad_norm", "lr"):
                out[key + f"step{k}|{name}"] = float(m[name])
            for i, leaf in enumerate(flat(p)):
                out[key + f"step{k}|p{i}"] = leaf
np.savez(sys.argv[1], **out)
"""


def _smoke(arch, **kw):
    if arch in CUT:
        kw = dict(segments=CUT[arch],
                  n_layers=sum(c for _, c in CUT[arch]), **kw)
    return port_configs.get_config(arch).smoke(**kw)


def _batch(cfg, seed, b=B, rows=None):
    """``REF_SCRIPT``'s batch ``seed`` (its first ``rows`` rows), as int64
    tensors."""
    shape = (b, S + 1) if cfg.n_codebooks == 1 else (b, S + 1,
                                                     cfg.n_codebooks)
    out = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int64)[:rows]
    return {"tokens": torch.from_numpy(out[:, :-1]),
            "labels": torch.from_numpy(out[:, 1:])}


def _dp(dims) -> int:
    """The replicas of :data:`B` rows on ``dims`` (the batch over data)."""
    return dims[0] if B % dims[0] == 0 else 1


def _ref_groups():
    """:data:`CASES` in five groups of about the same reference time (30-45
    s alone on a CPU host, zamba2's cut model the longest), one process
    each, run at once."""
    heavy = {"zamba2-2.7b": 0, "rwkv6-7b": 1, "deepseek-v2-236b": 2,
             "minicpm3-4b": 2, "mixtral-8x7b": 2}
    groups = [[] for _ in range(5)]
    light = 0
    for arch, dims in CASES:
        if arch in heavy:
            groups[heavy[arch]].append((arch, dims))
        else:
            groups[3 + light % 2].append((arch, dims))
            light += 1
    return groups


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start the reference's 4-device processes (:func:`_ref_groups`) at
    the module's first test, so that they run beside the tests that do
    not read them (which come first); stop any left at the end."""
    tmp = tmp_path_factory.mktemp("train_split")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    runs, threads = [], torch.get_num_threads()
    # the port's tests here are smoke()-sized: two threads, beside the
    # reference's processes, are enough
    torch.set_num_threads(min(threads, 2))
    try:
        for i, cases in enumerate(_ref_groups()):
            path = str(tmp / f"ref{i}.npz")
            runs.append((path, subprocess.Popen(
                [sys.executable, "-c", REF_SCRIPT, path,
                 json.dumps([cases, CUT, (B, S), STEP_KW])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)))
        yield runs
    finally:
        torch.set_num_threads(threads)
        for _, run in runs:
            if run.poll() is None:
                run.kill()
                run.wait()


@pytest.fixture(scope="module")
def ref(_reference_runs):
    """The reference's GSPMD gradients and steps for every case."""
    out = {}
    for path, run in _reference_runs:
        _, err = run.communicate(timeout=900)
        assert run.returncode == 0, err[-4000:]
        out.update(np.load(path))
    return out


_PARAMS = {}


def _params(ref, arch):
    """The reference's ``PRNGKey(1)`` weights as the port's ``ParamTree``
    (a fresh copy: the steps update it in place)."""
    if arch not in _PARAMS:
        rcfg = ref_configs.get_config(arch).smoke(
            **({} if arch not in CUT else dict(
                segments=CUT[arch], n_layers=sum(c for _, c in CUT[arch]))))
        like = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                              jax.random.PRNGKey(1))
        flat, treedef = jax.tree.flatten(like)
        _PARAMS[arch] = jax.tree.unflatten(
            treedef, [ref[f"{arch}|w{i}"] for i in range(len(flat))])
    return lm_params_from_numpy(_PARAMS[arch], _smoke(arch), "cpu")


def _placed(ref, arch, dims, **cfg_kw):
    cfg = _smoke(arch, **cfg_kw)
    rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
    return cfg, rules, place_params(_params(ref, arch), rules, cfg)


def _gathered(tree):
    """A placed tree's global values in the reference's layout and leaf
    order, float64."""
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(
        lm_params_to_numpy(ParamTree(tree_map(lambda st: st.gather(),
                                              tree))))]


# ---------------------------------------------------------------------------
# the design's all-reduces
# ---------------------------------------------------------------------------

def layer_reduces(cfg, kind: str, m: int):
    """(forward, backward) all-reduces of one layer of ``kind`` in a pass
    on a ``model`` axis of ``m`` (``PERF.md`` §3): the forward's sums of
    partials, and the backward's sums of the units' gradients of what they
    read whole (:meth:`~repro_torch.parallel.tensor.ModelSplit.fan`)."""
    if kind in ("attn", "attn_moe"):
        heads = cfg.n_kv_heads % m == 0
        # wo and the MLP's (mixtral: the experts' expert_mlp) partials;
        # x into the q/k/v units and into the MLP's (the dispatched slots
        # into the experts'), the qk-norm scales each head unit applies
        return 2, 2 + (2 if heads and cfg.qk_norm else 0)
    if kind in ("mla", "mla_moe"):
        # wo and the MLP's (deepseek-v2: the shared experts') partials;
        # x into the head units, the latents' wq_a, q_norm, wkv_a and
        # kv_norm each head unit applies whole, x into the MLP's units
        return 2, 6
    if kind == "rwkv":
        # wo; the time mix's r, k, v, g streams and decay LoRA, the
        # channel mix's xk, xr and k (its outputs are gathered)
        return 1, 8
    if kind in ("mamba", "mamba_shared"):
        s = cfg.ssm
        cols = 2 * s.d_inner + 2 * s.d_state + s.n_heads
        # the gated norm's sum of squares and out_proj; x into in_proj's
        # units, B and C into the SSD's head units, the sum of squares
        # into the norm's units
        f, b = 2, ((cols % m == 0) + 2 * (s.n_heads % m == 0)
                   + (s.d_inner % m == 0))
        if kind == "mamba_shared":
            f, b = f + 2, b + 2      # the shared attention's and MLP's
        return f, b
    raise ValueError(kind)


def design_reduces(cfg, m: int) -> int:
    """The all-reduces of one pass: the embedding's sum and the lm_head's
    input gradient, each layer's forward and backward, and with ``remat``
    each layer's forward again (its recompute runs the whole layer)."""
    n = 2
    for kind, count in cfg.segments:
        f, b = layer_reduces(cfg, kind, m)
        n += count * (f + b + (f if cfg.remat != "none" else 0))
    return n


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _fresh(arch, dims, seed=1, **cfg_kw):
    cfg = _smoke(arch, **cfg_kw)
    rules = rules_for(cfg, make_mesh2d(*dims, device="cpu"))
    params = M.init_params(cfg, seed=seed, device="cpu")
    return cfg, rules, params, place_params(params, rules, cfg)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_all_reduces_a_pass_and_a_step(arch, dims):
    """A replica's pass (the split bound to it) counts
    :func:`design_reduces`; a step at 2 microbatches counts
    ``dp·mb`` passes and the clip's one; the one-device pass none."""
    cfg, rules, params, placed = _fresh(arch, dims, num_microbatches=2)
    batch = _batch(cfg, 3)
    split = ModelSplit(rules, B // 2, torch.float32)
    with use_sharding(rules):
        mesh_mod.reset_collectives()
        M.value_and_grad(placed, {k: v[:split.rows] for k, v in
                                  batch.items()}, cfg,
                         split=split.bind(split.dp - 1))
        per_pass = mesh_mod.collectives["all-reduce"]
        mesh_mod.reset_collectives()
        port_steps.make_train_step(cfg)(placed,
                                        port_steps.make_opt_state(placed),
                                        batch)
        per_step = mesh_mod.collectives["all-reduce"]
        mesh_mod.reset_collectives()
        M.value_and_grad(params, batch, cfg)
        assert mesh_mod.collectives["all-reduce"] == 0
    assert per_pass == design_reduces(cfg, dims[1])
    assert per_step == split.dp * 2 * per_pass + 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_remat_counts_the_recomputed_forward(arch):
    """Under ``remat`` the backward re-runs each layer's forward, its
    reductions with it: a pass counts each layer's forward twice."""
    cfg, rules, _, placed = _fresh(arch, (2, 2), remat="dots")
    split = ModelSplit(rules, 2, torch.float32)
    with use_sharding(rules):
        mesh_mod.reset_collectives()
        M.value_and_grad(placed, {k: v[:split.rows] for k, v in
                                  _batch(cfg, 4, b=2).items()}, cfg,
                         split=split.bind(0))
    assert mesh_mod.collectives["all-reduce"] == design_reduces(cfg, 2)
    assert design_reduces(cfg, 2) > design_reduces(
        dataclasses.replace(cfg, remat="none"), 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits_on_the_split(arch):
    """``remat`` "full" and "dots" recompute the same ops, reductions
    included, on the same inputs: the split's loss and every gradient
    bitwise "none"'s."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, rules, _, placed = _fresh(arch, (2, 2), remat=remat)
        with use_sharding(rules):
            (loss, _), grads = M.value_and_grad(placed, _batch(cfg, 2), cfg)
        out[remat] = (float(loss), [g.local() for g in leaves(grads)])
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "zamba2-2.7b"])
def test_cached_blocks_carry_gradients(arch):
    """Serving fills each placed leaf's cache of block views; a pass after
    it (and after another pass) takes its blocks from the tensors that
    record gradients: every gradient bitwise a fresh placement's, none
    lost."""
    cfg, rules, params, placed = _fresh(arch, (2, 2))
    fresh = place_params(params, rules, cfg)
    batch = _batch(cfg, 5)
    with use_sharding(rules):
        with torch.no_grad():
            M.prefill(placed, batch["tokens"], cfg, S + 2)
        assert any(st._views for st in leaves(placed))
        _, want = M.value_and_grad(fresh, batch, cfg)
        for _ in range(2):
            _, got = M.value_and_grad(placed, batch, cfg)
            for a, b in zip(leaves(got), leaves(want)):
                assert torch.equal(a.local(), b.local())
                assert float(b.local().abs().max()) > 0


def test_build_places_the_parameters_and_the_moments():
    """``build`` on 2×2 places the weights by ``param_specs_for`` (as the
    reference's ``build`` does) and the moments alike; the step's
    accumulators are placed as the parameters; on 2×1, whose model axis
    splits nothing, it keeps the ``ParamTree``."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    mesh = make_mesh2d(2, 2, device="cpu")
    params, opt, _, rules = port_train.build(cfg, mesh, device="cpu",
                                             compress=True)
    assert isinstance(params, PlacedParams) and params.mesh is mesh
    ref_tree = M.init_params(cfg, seed=0, device="cpu").tree()
    specs = param_specs_for(cfg, ref_tree, rules)
    assert params["embed"].spec == ("model", None)
    for st, spec, t in zip(leaves(params), leaves(specs), leaves(ref_tree)):
        assert st.spec == spec and torch.equal(st.gather(), t)
    for tree in (opt["adam"].m, opt["adam"].v, opt["residual"]):
        for st, p in zip(leaves(tree), leaves(params)):
            assert st.spec == p.spec and st.dtype == torch.float32
    with use_sharding(rules):
        acc, _ = port_steps._accumulate_placed(params, _batch(cfg, 6), cfg,
                                               2)
    assert [a.spec for a in leaves(acc)] == [p.spec for p in leaves(params)]
    other, _, _, _ = port_train.build(cfg, make_mesh2d(2, 1, device="cpu"),
                                      device="cpu")
    assert isinstance(other, ParamTree)


def test_clip_sums_each_block_once():
    """The placed clip: each unit's sum of squares over its distinct
    blocks, summed over ``model`` once (one ``all-reduce``); a leaf
    replicated over ``model`` counts once, so the norm is the one-device
    clip's of the gathered gradients within float32 rounding, and the
    clipped leaves are theirs."""
    cfg, rules, _, placed = _fresh("qwen3-0.6b", (2, 2))
    with use_sharding(rules):
        _, grads = M.value_and_grad(placed, _batch(cfg, 7), cfg)
    whole = [g.local().clone() for g in leaves(grads)]
    mesh_mod.reset_collectives()
    clipped, norm = port_steps.clip_placed(grads, 0.5)
    assert mesh_mod.collectives["all-reduce"] == 1
    want, wnorm = clip_by_global_norm(whole, 0.5)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    assert float(norm) > 0.5
    for a, b in zip(leaves(clipped), want):
        torch.testing.assert_close(a.local(), b, rtol=1e-6, atol=0)


def test_param_tree_on_a_mesh_steps_as_before():
    """A ``ParamTree`` on 2×2 takes the data-parallel step, not the split:
    the one-device step at ``dp·mb`` microbatches, bitwise, and no
    reduction counted."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(num_microbatches=2)
    batch = shard_batch(TokenDataset(cfg.vocab_size, 16, 8,
                                     seed=2).next_batch(), "cpu")
    out = []
    for mb, mesh in ((4, None), (2, make_mesh2d(2, 2, device="cpu"))):
        c = dataclasses.replace(cfg, num_microbatches=mb)
        params = M.init_params(c, seed=5, device="cpu")
        opt = port_steps.make_opt_state(params)
        mesh_mod.reset_collectives()
        with use_sharding(None if mesh is None else rules_for(c, mesh)):
            _, opt, m = port_steps.make_train_step(c)(params, opt, batch)
        assert mesh_mod.collectives["all-reduce"] == 0
        out.append(({k: float(v) for k, v in m.items()},
                    [t.clone() for t in leaves({"p": params.tree(),
                                                "o": opt})]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _state(params, opt):
    return [t.gather() if isinstance(t, ShardedTensor) else t.clone()
            for t in leaves({"p": params, "o": opt})]


def test_train_resumes_bitwise_on_the_split(tmp_path):
    """``train`` on a 2×2 CPU mesh (placed parameters, 2 microbatches,
    compression): 7 steps with a checkpoint every 3; a fault in step 5
    restores step 3 into the placed blocks and replays to the
    uninterrupted run's parameters, moments, residual and step,
    bitwise."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(num_microbatches=2)
    kw = dict(steps=7, batch=8, seq=16, ckpt_every=3, device="cpu",
              compress=True, peak_lr=5e-3, warmup=2)
    p, o, step, hist = port_train.train(
        cfg, ckpt_dir=str(tmp_path / "a"),
        mesh=make_mesh2d(2, 2, device="cpu"), **kw)
    assert isinstance(p, PlacedParams) and step == 7
    straight = _state(p, o)
    with FaultInjector(fail_at=(5,), match_tag="train") as inj:
        p2, o2, step2, hist2 = port_train.train(
            cfg, ckpt_dir=str(tmp_path / "b"),
            mesh=make_mesh2d(2, 2, device="cpu"), **kw)
    assert inj.fired == [("step", 5, "train")] and step2 == 7
    resumed = _state(p2, o2)
    assert len(straight) == len(resumed)
    for a, b in zip(straight, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(math.isfinite(float(h["loss"])) for h in hist2)


def test_checkpoint_round_trip_of_placed_state(tmp_path):
    """``CheckpointManager`` saves a placed leaf as its gathered array and
    restores it placed in the target leaf's sharding, bitwise."""
    cfg, rules, _, placed = _fresh("qwen3-0.6b", (2, 2), param_dtype="bfloat16")
    opt = port_steps.make_opt_state(placed)
    opt = AdamWState(opt.step + 2, tree_map(lambda st: st.like(
        st.local() + 0.5), opt.m), opt.v)
    state = {"params": placed, "opt": opt}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    target = {"params": place_params(M.init_params(
        _smoke("qwen3-0.6b", param_dtype="bfloat16"), seed=9, device="cpu"),
        rules, cfg), "opt": port_steps.make_opt_state(placed)}
    got, step, _ = mgr.restore(target)
    assert step == 4 and type(got["opt"]) is AdamWState
    for a, b, t in zip(leaves(got), leaves(state), leaves(target)):
        if isinstance(t, ShardedTensor):
            assert a.sharding.spec == t.spec and a.mesh is t.mesh
            a, b = a.gather(), b.gather()
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remesh_then_step_is_bitwise():
    """Two placed steps on 2×2 (8 rows, 4 microbatches), ``remesh`` of
    {params, opt} onto 1×2 — placed parameters again, every leaf bitwise —
    then the next step there at ``shrink_plan``'s 8 microbatches: the
    same one-row passes on the same model split in the same order, so its
    loss, gradient norm, parameters and moments are the 2×2 run's own
    next step's, bitwise."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(num_microbatches=4)
    kw = dict(peak_lr=5e-3, warmup=2)
    ds = TokenDataset(cfg.vocab_size, 16, 8, seed=3)
    batches = [shard_batch(ds.next_batch(), "cpu") for _ in range(3)]
    mesh, shrunk = (make_mesh2d(2, 2, device="cpu"),
                    make_mesh2d(1, 2, device="cpu"))
    params, opt, step, rules = port_train.build(cfg, mesh, seed=4,
                                                device="cpu", **kw)
    with use_sharding(rules):
        for b in batches[:2]:
            params, opt, _ = step(params, opt, b)
    p = param_specs_for(cfg, params, rules_for(cfg, shrunk))
    state = {"params": params, "opt": opt}
    placed = remesh(state, {"params": p, "opt": AdamWState(P(), p, p)},
                    shrunk)
    assert isinstance(placed["params"], PlacedParams)
    assert placed["params"].mesh is shrunk
    for a, b in zip(leaves(placed), leaves(state)):
        b = b.gather() if isinstance(b, ShardedTensor) else b
        assert torch.equal(a.gather(), b)
    with use_sharding(rules):
        params, opt, want = step(params, opt, batches[2])
    mb = shrink_plan(2, 1, 8, 4)["keep_global_batch"]["num_microbatches"]
    c2 = dataclasses.replace(cfg, num_microbatches=mb)
    with use_sharding(rules_for(c2, shrunk)):
        p2, o2, got = port_steps.make_train_step(c2, **kw)(
            placed["params"], placed["opt"], batches[2])
    assert {k: float(v) for k, v in got.items()} \
        == {k: float(v) for k, v in want.items()}
    assert int(o2.step) == int(opt.step) == 3
    for a, b in zip(_state(p2, o2), _state(params, opt)):
        assert torch.equal(a, b)


def test_placed_step_refuses_what_it_cannot_split():
    """No fallback: placed parameters outside ``use_sharding`` of their
    mesh raise, as do positions on several devices."""
    cfg, rules, _, placed = _fresh("qwen3-0.6b", (2, 2))
    step = port_steps.make_train_step(cfg)
    opt = port_steps.make_opt_state(placed)
    batch = _batch(cfg, 8)
    with pytest.raises(ValueError, match="use_sharding"):
        step(placed, opt, batch)
    mesh = make_mesh2d(2, 2, device=["cpu", "cpu", "cpu", "meta"])
    other = rules_for(cfg, mesh)
    spread = place_params(M.init_params(cfg, seed=1, device="cpu"), other,
                          cfg)
    with use_sharding(other), pytest.raises(ValueError, match="one device"):
        step(spread, opt, batch)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_split_gradients_match_reference(ref, arch, dims):
    """The placed ``value_and_grad`` of one batch of a microbatch's rows
    (every row block in one split): loss, aux term and every gathered
    gradient leaf against GSPMD's; the gradients are placed as the
    parameters are, and the leaves record gradients only inside the
    call."""
    cfg, rules, placed = _placed(ref, arch, dims)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    batch = _batch(cfg, 0, rows=B // _dp(dims))
    with use_sharding(rules):
        (loss, metrics), grads = M.value_and_grad(placed, batch, cfg)
    want = float(ref[key + "loss"])
    assert abs(float(loss) - want) <= LOSS_REL * abs(want)
    assert abs(float(metrics["aux"]) - float(ref[key + "aux"])) \
        <= LOSS_REL * max(1.0, abs(float(ref[key + "aux"])))
    for g, st in zip(leaves(grads), leaves(placed)):
        assert isinstance(g, ShardedTensor)
        assert g.sharding is st.sharding and g.dtype == st.dtype
        assert not st.local().requires_grad
    for i, g in enumerate(_gathered(grads)):
        w = ref[key + f"g{i}"]
        assert g.shape == w.shape
        scale = float(np.abs(w).max()) or 1.0
        assert float(np.abs(g - w).max()) <= GRAD_REL * scale, (i, scale)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_split_train_steps_match_reference(ref, arch, dims):
    """Two steps of the placed ``make_train_step`` (one microbatch, ``dp``
    replicas) against GSPMD's at ``dp`` microbatches (module docstring):
    loss, ``grad_norm``, rate and updates within the bounds; AdamW's
    moments stay placed as the parameters.  Only the elements that
    :data:`ONE_DEVICE_STRAYS` names may leave the tight bound of the
    reference's update, as few and as far as it says, and only where the
    port's one-device step (``ParamTree``, ``dp`` microbatches: the same
    passes) strays from it too and the split is within the tight bound of
    that step's update."""
    cfg, rules, params = _placed(ref, arch, dims)
    key = f"{arch}|{dims[0]}x{dims[1]}|"
    opt = port_steps.make_opt_state(params)
    step = port_steps.make_train_step(cfg, **STEP_KW)
    one_cfg = dataclasses.replace(cfg, num_microbatches=_dp(dims))
    one = _params(ref, arch)
    one_opt = port_steps.make_opt_state(one)
    one_step = port_steps.make_train_step(one_cfg, **STEP_KW)
    paths, _ = jax.tree_util.tree_flatten_with_path(_PARAMS[arch])
    names = [jax.tree_util.keystr(path) for path, _ in paths]
    prev = [np.asarray(x, np.float64) for _, x in paths]
    mine_prev = one_prev = _gathered(params)
    significant = None
    for k in range(2):
        g = [ref[key + f"step{k}|g{i}"] for i in range(len(prev))]
        sig = [np.abs(x) >= MASK_REL * np.abs(x).max() for x in g]
        significant = sig if significant is None else [
            a & b for a, b in zip(significant, sig)]
        with use_sharding(rules):
            params, opt, m = step(params, opt, _batch(cfg, 10 + k))
        one, one_opt, _ = one_step(one, one_opt, _batch(cfg, 10 + k))
        lr = float(ref[key + f"step{k}|lr"])
        assert abs(float(m["lr"]) - lr) <= 2 * float(np.spacing(np.float32(lr)))
        for name in ("loss", "grad_norm"):
            want = float(ref[key + f"step{k}|{name}"])
            assert abs(float(m[name]) - want) <= LOSS_REL * abs(want), name
        mine = _gathered(params)
        one_now = [np.asarray(x, np.float64) for x in
                   jax.tree.leaves(lm_params_to_numpy(one))]
        ref_now = [np.asarray(ref[key + f"step{k}|p{i}"], np.float64)
                   for i in range(len(prev))]
        for name, a0, a1, o0, o1, b0, b1, mask in zip(
                names, mine_prev, mine, one_prev, one_now, prev, ref_now,
                significant):
            diff = np.abs((a1 - a0) - (b1 - b0))
            assert diff.max() <= 2 * lr, diff.max() / lr
            bound = UPDATE_REL * (lr + np.abs(b1 - b0))
            out = mask & (diff > bound)
            if out.any():
                n, ceiling = ONE_DEVICE_STRAYS.get((arch, dims, name, k),
                                                 (0, 0.0))
                assert out.sum() <= n, (name, float((diff / bound)[out].max()))
                assert (diff / bound)[out].max() <= ceiling
                # held to the port's one-device step, which strays there too
                assert (np.abs((o1 - o0) - (b1 - b0)) > bound)[out].all()
                assert (np.abs((a1 - a0) - (o1 - o0))
                        <= UPDATE_REL * (lr + np.abs(o1 - o0)))[out].all()
        mine_prev, one_prev, prev = mine, one_now, ref_now
    assert isinstance(params, PlacedParams) and int(opt.step) == 2
    for p, mo, vo in zip(leaves(params), leaves(opt.m), leaves(opt.v)):
        assert mo.sharding.spec == vo.sharding.spec == p.spec
        assert mo.dtype == vo.dtype == torch.float32
