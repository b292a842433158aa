"""The port's LM training (``repro_torch.launch.{steps,train}``, the models'
backward and ``remat``) against the JAX reference on the CPU.

Weights are the reference's ``init_params`` carried across by
:func:`repro_torch.convert.lm_params_from_numpy`; tokens come from NumPy
with a seed; everything is float32 at each architecture's ``smoke()``.  The
reference is jitted once per function and architecture.  Bounds:

* **gradients** of ``loss_fn``: each leaf within ``GRAD_REL·max|g|`` of
  the reference's leaf, the loss within ``LOSS_REL`` relative — the two
  libraries sum the products in other orders and XLA fuses ``a·b + c``;
  zamba2's chunked SSD scan is the farthest, at 4.2e-5 of max|g| over
  its whole smoke() (the tests keep two periods of it, ``CUT``);
* **the whole step**, two consecutive steps of ``make_train_step``:
  the loss and ``grad_norm`` within ``LOSS_REL`` relative and the rate
  within 2 float32 ulps.  A first AdamW step moves each parameter by about
  ``lr·sign(g)``, and at the first two steps ``|m̂/(√v̂+ε)| ≤ 1``, so an
  element whose gradient is at rounding-noise level may move the other
  way: every element of the update ``Δp`` is within ``2·lr`` of the
  reference's.  Where the gradient matters (``|g_ref| ≥ 1e-4·max|g_ref|``
  of its leaf, at every step so far) the update is within
  ``UPDATE_REL·(lr + |Δp_ref|)``.
* **with compression** the dequantized gradient may differ by one
  quantization step ``s = max|g + r|/127`` per element (a value on a
  rounding boundary of ``g/s``): the residual is within ``s`` of the
  reference's, ``grad_norm`` within ``√(Σ n·s²)`` over the leaves (one
  step in every element), and the tight update bound holds at the first
  step on elements at least two steps from zero; later steps keep the
  ``2·lr`` bound.
* ``remat`` ``"none"``, ``"full"`` and ``"dots"`` give bitwise the same
  loss and gradients (the same ops recomputed on the same inputs).
"""
import dataclasses
import math
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import model as RM
import repro_torch.configs as port_configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.models.model import ParamTree
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.tree import leaves
from repro_torch.runtime import FaultInjector

ARCHS = ref_configs.ARCHS
B, S = 4, 12
GRAD_REL = 1e-4
LOSS_REL = 1e-5
UPDATE_REL = 1e-3
MASK_REL = 1e-4
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)


def _tokens(cfg, seed, b, s):
    shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


def _batch(cfg, seed, b=B, s=S):
    rows = _tokens(cfg, seed, b, s + 1)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _flat(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _port_flat(params):
    return _flat(lm_params_to_numpy(params))


#: zamba2's smoke() is 27 layers in 18 segments, and the reference's
#: gradient of it takes about 25 s to trace and compile; the parity tests
#: keep its first two periods (mamba, mamba, mamba_shared twice): every
#: block kind at smoke() widths, the shared block used twice
CUT = {"zamba2-2.7b": (("mamba", 2), ("mamba_shared", 1)) * 2}


def _smoke(configs, arch, **kw):
    if arch in CUT:
        kw = dict(segments=CUT[arch],
                  n_layers=sum(c for _, c in CUT[arch]), **kw)
    return configs.get_config(arch).smoke(**kw)


_REF = {}


def reference(arch):
    """The reference's smoke() params and its jitted value_and_grad."""
    if arch not in _REF:
        cfg = _smoke(ref_configs, arch)
        _REF[arch] = (cfg, RM.init_params(jax.random.PRNGKey(1), cfg),
                      jax.jit(jax.value_and_grad(
                          lambda p, b: RM.loss_fn(p, b, cfg), has_aux=True)))
    return _REF[arch]


def port(arch, **overrides):
    cfg = _smoke(port_configs, arch, **overrides)
    tree = jax.tree.map(np.asarray, reference(arch)[1])
    return cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _port_grads(params, batch, cfg):
    (loss, metrics), grads = M.value_and_grad(params, _t(batch), cfg)
    return loss, metrics, _flat(lm_params_to_numpy(ParamTree(grads)))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    rcfg, rparams, vg = reference(arch)
    batch = _batch(rcfg, 1)
    (want, wm), wg = vg(rparams, batch)
    cfg, params = port(arch)
    loss, metrics, grads = _port_grads(params, batch, cfg)
    assert abs(float(loss) - float(want)) <= LOSS_REL * abs(float(want))
    assert abs(float(metrics["aux"]) - float(wm["aux"])) \
        <= LOSS_REL * max(1.0, abs(float(wm["aux"])))
    paths = jax.tree_util.tree_flatten_with_path(wg)[0]
    assert len(grads) == len(paths)
    for g, (path, w) in zip(grads, paths):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale, (jax.tree_util.keystr(path), err,
                                         scale)
    assert not any(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    """``remat`` "full" and "dots" recompute the same ops on the same
    inputs: the loss and every gradient bitwise "none"'s."""
    batch = _batch(_smoke(port_configs, arch), 2)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, params = port(arch, remat=remat)
        loss, _, grads = _port_grads(params, batch, cfg)
        out[remat] = (float(loss), grads)
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            np.testing.assert_array_equal(a, b)


def _policy_ops(arch, policy):
    """The aten ops a layer's selective checkpoint sees (forward and
    recompute) under ``policy``'s decisions, by name."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    seen = {}

    def record(ctx, op, *args, **kwargs):
        decision = M._save_dots(ctx, op, *args, **kwargs)
        seen.setdefault(str(op), set()).add(decision.name)
        return decision

    cfg, params = port(arch, remat="dots")
    old = M._dots_contexts
    M._dots_contexts = lambda: create_selective_checkpoint_contexts(record)
    try:
        _port_grads(params, _batch(cfg, 3), cfg)
    finally:
        M._dots_contexts = old
    return seen


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_dots_policy_saves_the_projections_only(arch):
    """On the ops the policy sees: the projections ``x @ W`` arrive as
    ``aten.mm`` and are saved; the attention (and expert) einsums arrive
    as ``aten.bmm`` and are recomputed, like every other op; no other
    matrix product reaches the policy."""
    seen = _policy_ops(arch, M._save_dots)
    assert seen["aten.mm.default"] == {"MUST_SAVE"}
    assert seen["aten.bmm.default"] == {"PREFER_RECOMPUTE"}
    products = {"aten.addmm.default", "aten.matmul.default",
                "aten.dot.default", "aten.mv.default", "aten.baddbmm.default",
                "aten.einsum.default"}
    assert not products & set(seen), products & set(seen)
    saved = {op for op, d in seen.items() if "MUST_SAVE" in d}
    assert saved == {"aten.mm.default"}


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

def _ref_grads(arch, rparams, batch, mb):
    """The reference's (accumulated) float32 gradient of one step."""
    vg = reference(arch)[2]
    b = batch["tokens"].shape[0]
    parts = []
    for i in range(mb):
        rows = slice(i * b // mb, (i + 1) * b // mb)
        parts.append(_flat(vg(rparams, {k: v[rows]
                                        for k, v in batch.items()})[1]))
    return [sum(x) / mb for x in zip(*parts)]


_STEPS = {}


def _ref_step(arch, mb, compress):
    key = (arch, mb, compress)
    if key not in _STEPS:
        cfg = _smoke(ref_configs, arch, num_microbatches=mb)
        _STEPS[key] = jax.jit(ref_steps.make_train_step(
            cfg, compress=compress, **STEP_KW))
    return _STEPS[key]


@pytest.mark.parametrize("arch,mb,compress", [
    ("qwen3-0.6b", 1, False), ("qwen3-0.6b", 2, False),
    ("qwen3-0.6b", 1, True), ("qwen3-0.6b", 2, True),
    ("mixtral-8x7b", 2, False)])
def test_train_step_matches_reference(arch, mb, compress):
    """Two consecutive steps from the same weights (bounds in the module
    docstring)."""
    rcfg = _smoke(ref_configs, arch, num_microbatches=mb)
    rparams = reference(arch)[1]
    ropt = ref_steps.make_opt_state(rparams, compress=compress)
    rstep = _ref_step(arch, mb, compress)
    cfg, params = port(arch, num_microbatches=mb)
    opt = port_steps.make_opt_state(params, compress=compress)
    step = port_steps.make_train_step(cfg, compress=compress, **STEP_KW)

    mine_prev, ref_prev = _port_flat(params), _flat(rparams)
    significant = None
    for k in range(2):
        batch = _batch(rcfg, 10 + k)
        g = _ref_grads(arch, rparams, batch, mb)
        if compress:
            gf = [a + r for a, r in zip(g, _flat(ropt["residual"]))]
            quanta = [float(np.abs(x).max()) / 127 for x in gf]
            sig = [np.abs(x) >= 2 * q for x, q in zip(gf, quanta)]
        else:
            sig = [np.abs(x) >= MASK_REL * np.abs(x).max() for x in g]
        significant = sig if significant is None else [
            a & b for a, b in zip(significant, sig)]
        rparams, ropt, rm = rstep(rparams, ropt, batch)
        params, opt, m = step(params, opt, _t(batch))

        lr = float(rm["lr"])
        assert abs(float(m["lr"]) - lr) <= 2 * float(np.spacing(np.float32(lr)))
        assert m["lr"].dtype == torch.float32
        assert abs(float(m["loss"]) - float(rm["loss"])) \
            <= LOSS_REL * abs(float(rm["loss"]))
        gnorm_tol = LOSS_REL * float(rm["grad_norm"])
        if compress:
            gnorm_tol += math.sqrt(sum(x.size * q * q
                                       for x, q in zip(gf, quanta)))
            for a, b, q in zip(_flat(lm_params_to_numpy(ParamTree(
                    opt["residual"]))), _flat(ropt["residual"]), quanta):
                assert np.abs(a - b).max() <= q * (1 + 1e-5)
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
            <= gnorm_tol

        mine, ref = _port_flat(params), _flat(rparams)
        tight = k == 0 or not compress
        for a0, a1, b0, b1, mask in zip(mine_prev, mine, ref_prev, ref,
                                        significant):
            diff = np.abs((a1 - a0) - (b1 - b0))
            assert diff.max() <= 2 * lr, diff.max() / lr
            if tight and mask.any():
                bound = UPDATE_REL * (lr + np.abs(b1 - b0))
                assert (diff <= bound)[mask].all(), \
                    float((diff / bound)[mask].max())
        mine_prev, ref_prev = mine, ref
    adam = opt["adam"] if compress else opt
    radam = ropt["adam"] if compress else ropt
    assert isinstance(adam, AdamWState)
    assert int(adam.step) == int(radam.step) == 2
    assert adam.step.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    """``tests/test_models.py::test_smoke_forward_and_train_step`` on the
    port: one forward and one train step on the reduced config."""
    cfg = port_configs.get_config(arch).smoke()
    params = M.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 0, 2, 16).astype(np.int64))

    logits, aux = M.forward(params, tokens, cfg)
    want = ((2, 16, cfg.vocab_size) if cfg.n_codebooks == 1
            else (2, 16, cfg.n_codebooks, cfg.vocab_size))
    assert tuple(logits.shape) == want
    assert not torch.isnan(logits).any()

    before = [p.clone() for p in params.parameters()]
    step = port_steps.make_train_step(cfg)
    opt = port_steps.make_opt_state(params)
    params2, opt2, metrics = step(params, opt,
                                  {"tokens": tokens, "labels": tokens})
    assert math.isfinite(float(metrics["loss"]))
    assert int(opt2.step) == 1
    # params actually moved
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(before, params2.parameters()))


def test_serving_after_training():
    """A train step leaves the parameters frozen again: ``serve``,
    ``prefill`` and ``decode_step`` build no autograd graph, and on
    unchanged weights (a step at rate 0) the greedy tokens are those of
    before training."""
    cfg, params = port("qwen3-0.6b")
    prompts = torch.from_numpy(_tokens(cfg, 4, 2, 8).astype(np.int64))

    def greedy():
        logits, cache = M.prefill(params, prompts, cfg, 12)
        toks = [torch.argmax(logits, dim=-1)]
        for pos in range(8, 11):
            logits, cache = M.decode_step(params, cache, toks[-1], pos, cfg)
            toks.append(torch.argmax(logits, dim=-1))
        assert logits.grad_fn is None and not logits.requires_grad
        return torch.cat(toks, dim=1)

    before, served = greedy(), serve(cfg, batch=2, prompt_len=8, gen=4,
                                     device="cpu")[0]
    weights = [p.clone() for p in params.parameters()]
    step = port_steps.make_train_step(cfg, peak_lr=0.0)
    params, _, metrics = step(params, port_steps.make_opt_state(params),
                              _t(_batch(cfg, 5)))
    assert float(metrics["lr"]) == 0.0
    assert not any(p.requires_grad for p in params.parameters())
    for a, b in zip(weights, params.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(greedy(), before)
    assert torch.equal(serve(cfg, batch=2, prompt_len=8, gen=4,
                             device="cpu")[0], served)


# ---------------------------------------------------------------------------
# the driver, the checkpoint and the device
# ---------------------------------------------------------------------------

def _state_leaves(params, opt):
    return [t.clone() for t in leaves({"params": params.tree(), "opt": opt})]


@pytest.mark.parametrize("compress", [False, True])
def test_train_main_resumes_bitwise(tmp_path, compress):
    """``launch/train.main`` at ``smoke()``: 8 steps, a checkpoint every 3;
    a fault injected in step 5 (``FaultInjector`` on the step hook)
    restores step 3 and the stream and replays to the uninterrupted run's
    parameters, moments, step and residual, bitwise."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "16", "--ckpt-every", "3", "--device", "cpu"] \
        + (["--compress"] if compress else [])
    straight = _state_leaves(*port_train.main(
        argv + ["--ckpt-dir", str(tmp_path / "a")]))
    with FaultInjector(fail_at=(5,), match_tag="train") as inj:
        resumed = _state_leaves(*port_train.main(
            argv + ["--ckpt-dir", str(tmp_path / "b")]))
    assert inj.fired == [("step", 5, "train")]
    assert len(straight) == len(resumed)
    for a, b in zip(straight, resumed):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_train_loss_falls_on_the_cpu(tmp_path):
    """At a training rate the smoke model learns the stream's bigrams:
    the mean loss of the last 5 of 30 steps is below that of the first 5."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    _, _, step, history = port_train.train(
        cfg, steps=30, batch=8, seq=32, ckpt_dir=str(tmp_path),
        ckpt_every=100, device="cpu", peak_lr=1e-3, warmup=5,
        total_steps=30)
    losses = [float(h["loss"]) for h in history]
    assert step == 30 and len(losses) == 30
    assert all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_build_needs_a_card():
    """``build(cfg)`` with the default device raises where there is no
    card, as does a mesh of the card; nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.build(cfg)
    from repro_torch.launch.mesh import make_mesh2d
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh2d(2, 2)
    from repro_torch.data import shard_batch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_batch({"tokens": np.zeros((1, 2), np.int32)})


def test_train_module_runs_as_a_script(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--smoke", "--steps", "4", "--batch", "2", "--seq",
         "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.startswith("trained 4 steps")


def test_checkpoint_restores_a_namedtuple(tmp_path):
    """An ``AdamWState``-shaped NamedTuple of bfloat16 and float32 leaves
    survives a round trip through the port's ``CheckpointManager``."""
    class State(NamedTuple):
        step: torch.Tensor
        m: dict
        v: dict

    state = {"params": {"w": torch.arange(6.0).reshape(2, 3).bfloat16()},
             "opt": AdamWState(torch.tensor(7, dtype=torch.int32),
                               {"w": torch.full((2, 3), 0.25)},
                               {"w": torch.full((2, 3), 1e-3)}),
             "other": State(torch.tensor(1), {"a": [torch.ones(2)]},
                            {"b": (torch.zeros(1, dtype=torch.bfloat16),)})}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, extra={"data": {"seed": 0, "step": 5}})
    target = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
              "opt": AdamWState(torch.tensor(0, dtype=torch.int32),
                                {"w": torch.zeros(2, 3)},
                                {"w": torch.zeros(2, 3)}),
              "other": State(torch.tensor(0), {"a": [torch.zeros(2)]},
                             {"b": (torch.ones(1, dtype=torch.bfloat16),)})}
    got, step, extra = mgr.restore(target)
    assert step == 5 and extra["data"]["step"] == 5
    assert type(got["opt"]) is AdamWState and type(got["other"]) is State
    assert isinstance(got["other"].v["b"], tuple)
    for a, b in zip(leaves(got), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remat_applies_only_while_autograd_records():
    """Under ``torch.no_grad`` (serving) the layers run as they are: no
    checkpoint wraps them; the forward's logits equal remat "none"'s."""
    cfg, params = port("qwen3-0.6b", remat="dots")
    fn = lambda *a: None                       # noqa: E731
    with torch.no_grad():
        assert M._remat(fn, cfg) is fn
    assert M._remat(fn, dataclasses.replace(cfg, remat="none")) is fn
    assert M._remat(fn, cfg) is not fn
    tokens = torch.from_numpy(_tokens(cfg, 6, 2, 8).astype(np.int64))
    with torch.no_grad():
        a, _ = M.forward(params, tokens, cfg)
        b, _ = M.forward(params, tokens,
                         dataclasses.replace(cfg, remat="none"))
    assert torch.equal(a, b)
