"""The port's elastic resharding (``repro_torch.runtime.elastic``) against the
JAX reference on the CPU.

The counterparts of ``tests/test_fault.py``'s
``test_remesh_roundtrip_on_single_device_mesh`` and
``test_shrink_plan_preserves_global_batch_semantics``,
``tests/test_substrate.py::test_elastic_shrink_plan`` and
``tests/test_sharded.py::test_elastic_remesh_roundtrip``, each under its
name with ``_torch``.  ``remesh`` gathers and places, so every leaf comes
back bitwise; ``shrink_plan`` is integer arithmetic and equals the
reference's dicts exactly.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.runtime import elastic as ref_elastic
import repro_torch.configs as port_configs
from repro_torch.core.mesh import device_get
from repro_torch.data import TokenDataset, shard_batch
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.launch.steps import make_opt_state, make_train_step
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.models.model import ParamTree
from repro_torch.parallel import (PartitionSpec as P, ShardedTensor,
                                  param_specs_for, place, rules_for,
                                  use_sharding)
from repro_torch.runtime import remesh, shrink_plan


def test_remesh_roundtrip_on_single_device_mesh_torch():
    rng = np.random.default_rng(0)
    mesh = make_mesh2d(1, 1, device="cpu")
    tree = {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32)}
    specs = {"w": P("data", "model"), "b": P(None)}
    placed = remesh(tree, specs, mesh)
    again = remesh(placed, specs, mesh)  # remesh of a remesh: still exact
    for k, v in tree.items():
        assert (device_get(again[k]) == v).all()
        assert placed[k].sharding.mesh.shape == mesh.shape


def test_elastic_remesh_roundtrip_torch():
    m1 = make_mesh2d(2, 2, device="cpu")
    m2 = make_mesh2d(4, 1, device="cpu")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    specs = {"w": P("data", "model")}
    a = place(w, m1, specs["w"])
    out = remesh({"w": a}, specs, m2)
    np.testing.assert_array_equal(device_get(out["w"]), w.numpy())
    assert out["w"].sharding.mesh.shape["data"] == 4
    assert [tuple(b.shape) for b in out["w"].blocks()] == [(2, 8)] * 4


def test_shrink_plan_preserves_global_batch_semantics_torch():
    plan = shrink_plan(old_dp=8, new_dp=4, global_batch=64,
                       num_microbatches=2)
    assert plan["keep_global_batch"]["num_microbatches"] == 4
    assert plan["keep_microbatches"]["global_batch"] == 32
    assert plan["keep_microbatches"]["lr_scale"] == pytest.approx(0.5)


def test_elastic_shrink_plan_torch():
    plan = shrink_plan(old_dp=16, new_dp=8, global_batch=256,
                       num_microbatches=4)
    assert plan["keep_global_batch"]["num_microbatches"] == 8
    assert plan["keep_microbatches"]["global_batch"] == 128
    assert plan["keep_microbatches"]["lr_scale"] == 0.5


def test_shrink_plan_equals_reference_over_a_grid():
    for old_dp, new_dp, gb, mb in itertools.product(
            (1, 2, 4, 8, 16), (1, 2, 3, 4, 8), (16, 64, 256, 96), (1, 2, 4, 8)):
        if gb // (old_dp * mb) == 0:
            continue
        assert shrink_plan(old_dp, new_dp, gb, mb) \
            == ref_elastic.shrink_plan(old_dp, new_dp, gb, mb)
    # the chip smoke's shrink: 2×2 → 1×2 at 16 rows of 8 microbatches
    assert shrink_plan(2, 1, 16, 8)["keep_global_batch"] \
        == {"num_microbatches": 16}


@pytest.mark.parametrize("target", [(4, 1, 0), (1, 2, 2), (1, 1, 0)])
def test_remesh_of_training_state_is_bitwise(target):
    """``{params, AdamWState, residual}`` of a bfloat16 smoke model, placed
    by ``param_specs_for`` on 2×2 and remeshed onto 4×1, pod=2 1×2 and
    1×1 by the same rules' specs there: every leaf bitwise, the
    ``AdamWState`` rebuilt as its type, each leaf's spec the new mesh's."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(param_dtype="bfloat16")
    params = M.init_params(cfg, seed=1, device="cpu")
    opt = make_opt_state(params, compress=True)
    adam = opt["adam"]
    opt = {"adam": AdamWState(adam.step + 3,
                              tree_map(lambda t: t + 0.5, adam.m),
                              tree_map(lambda t: t + 0.25, adam.v)),
           "residual": tree_map(lambda t: t - 1.0, opt["residual"])}
    state = {"params": params.tree(), "opt": opt}

    def specs_on(mesh):
        p = param_specs_for(cfg, params.tree(), rules_for(cfg, mesh))
        return {"params": p, "opt": {"adam": AdamWState(P(), p, p),
                                     "residual": p}}

    old = make_mesh2d(2, 2, device="cpu")
    placed = remesh(state, specs_on(old), old)
    new = make_mesh2d(target[0], target[1], pod=target[2], device="cpu")
    specs = specs_on(new)
    out = remesh(placed, specs, new)
    assert type(out["opt"]["adam"]) is AdamWState
    for a, b, spec in zip(leaves(out), leaves(state), leaves(specs)):
        assert isinstance(a, ShardedTensor) and a.mesh is new
        assert a.spec == spec and a.dtype == b.dtype
        got = a.gather()
        assert torch.equal(got.view(torch.uint8) if got.dtype.is_floating_point
                           else got, b.view(torch.uint8)
                           if b.dtype.is_floating_point else b)
    assert specs["params"]["embed"] == ("model", None)


def test_step_after_remesh_continues_the_run_bitwise():
    """``chip_smoke.py``'s elastic path at ``smoke()``: two steps on 2×2
    (8 rows of 512, 4 microbatches), ``remesh`` of {params, opt} onto 1×2,
    then the next step there at ``shrink_plan``'s ``keep_global_batch``
    (8 microbatches, not sharded over data = 1).  It runs the 2×2 step's
    one-row passes in the same order, so its loss, gradient norm, updated
    parameters and AdamW moments are the 2×2 run's own next step's,
    bitwise."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(num_microbatches=4)
    kw = dict(peak_lr=5e-3, warmup=2)
    ds = TokenDataset(cfg.vocab_size, 16, 8, seed=3)
    batches = [shard_batch(ds.next_batch(), "cpu") for _ in range(3)]
    mesh, shrunk = make_mesh2d(2, 2, device="cpu"), make_mesh2d(1, 2,
                                                                device="cpu")
    params = M.init_params(cfg, seed=4, device="cpu")
    opt = make_opt_state(params)
    step = make_train_step(cfg, **kw)
    with use_sharding(rules_for(cfg, mesh)):
        for b in batches[:2]:
            params, opt, _ = step(params, opt, b)
        p = param_specs_for(cfg, params.tree(), rules_for(cfg, shrunk))
        placed = remesh({"params": params.tree(), "opt": opt},
                        {"params": p, "opt": AdamWState(P(), p, p)}, shrunk)
        params, opt, want = step(params, opt, batches[2])
    mb = shrink_plan(2, 1, 8, 4)["keep_global_batch"]["num_microbatches"]
    c2 = dataclasses.replace(cfg, num_microbatches=mb)
    p2 = ParamTree(tree_map(lambda st: st.local(), placed["params"]))
    o2 = tree_map(lambda st: st.local(), placed["opt"])
    with use_sharding(rules_for(c2, shrunk)):
        p2, o2, got = make_train_step(c2, **kw)(p2, o2, batches[2])
    assert {k: float(v) for k, v in got.items()} \
        == {k: float(v) for k, v in want.items()}
    assert int(o2.step) == int(opt.step) == 3
    for a, b in zip(leaves({"p": p2.tree(), "o": o2}),
                    leaves({"p": params.tree(), "o": opt})):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
