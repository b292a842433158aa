"""The port's mesh half of LM training (``repro_torch.parallel``, the N-D
``core/mesh.py``, ``launch/mesh.py``, ``psum_compressed`` and the
data-parallel train step) against the JAX reference on the CPU.

The reference's multi-device side runs once, in one subprocess with 8
host devices (``REF_SCRIPT``): its 2×2 train step, ``psum_compressed``
inside ``shard_map`` and ``NamedSharding.devices_indices_map``.  The rule
tables are compared in process (``jax.eval_shape`` with a mesh that has only
``axis_names`` and ``devices``).  Bounds:

* spec tables, placed blocks' index ranges and ``psum_compressed``:
  equal (bitwise for ``psum_compressed``: the same quantization and an
  integer sum);
* the 2×2 train step against the reference's 4-device one, three steps
  from the reference's own weights: loss and ``grad_norm`` within
  ``LOSS_REL`` relative (``tests/test_torch_train.py``'s bound; the two sum
  products in other orders);
* the port's 2×2 step against its 1×1 step: loss and ``grad_norm`` within
  ``MESH_REL`` relative — the same products, only the order of the sums of
  the replicas' gradients and losses differs;
* MoE's load-balance term is not linear in the rows, so on a mesh the
  loss moves by ``0.01 ×`` the mean of the replicas' terms less the whole
  microbatch's, which the test computes from forwards over those rows and
  holds within ``MESH_REL``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.parallel as ref_parallel
from repro.core.jaxcompat import make_mesh as ref_make_mesh
from repro.models import model as RM
from repro.parallel import params as ref_params
from repro.parallel import sharding as ref_sharding
import repro_torch.configs as port_configs
import repro_torch.parallel as tp
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.mesh import (BrickArray, NamedSharding, make_mesh, psum,
                                   psum_axes)
from repro_torch.data import TokenDataset, shard_batch
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_mesh2d, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.optim.compression import psum_compressed
from repro_torch.optim.tree import leaves, leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ref_configs.ARCHS
LOSS_REL = 1e-5
MESH_REL = 1e-6
UPDATE_REL, MASK_REL = 1e-3, 1e-4
TRAIN_KW = dict(peak_lr=5e-3, warmup=2)
REF_STEPS = 3

#: (mesh dims, axis names, spec, global shape) of the placement cases
PLACE_CASES = [
    ((2, 2), ("data", "model"), ("data", "model"), (8, 6)),
    ((2, 2), ("data", "model"), ("model", None), (4, 3)),
    ((2, 2), ("data", "model"), (None, ("data", "model")), (3, 8)),
    ((2, 2), ("data", "model"), (("model", "data"),), (4, 5)),
    ((2, 2), ("data", "model"), (), (3, 2)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model"),
     (8, 3, 4)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", "pod"), (4, 6)),
    ((2, 2, 2), ("pod", "data", "model"), (None, ("data", "model", "pod")),
     (1, 16)),
    ((2, 2, 2), ("pod", "data", "model"), ("data",), (2, 7)),
]

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.jaxcompat import make_mesh, shard_map
from repro.data import TokenDataset, shard_batch
from repro.launch.mesh import make_mesh2d
from repro.launch.train import build
from repro.optim.compression import psum_compressed
from repro.parallel.sharding import use_sharding

out = {}
# the 2x2 train step (tests/test_sharded.py::test_train_step_sharded_...)
mesh = make_mesh2d(2, 2)
cfg = dataclasses.replace(get_config("qwen3-0.6b").smoke(),
                          num_microbatches=2)
params, opt, jitted, rules = build(cfg, mesh, **TRAIN_KW)
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"w{i}"] = np.asarray(leaf)
ds = TokenDataset(cfg.vocab_size, 32, 8)
sh = NamedSharding(mesh, rules.spec(("batch", "seq"), (8, 32)))
loss, gnorm = [], []
with use_sharding(rules):
    for _ in range(REF_STEPS):
        params, opt, m = jitted(params, opt, shard_batch(ds.next_batch(), sh))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
out["loss"], out["grad_norm"] = np.array(loss), np.array(gnorm)

# psum_compressed inside shard_map, one (1, 37) part per device
G = np.asarray(PARTS, np.float32)
for name, m in (("2x2", make_mesh2d(2, 2)), ("4x1", make_mesh2d(4, 1))):
    f = shard_map(lambda g: psum_compressed(g, "data"), mesh=m,
                  in_specs=P(("data", "model")),
                  out_specs=P(("data", "model")))
    out["psum_" + name] = np.asarray(jax.jit(f)(G))

# devices_indices_map, by mesh coordinates, x-major
maps = []
for dims, names, spec, shape in CASES:
    m = make_mesh(tuple(dims), tuple(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(m, P(*spec)).devices_indices_map(tuple(shape))
    rows = {}
    for d, sl in idx.items():
        c = tuple(int(x) for x in np.argwhere(m.devices == d)[0])
        rows[c] = [list(s.indices(n)[:2]) for s, n in zip(sl, shape)]
    maps.append([rows[c] for c in sorted(rows)])
out["maps"] = np.array(json.dumps(maps))
np.savez(sys.argv[1], **out)
"""


def _parts():
    """Four seeded (1, 37) float32 parts, scales 1e-2 to 1e1 apart."""
    rng = np.random.default_rng(7)
    g = rng.normal(size=(4, 37)) * (10.0 ** np.arange(-2, 2))[:, None]
    return g.astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's multi-device results, from one 8-device process."""
    path = str(tmp_path_factory.mktemp("parallel") / "ref.npz")
    code = (f"TRAIN_KW = {TRAIN_KW!r}\nREF_STEPS = {REF_STEPS}\n"
            f"PARTS = {_parts().tolist()!r}\nCASES = {PLACE_CASES!r}\n"
            + REF_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# the N-D mesh and its reductions
# ---------------------------------------------------------------------------

def test_mesh_is_n_d_and_x_major():
    """``make_mesh2d(1, 2, pod=2)`` builds; coordinates are x-major
    (``np.unravel_index``, as ``jax.make_mesh`` lays devices out); the
    production meshes have the reference's shapes and names."""
    m = make_mesh2d(1, 2, pod=2, device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 1, "model": 2} and m.size == 4
    for b in range(m.size):
        assert m.coords(b) == tuple(np.unravel_index(b, (2, 1, 2)))
        assert m.brick(*m.coords(b)) == b
    assert make_mesh((3,), ("data",), device="cpu").coords(2) == (2,)
    assert make_production_mesh(device="cpu").shape == {"data": 16,
                                                        "model": 16}
    assert make_production_mesh(multi_pod=True, device="cpu").dims \
        == (2, 16, 16)
    with pytest.raises(ValueError, match="1 to 3 named axes"):
        make_mesh((1, 1, 1, 1), ("a", "b", "c", "d"), device="cpu")
    with pytest.raises(ValueError, match="repeat"):
        make_mesh((1, 2), ("data", "data"), device="cpu")


def test_brick_path_refuses_other_than_2d():
    """``NamedSharding`` and ``BrickArray`` keep to 2-D meshes."""
    m3 = make_mesh2d(1, 2, pod=2, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        NamedSharding(m3)
    sh = NamedSharding(make_mesh2d(2, 2, device="cpu"))
    bricks = sh.shard(torch.zeros(4, 4, 2)).bricks
    with pytest.raises(ValueError, match="2-D"):
        BrickArray(bricks, types.SimpleNamespace(mesh=m3))


@pytest.mark.parametrize("dims,names,axes", [
    ((2, 2), ("data", "model"), ("data",)),
    ((2, 2), ("data", "model"), ("model",)),
    ((2, 2), ("data", "model"), ("data", "model")),
    ((2, 3, 2), ("pod", "data", "model"), ("pod", "data")),
    ((2, 3, 2), ("pod", "data", "model"), "model")])
def test_psum_axes_sums_over_named_axes(dims, names, axes):
    """Each position gets the sum, in position order, of the parts of the
    positions that differ from it only along ``axes`` (``lax.psum``);
    over every axis it is :func:`psum`'s value; the inputs stay as they
    were."""
    m = make_mesh(dims, names, device="cpu")
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.normal(size=5).astype(np.float32))
             for _ in range(m.size)]
    before = [p.clone() for p in parts]
    got = psum_axes(parts, m, axes)
    arr = np.stack([p.numpy() for p in parts]).reshape(*dims, 5)
    red = tuple(names.index(a) for a in ((axes,) if isinstance(axes, str)
                                        else axes))
    want = np.broadcast_to(arr.sum(axis=red, keepdims=True, dtype=np.float32),
                           arr.shape).reshape(m.size, 5)
    for b in range(m.size):
        np.testing.assert_allclose(got[b].numpy(), want[b], rtol=1e-6)
        assert torch.equal(parts[b], before[b])
    if set(red) == set(range(len(dims))):
        assert all(torch.equal(g, psum(parts, m)) for g in got)
    with pytest.raises(ValueError, match="not in the mesh"):
        psum_axes(parts, m, ("nope",))


def test_psum_axes_sums_trees_and_shares_replicated_sums():
    """Parts that are lists of tensors sum leaf by leaf; positions whose
    parts are the same objects (replicated over ``model``) share one
    sum."""
    m = make_mesh2d(2, 2, device="cpu")
    r0 = [torch.ones(3), torch.tensor(2.0)]
    r1 = [torch.full((3,), 4.0), torch.tensor(5.0)]
    out = psum_axes([r0, r0, r1, r1], m, "data")
    assert out[0] is out[1] is out[2] is out[3]
    assert torch.equal(out[0][0], torch.full((3,), 5.0))
    assert float(out[0][1]) == 7.0


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
def test_psum_compressed_equals_reference_bitwise(ref, mesh_name):
    """The reference's ``psum_compressed`` inside ``shard_map`` over
    ``data``: each part its own scale, the int8 payloads summed as int32,
    dequantized with the axis's largest scale — bitwise."""
    m = make_mesh2d(*(int(c) for c in mesh_name.split("x")), device="cpu")
    g = _parts()
    got = psum_compressed([torch.from_numpy(g[b:b + 1]) for b in range(4)],
                          m, "data")
    want = ref["psum_" + mesh_name]
    for b in range(4):
        assert got[b].dtype == torch.float32
        np.testing.assert_array_equal(got[b].numpy(), want[b:b + 1])
    # not the plain sum: the scales along the axis differ
    exact = g.reshape(*m.dims, 37).sum(axis=0)
    assert np.abs(want.reshape(*m.dims, 37)[0] - exact).max() > 0


# ---------------------------------------------------------------------------
# rules and spec tables
# ---------------------------------------------------------------------------

def _ref_mesh(dims, names):
    """A mesh the reference's rules read: ``axis_names`` and
    ``devices.shape``."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.empty(dims, dtype=object))


#: the meshes of the spec-table comparison: 2×2, pod=2 1×2, 16×16, 2×16×16
SPEC_MESHES = [((2, 2), ("data", "model")),
               ((2, 1, 2), ("pod", "data", "model")),
               ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]


def test_public_names_equal_reference():
    assert set(ref_parallel.__all__) <= set(tp.__all__)
    assert tp.default_rules() == ref_sharding.default_rules()
    assert ref_params._NAME_AXES == tp.params._NAME_AXES
    assert ref_params._CACHE_AXES == tp.params._CACHE_AXES


@pytest.mark.parametrize("dims,names", SPEC_MESHES)
def test_mesh_axes_equal_reference(dims, names):
    """``mesh_axes`` and ``spec``: axes missing from the mesh are dropped,
    a dimension that does not divide its axes replicates, as the
    reference's."""
    mine = tp.ShardingRules(make_mesh(dims, names, device="cpu"),
                            {"heads_flat": "model"})
    theirs = ref_sharding.ShardingRules(_ref_mesh(dims, names),
                                        {"heads_flat": "model"})
    logical = [None, "batch", "seq", "heads", "vocab", "cache_batch",
               "cache_seq", "experts", "layers", "heads_flat", "unknown"]
    for name in logical:
        for size in (None, 1, 2, 3, 4, 6, 16, 32, 96, 512):
            assert mine.mesh_axes(name, size) == theirs.mesh_axes(name, size)
    spec = ("batch", "seq", "heads", None)
    for shape in [(8, 32, 4, 5), (3, 7, 3, 1), (64, 1, 32, 2)]:
        got = mine.spec(spec, shape)
        assert isinstance(got, tp.PartitionSpec)
        assert got == theirs.spec(spec, shape)
    assert tp.spec_for(None, spec) == ref_sharding.spec_for(None, spec) == ()


class _Shape:
    """A leaf that carries a shape only."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _ref_specs_by_path(tree):
    """Reference spec tree → {path in the port's per-layer layout: spec},
    each stacked segment leaf's spec without its leading (layers) entry,
    once per layer."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        keys = tuple(_key(k) for k in path)
        out[keys] = tuple(spec)
    return out


def _port_layout(ref_tree, cfg):
    """The reference's stacked tree of shapes in the port's per-layer
    layout (segments: a list of layers)."""
    out = {}
    for name, value in ref_tree.items():
        if name == "segments":
            out[name] = [[jax.tree.map(lambda a: _Shape(a.shape[1:]), seg)
                          for _ in range(count)]
                         for (_, count), seg in zip(cfg.segments, value)]
        else:
            out[name] = jax.tree.map(lambda a: _Shape(a.shape), value)
    return out


def _same_specs(port_tree, ref_tree, cache=False):
    """Every leaf's spec equal to the reference's; a layer's path has its
    index in the segment at 1 in a cache (a list of segments), at 2 in the
    parameters (``["segments"][s]``)."""
    want = _ref_specs_by_path(ref_tree)
    n = 0
    for path, spec in leaves_with_path(port_tree):
        assert isinstance(spec, tp.PartitionSpec)
        at = 1 if cache else 2 if path[0] == "segments" else None
        if at is None:
            expected = want[path]
        else:
            expected = want[path[:at] + path[at + 1:]][1:]
        assert tuple(spec) == expected, (path, spec, expected)
        n += 1
    return n


_REF_SHAPES = {}


def _ref_shapes(arch):
    """(config, parameter shapes, cache shapes) of the reference at
    published width."""
    if arch not in _REF_SHAPES:
        cfg = ref_configs.get_config(arch)
        p = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), cfg))
        c = {bs: jax.eval_shape(lambda bs=bs: RM.init_cache(cfg, *bs))
             for bs in CACHE_SHAPES}
        _REF_SHAPES[arch] = (cfg, p, c)
    return _REF_SHAPES[arch]


#: (batch, s_max) of the compared caches: one that the data axes divide
#: and one that they do not
CACHE_SHAPES = [(32, 4096), (3, 1000)]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tables_equal_reference(arch):
    """``param_specs_for`` and ``cache_specs_for`` at published width on
    2×2, pod=2 1×2, 16×16 and 2×16×16 equal the reference's, leaf by
    leaf, each per-layer leaf the reference's stacked one without its
    leading entry.  The port's side walks shape carriers in its own
    layout (checked against ``init_params`` / ``init_cache`` at
    ``smoke()``) and its caches as ``cache_init`` builds them on the meta
    device."""
    rcfg, rshapes, rcaches = _ref_shapes(arch)
    cfg = port_configs.get_config(arch)
    carriers = _port_layout(rshapes, rcfg)
    cdt = getattr(torch, cfg.compute_dtype)
    meta = torch.device("meta")
    caches = {bs: [[tfm.cache_init(kind, cfg, *bs, cdt, meta)
                    for _ in range(count)] for kind, count in cfg.segments]
              for bs in CACHE_SHAPES}
    # the carriers are the port's layout: at smoke() they are the shapes
    # of its own init_params, leaf by leaf
    small = ref_configs.get_config(arch).smoke()
    mine = {p: tuple(t.shape) for p, t in leaves_with_path(
        M.init_params(cfg.smoke(), device="cpu").tree())}
    theirs = {p: c.shape for p, c in leaves_with_path(_port_layout(
        jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), small)),
        small))}
    assert mine == theirs
    for dims, names in SPEC_MESHES:
        port_rules = tp.rules_for(cfg, make_mesh(dims, names, device="cpu"))
        ref_rules = ref_params.rules_for(rcfg, _ref_mesh(dims, names))
        n = _same_specs(tp.param_specs_for(cfg, carriers, port_rules),
                        ref_params.param_specs_for(rcfg, rshapes, ref_rules))
        assert n == sum(1 for _ in leaves_with_path(carriers))
        for bs in CACHE_SHAPES:
            _same_specs(tp.cache_specs_for(cfg, caches[bs], port_rules),
                        ref_params.cache_specs_for(rcfg, rcaches[bs],
                                                   ref_rules), cache=True)


def test_param_specs_of_axis_info():
    """``param_specs`` maps a tree of ``AxisInfo`` as the reference's."""
    mesh = make_mesh2d(2, 2, device="cpu")
    rules = tp.ShardingRules(mesh)
    rrules = ref_sharding.ShardingRules(_ref_mesh((2, 2), ("data", "model")))
    infos = {"w": tp.AxisInfo(("embed", "mlp"), (8, 6)),
             "b": [tp.AxisInfo(("batch",), (3,))]}
    rinfos = {"w": ref_sharding.AxisInfo(("embed", "mlp"), (8, 6)),
              "b": [ref_sharding.AxisInfo(("batch",), (3,))]}
    got = tp.param_specs(infos, rules)
    want = ref_sharding.param_specs(rinfos, rrules)
    assert got["w"] == want["w"] and got["b"][0] == want["b"][0]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(PLACE_CASES)))
def test_placed_blocks_equal_devices_indices_map(ref, case):
    """Every position's block of ``place(x, mesh, spec)`` covers the index
    ranges of JAX's ``NamedSharding(mesh, spec).devices_indices_map``, and
    holds those values; on one device the blocks are views of one
    tensor; on positions that are not one device (here the CPU under two
    names) each block is a copy; ``device_get`` is the whole, bitwise."""
    dims, names, spec, shape = PLACE_CASES[case]
    want = json.loads(str(ref["maps"]))[case]
    x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    one = make_mesh(dims, names, device="cpu")
    n = math.prod(dims)
    two = make_mesh(dims, names, device=["cpu", "cpu:0"] * (n // 2))
    for mesh in (one, two):
        st = tp.place(x, mesh, spec)
        assert st.sharding.mesh is mesh and st.spec == spec
        amap = st.sharding.devices_indices_map(shape)
        for b, block in enumerate(st.blocks()):
            c = mesh.coords(b)
            got = [list(s.indices(d)[:2]) for s, d in zip(amap[c], shape)]
            assert got == want[b], (c, got, want[b])
            sl = tuple(slice(*r) for r in want[b])
            assert torch.equal(block, x[sl])
            assert torch.equal(st.block(c), block)
        whole = st.gather()
        assert torch.equal(whole, x)
        from repro_torch.core.mesh import device_get
        np.testing.assert_array_equal(device_get(st), x.numpy())
    st = tp.place(x, one, spec)
    assert all(b._base is st.local() or b is st.local()
               for b in st.blocks())
    with pytest.raises(ValueError, match="blocks only"):
        tp.place(x, two, spec).local()


def test_place_refuses_what_jax_refuses():
    mesh = make_mesh2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tp.place(torch.zeros(3, 4), mesh, ("data", None))
    with pytest.raises(ValueError, match="not in the mesh"):
        tp.place(torch.zeros(4), mesh, ("pod",))
    with pytest.raises(ValueError, match="twice"):
        tp.place(torch.zeros(4, 4), mesh, ("data", "data"))
    with pytest.raises(ValueError, match="rank"):
        tp.place(torch.zeros(4), mesh, ("data", None))


# ---------------------------------------------------------------------------
# pshard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pshard_changes_no_bits(arch):
    """Under ``use_sharding`` on 2×2 (and pod=2 1×2) every arch's
    ``smoke()`` forward gives the bits it gives outside a context, and the
    annotations are computed (the spec of each site)."""
    cfg = port_configs.get_config(arch).smoke()
    params = M.init_params(cfg, seed=3, device="cpu")
    shape = (4, 16) if cfg.n_codebooks == 1 else (4, 16, cfg.n_codebooks)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, shape))
    with torch.no_grad():
        want, aux = M.forward(params, tokens, cfg)
        for mesh in (make_mesh2d(2, 2, device="cpu"),
                     make_mesh2d(1, 2, pod=2, device="cpu")):
            with tp.use_sharding(tp.rules_for(cfg, mesh)):
                got, got_aux = M.forward(params, tokens, cfg)
            assert torch.equal(got, want) and torch.equal(got_aux, aux)
    assert tp.current_rules() is None


def test_pshard_of_wrong_rank_raises_as_reference():
    """An annotation of more axes than the tensor has dimensions raises
    ``IndexError`` in a context, in both packages; fewer axes pass; outside
    a context nothing is checked and the tensor comes back as it is."""
    from repro.parallel.sharding import pshard as ref_pshard
    from repro.parallel.sharding import use_sharding as ref_use

    rrules = ref_sharding.ShardingRules(ref_make_mesh((1, 1),
                                                      ("data", "model")))
    rules = tp.ShardingRules(make_mesh2d(1, 1, device="cpu"))
    x = torch.zeros(2, 3)
    with ref_use(rrules), pytest.raises(IndexError):
        ref_pshard(jnp.zeros((2, 3)), "batch", "seq", "embed")
    with tp.use_sharding(rules), pytest.raises(IndexError):
        tp.pshard(x, "batch", "seq", "embed")
    with tp.use_sharding(rules):
        assert tp.pshard(x, "batch") is x
    assert tp.pshard(x, "batch", "seq", "embed", "more") is x


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

def _qwen_mb2():
    return dataclasses.replace(port_configs.get_config("qwen3-0.6b").smoke(),
                               num_microbatches=2)


def _ref_weights(ref, cfg):
    rcfg = dataclasses.replace(ref_configs.get_config("qwen3-0.6b").smoke(),
                               num_microbatches=2)
    like = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0), rcfg))
    flat = [ref[f"w{i}"] for i in range(len(jax.tree.leaves(like)))]
    tree = jax.tree.unflatten(jax.tree.structure(like), flat)
    return lm_params_from_numpy(tree, cfg, "cpu")


def test_sharded_train_step_matches_reference(ref):
    """``tests/test_sharded.py::test_train_step_sharded_loss_decreases`` on
    the port: qwen3-0.6b ``smoke()`` with 2 microbatches, batch 8 × 32,
    ``build`` on ``make_mesh2d(2, 2)`` and ``shard_batch`` of
    ``rules.sharding(("batch", "seq"), …)``, from the reference's own
    initial weights: the first 3 losses and gradient norms within
    ``LOSS_REL`` of the reference's 4-device run; over 14 steps the loss
    falls."""
    cfg = _qwen_mb2()
    mesh = make_mesh2d(2, 2, device="cpu")
    _, _, step, rules = port_train.build(cfg, mesh, **TRAIN_KW)
    params = _ref_weights(ref, cfg)
    opt = port_steps.make_opt_state(params)
    ds = TokenDataset(cfg.vocab_size, 32, 8)
    sh = rules.sharding(("batch", "seq"), (8, 32))
    assert sh.spec == ("data", None)
    losses, gnorms = [], []
    with tp.use_sharding(rules):
        for _ in range(14):
            params, opt, m = step(params, opt, shard_batch(ds.next_batch(),
                                                           sh))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    for k in range(REF_STEPS):
        assert abs(losses[k] - ref["loss"][k]) <= LOSS_REL * ref["loss"][k]
        assert abs(gnorms[k] - ref["grad_norm"][k]) \
            <= LOSS_REL * ref["grad_norm"][k]
    assert losses[-1] < losses[0], losses


def test_placed_train_step_matches_reference(ref):
    """:func:`test_sharded_train_step_matches_reference` with the
    reference's weights placed by their specs, as the reference's
    ``build`` places them: the step splits each pass over ``model`` and
    its first 3 losses and gradient norms are within ``LOSS_REL`` of the
    same 4-device run's."""
    from repro_torch.parallel.tensor import PlacedParams, place_params

    cfg = _qwen_mb2()
    mesh = make_mesh2d(2, 2, device="cpu")
    _, _, step, rules = port_train.build(cfg, mesh, **TRAIN_KW)
    params = place_params(_ref_weights(ref, cfg), rules, cfg)
    assert isinstance(params, PlacedParams)
    opt = port_steps.make_opt_state(params)
    ds = TokenDataset(cfg.vocab_size, 32, 8)
    sh = rules.sharding(("batch", "seq"), (8, 32))
    with tp.use_sharding(rules):
        for k in range(REF_STEPS):
            params, opt, m = step(params, opt, shard_batch(ds.next_batch(),
                                                           sh))
            assert abs(float(m["loss"]) - ref["loss"][k]) \
                <= LOSS_REL * ref["loss"][k]
            assert abs(float(m["grad_norm"]) - ref["grad_norm"][k]) \
                <= LOSS_REL * ref["grad_norm"][k]


def _one_step(cfg, mesh, batch, seed=5):
    params = M.init_params(cfg, seed=seed, device="cpu")
    opt = port_steps.make_opt_state(params)
    step = port_steps.make_train_step(cfg, **TRAIN_KW)
    if mesh is None:
        _, _, m = step(params, opt, batch)
    else:
        with tp.use_sharding(tp.rules_for(cfg, mesh)):
            _, _, m = step(params, opt, batch)
    return {k: float(v) for k, v in m.items()}, \
        [p.clone() for p in params.parameters()]


def _batch(cfg, rows=8, seq=32, seed=2):
    return shard_batch(TokenDataset(cfg.vocab_size, seq, rows,
                                    seed=seed).next_batch(), "cpu")


@pytest.mark.parametrize("dims,dp", [((2, 2), 2), ((1, 2, 2), 2),
                                     ((4, 1), 4)])
def test_mesh_step_equals_one_device_step(dims, dp):
    """On 2×2, pod=2 1×2 and 4×1 (dp = 2, 2, 4) one step's loss and
    gradient norm are within ``MESH_REL`` of the one-device step's (only
    the order of the replicas' sums differs), and the updates within
    ``tests/test_torch_train.py``'s bounds of the one-device step's: every
    element within ``2·lr`` (a first AdamW step moves an element by
    ``lr·g/(|g| + ε)``, so a gradient at rounding-noise level may move it
    either way), those whose gradient is at least ``MASK_REL`` of its
    leaf's largest within ``UPDATE_REL·(lr + |Δp|)``."""
    cfg = _qwen_mb2()
    mesh = (make_mesh2d(dims[0], dims[1], pod=dims[2], device="cpu")
            if len(dims) == 3 else make_mesh2d(*dims, device="cpu"))
    assert port_steps.batch_axes(tp.rules_for(cfg, mesh), 4)[1] == dp
    batch = _batch(cfg)
    p0 = M.init_params(cfg, seed=5, device="cpu")
    grads = [M.value_and_grad(p0, {k: v[4 * i:4 * (i + 1)]
                                   for k, v in batch.items()}, cfg)[1]
             for i in range(2)]
    masks = [(a + b).abs() >= MASK_REL * (a + b).abs().max() for a, b in
             zip(leaves(grads[0]), leaves(grads[1]))]
    want, wp = _one_step(cfg, None, batch)
    got, gp = _one_step(cfg, mesh, batch)
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= MESH_REL * abs(want[k]), k
    assert got["lr"] == want["lr"]
    lr = want["lr"]
    for a, b, b0, mask in zip(gp, wp, p0.parameters(), masks):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * lr
        bound = UPDATE_REL * (lr + (b - b0).abs())
        assert bool((diff <= bound)[mask].all())


@pytest.mark.parametrize("dims,dp", [((2, 2), 2), ((1, 2, 2), 2),
                                     ((4, 1), 4)])
def test_mesh_step_is_the_one_device_step_at_dp_microbatches(dims, dp):
    """The replicas on one device share its float32 accumulators, added in
    the order microbatch, then replica: one step on ``dp`` replicas at 2
    microbatches is the one-device step at ``2·dp`` microbatches (the
    same one-row passes in the same order), bitwise."""
    cfg = _qwen_mb2()
    mesh = (make_mesh2d(dims[0], dims[1], pod=dims[2], device="cpu")
            if len(dims) == 3 else make_mesh2d(*dims, device="cpu"))
    batch = _batch(cfg)
    want, wp = _one_step(dataclasses.replace(cfg, num_microbatches=2 * dp),
                         None, batch)
    got, gp = _one_step(cfg, mesh, batch)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(gp, wp))


@pytest.mark.parametrize("dims,rows", [((1, 1), 8), ((4, 1), 6),
                                       ((1, 4), 8)])
def test_mesh_step_without_batch_sharding_is_the_one_device_step(dims,
                                                                 rows):
    """Where the batch axes span one position (1×1, 1×4) or do not divide
    a microbatch's rows (3 rows over data = 4), the step under the rules
    is the one-device step, bitwise."""
    cfg = _qwen_mb2()
    mesh = make_mesh2d(*dims, device="cpu")
    assert port_steps.batch_axes(tp.rules_for(cfg, mesh), rows // 2) is None
    batch = _batch(cfg, rows=rows)
    want, wp = _one_step(cfg, None, batch)
    got, gp = _one_step(cfg, mesh, batch)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(gp, wp))


def test_mesh_step_at_one_microbatch_keeps_the_param_dtype():
    """At ``num_microbatches = 1`` the reduced gradient is cast back to
    the parameters' dtype, as the one-device step's is: in bfloat16 the
    2×2 step's loss is within 1e-2 of the one-device step's."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    batch = _batch(cfg, rows=4, seq=16)
    want, wp = _one_step(cfg, None, batch)
    got, gp = _one_step(cfg, make_mesh2d(2, 2, device="cpu"), batch)
    assert abs(got["loss"] - want["loss"]) <= 1e-2 * want["loss"]
    assert all(a.dtype == torch.bfloat16 for a in gp)


def _aux(params, tokens, cfg):
    with torch.no_grad():
        return float(M.forward(params, tokens, cfg)[1])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_moe_aux_term_on_a_mesh(arch):
    """MoE's load-balance term ``E·Σ pe·fe`` over a pass's tokens is not
    linear in the rows: on 2×2 the step's loss is the one-device loss plus
    0.01 × (the mean of the replicas' terms − the whole microbatch's),
    each term from a forward over those rows; the cross-entropy part is
    unchanged (the dispatch is per sequence)."""
    cfg = port_configs.get_config(arch).smoke(num_microbatches=2)
    batch = _batch(cfg, rows=8, seq=16)
    params = M.init_params(cfg, seed=5, device="cpu")
    toks = batch["tokens"]
    shift = 0.0
    for i in range(2):
        rows = toks[4 * i:4 * (i + 1)]
        whole = _aux(params, rows, cfg)
        halves = [_aux(params, rows[2 * r:2 * (r + 1)], cfg) for r in (0, 1)]
        shift += 0.01 * (sum(halves) / 2 - whole) / 2
    want, _ = _one_step(cfg, None, batch)
    got, _ = _one_step(cfg, make_mesh2d(2, 2, device="cpu"), batch)
    assert abs(got["loss"] - (want["loss"] + shift)) \
        <= MESH_REL * want["loss"]
    assert shift != 0.0


def test_build_returns_the_reference_four_values():
    """(params, opt, step, rules); on 2×2 the parameters are placed by
    their specs, as the reference's ``build`` places them."""
    cfg = port_configs.get_config("qwen3-0.6b").smoke()
    mesh = make_mesh2d(2, 2, device="cpu")
    params, opt, step, rules = port_train.build(cfg, mesh)
    assert rules.mesh is mesh and callable(step)
    assert all(st.local().device.type == "cpu" for st in leaves(params))
    assert int(opt.step) == 0
    specs = tp.param_specs_for(cfg, params, rules)
    assert specs["embed"] == ("model", None)
    assert params["embed"].spec == specs["embed"]


def test_train_runs_on_a_mesh(tmp_path):
    """``train(mesh=2×2)``: 4 steps at smoke(), batch 8, 2 microbatches,
    the checkpoints unchanged; the losses equal a second run's."""
    cfg = _qwen_mb2()
    out = []
    for run in ("a", "b"):
        _, _, step, hist = port_train.train(
            cfg, steps=4, batch=8, seq=16, ckpt_dir=str(tmp_path / run),
            ckpt_every=2, device="cpu",
            mesh=make_mesh2d(2, 2, device="cpu"), **TRAIN_KW)
        assert step == 4
        out.append([float(h["loss"]) for h in hist])
    assert out[0] == out[1] and all(math.isfinite(x) for x in out[0])


def test_train_module_runs_on_the_production_mesh(tmp_path):
    """``python -m repro_torch.launch.train --smoke --steps 2
    --production-mesh --device cpu`` runs (16×16: the batch axes do not
    divide 8 rows, so one replica; the vocab of 256 splits 16 ways, so the
    parameters are placed and each pass splits over ``model``)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2", "--production-mesh", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("trained 2 steps")


def test_mesh_modules_import_no_jax():
    """No module of ``repro_torch/{parallel,runtime}`` (the model axis's
    split by hand, ``parallel/tensor.py``, included), nor ``core/mesh.py``
    or ``launch/mesh.py``, imports ``jax`` or ``repro``."""
    import ast
    import pathlib

    root = pathlib.Path(ROOT) / "src" / "repro_torch"
    files = [root / "core" / "mesh.py", root / "launch" / "mesh.py"] + [
        f for d in ("parallel", "runtime") for f in sorted((root / d).glob(
            "*.py"))]
    assert root / "parallel" / "params.py" in files
    assert root / "parallel" / "tensor.py" in files
    assert root / "runtime" / "elastic.py" in files
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


@pytest.mark.parametrize("name", ["repro_torch.parallel.sharding",
                                  "repro_torch.parallel.tensor",
                                  "repro_torch.core.mesh"])
def test_module_doctests_run(name):
    import doctest
    import importlib

    res = doctest.testmod(importlib.import_module(name))
    assert res.failed == 0 and res.attempted > 0
