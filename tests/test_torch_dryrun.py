"""The port's dry-run analysis (``repro_torch.launch.{specs,roofline,
heat_cell,dryrun}``) against the JAX reference on the CPU.

The reference's mesh side runs once, in one subprocess with 8 host devices
(``REF_SCRIPT``): ``_zero_extend`` on 2×2 and 1×2×2, ``cell_specs``' input
shardings of every arch at ``smoke()`` for every shape on 2×2, the
``memory_analysis`` of qwen3-0.6b ``smoke()`` cells (``run_cell``,
``calibrate=False``) and the heat variants' ``n_collectives`` on 2×2 at a
16×16×8 grid.  ``count_params``, ``model_flops`` and ``collective_latency``
run in process.  Bounds:

* specs, the three memory sizes, parameter counts, model FLOPs and the
  latency floor: equal;
* the extrapolated FLOPs and matmul bytes against a direct count of the
  same cell: equal (a layer's counts depend on its kind alone, and the
  counted work is a polynomial of degree ≤ 2 in the sequence where the
  attention's chunks are those of the cell);
* the heat variants' collective schedule: the port's count equals the
  reference's ``n_collectives`` for all nine variants (XLA neither merges
  nor splits them at this size).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.configs as ref_configs
from repro.launch import roofline as ref_roofline
import repro_torch.configs as port_configs
from repro_torch.configs import SHAPES, ShapeCfg
from repro_torch.core import mesh as mesh_mod
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, heat_cell, roofline, specs
from repro_torch.launch.mesh import make_mesh2d, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.tree import leaves, leaves_with_path
from repro_torch.parallel.sharding import PartitionSpec as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ref_configs.ARCHS

#: (spec, shape) of the ``_zero_extend`` comparison
ZERO_CASES = [
    ((None, "model"), (8, 4)),
    (("data", None), (8, 4)),
    ((None, "model"), (7, 4)),
    ((None, None), (4, 16)),
    ((), (6, 12, 2)),
    (("model",), (4, 8, 3)),
    ((("pod", "data"), None), (4, 4)),
    ((None, None, "model"), (16, 3, 8)),
]
ZERO_MESHES = {"2x2": ((2, 2), {}), "1x2x2": ((1, 2), {"pod": 2})}

#: (mesh, shape) of the memory comparison at qwen3-0.6b ``smoke()``
MEM_CASES = [("2x2", "train_4k"), ("2x2", "decode_32k"),
             ("1x2x2", "decode_32k"), ("2x2", "prefill_32k")]

REF_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, cells_for, get_config
from repro.configs.heat3d import HeatConfig
from repro.launch.dryrun import run_cell
from repro.launch.heat_cell import run_heat_cells
from repro.launch.mesh import make_mesh2d
from repro.launch.specs import _zero_extend, cell_specs

def spec_json(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return getattr(k, a)
    raise TypeError(k)

def flat_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))[0]
    return [[[key(k) for k in path],
             spec_json(s.spec if isinstance(s, NamedSharding) else s)]
            for path, s in flat]

out = {"zero": {}, "specs": {}, "memory": {}, "heat": {}}
meshes = {"2x2": make_mesh2d(2, 2), "1x2x2": make_mesh2d(1, 2, pod=2)}
for name, mesh in meshes.items():
    out["zero"][name] = [
        spec_json(_zero_extend(P(*[tuple(e) if isinstance(e, list) else e
                                   for e in spec]), tuple(shape), mesh))
        for spec, shape in ZERO_CASES]
mesh = meshes["2x2"]
for arch in ARCHS:
    cfg = get_config(arch).smoke()
    for shape in cells_for(arch):
        c = cell_specs(arch, shape, mesh, cfg=cfg)
        out["specs"][arch + "/" + shape] = {
            "in": flat_specs(c["in_shardings"]),
            "donate": list(c["donate_argnums"])}
for name, shape in MEM_CASES:
    rec = run_cell("qwen3-0.6b", shape, mesh=meshes[name], verbose=False,
                   calibrate=False, cfg=get_config("qwen3-0.6b").smoke())
    out["memory"][name + "/" + shape] = {k: rec[k] for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes")}
for v, rec in run_heat_cells(mesh, HeatConfig(nx=16, ny=16, nz=8)).items():
    out["heat"][v] = rec["n_collectives"]
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref():
    code = (f"ZERO_CASES = {ZERO_CASES!r}\nMEM_CASES = {MEM_CASES!r}\n"
            + REF_SCRIPT)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def _mesh(name):
    dims, kw = ZERO_MESHES[name]
    return make_mesh2d(*dims, device="meta", **kw)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


class _HostTensors(TorchDispatchMode):
    """Records every op result that is not on the meta device."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.seen.append((str(func), t.device))
        return out


# ---------------------------------------------------------------------------
# the meta device
# ---------------------------------------------------------------------------

def test_resolve_device_accepts_meta_and_no_other():
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_params_has_the_drawn_shapes(arch):
    """``init_params(device="meta")`` draws nothing and gives every leaf
    the shape and dtype of the drawn parameters (at ``smoke()``)."""
    cfg = port_configs.get_config(arch).smoke()
    with _HostTensors() as guard:
        meta = M.init_params(cfg, device="meta")
    assert guard.seen == []
    drawn = M.init_params(cfg, device="cpu")
    got = [(p, tuple(t.shape), t.dtype, t.device.type)
           for p, t in leaves_with_path(meta.tree())]
    want = [(p, tuple(t.shape), t.dtype, "meta")
            for p, t in leaves_with_path(drawn.tree())]
    assert got == want


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_zero_extended_optimizer_specs():
    """The reference's four ZeRO cases on 2×2."""
    mesh = make_mesh2d(2, 2, device="meta")
    assert specs._zero_extend(P(None, "model"), (8, 4), mesh) \
        == P("data", "model")
    assert specs._zero_extend(P("data", None), (8, 4), mesh) \
        == P("data", None)
    assert specs._zero_extend(P(None, "model"), (7, 4), mesh) \
        == P(None, "model")
    assert specs._zero_extend(P(None, None), (4, 16), mesh) \
        == P(None, "data")


@pytest.mark.parametrize("case", range(len(ZERO_CASES)))
def test_zero_extend_equals_reference(ref, case):
    spec, shape = ZERO_CASES[case]
    for name in ZERO_MESHES:
        got = specs._zero_extend(P(*spec), shape, _mesh(name))
        assert isinstance(got, P)
        assert tuple(got) == _spec(ref["zero"][name][case]), (name, got)


def _ref_path(path, arg: int, kind: str):
    """A port leaf path of argument ``arg`` in the reference's layout, and
    whether it is a per-layer leaf of a stacked segment."""
    path = (arg,) + tuple(path)
    if kind == "decode" and arg == 1:        # cache: (seg, layer, field…)
        return path[:2] + path[3:], True
    if "segments" in path:
        i = path.index("segments")
        return path[:i + 2] + path[i + 3:], True
    return path, False


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_equal_reference(ref, arch):
    """Every argument leaf's spec of every cell at ``smoke()`` on 2×2
    equals the reference's in-sharding (a per-layer leaf: the stacked
    leaf's without its leading entry), and the donated arguments too."""
    cfg = port_configs.get_config(arch).smoke()
    mesh = _mesh("2x2")
    for shape in port_configs.cells_for(arch):
        theirs = ref["specs"][f"{arch}/{shape}"]
        want = {tuple(p): _spec(s) for p, s in theirs["in"]}
        c = specs.cell_specs(arch, shape, mesh, cfg=cfg)
        assert list(c["donate_argnums"]) == theirs["donate"]
        kind = c["shape"].kind
        seen = set()
        for arg, tree in enumerate(c["in_specs"]):
            for path, spec in leaves_with_path(tree):
                assert isinstance(spec, P)
                rpath, stacked = _ref_path(path, arg, kind)
                expected = want[rpath][1:] if stacked else want[rpath]
                assert tuple(spec) == expected, (shape, rpath, spec)
                seen.add(rpath)
        assert seen == set(want), (shape, set(want) ^ seen)
        # the output specs are the argument specs where the step returns
        # an argument, the step's own for what it adds
        if kind == "train":
            assert c["out_specs"][:2] == c["in_specs"][:2]
        if kind == "decode":
            assert c["out_specs"][1] is c["in_specs"][1]


@pytest.mark.parametrize("case", MEM_CASES, ids="/".join)
def test_memory_fields_equal_reference(ref, case):
    """Argument, output and donated bytes of one position equal the
    reference's ``memory_analysis`` exactly."""
    name, shape = case
    mesh = _mesh(name)
    c = specs.cell_specs("qwen3-0.6b", shape, mesh,
                         cfg=port_configs.get_config("qwen3-0.6b").smoke())
    assert specs.memory_fields(c, mesh) == ref["memory"][f"{name}/{shape}"]


def test_block_bytes_is_the_devices_indices_map_block():
    """Every position holds a block of the same bytes; the sum is the
    block that ``devices_indices_map`` gives each position."""
    mesh = _mesh("1x2x2")
    tree = {"a": torch.empty((8, 6), device="meta"),
            "b": [torch.empty((4,), dtype=torch.int32, device="meta")]}
    sp = {"a": P(("pod", "data"), "model"), "b": [P("model")]}
    for b in range(mesh.size):
        assert specs.block_bytes(tree, sp, mesh, mesh.coords(b)) \
            == 4 * 4 * 3 + 4 * 2
    from repro_torch.parallel.sharding import NamedSharding
    blocks = NamedSharding(mesh, sp["a"]).devices_indices_map((8, 6))
    assert blocks[mesh.coords(3)] == (slice(4, 8), slice(3, 6))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

_REF_COUNTS = {}


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_equal_reference(arch):
    cfg = port_configs.get_config(arch)
    rcfg = ref_configs.get_config(arch)
    got = roofline.count_params(cfg)
    want = ref_roofline.count_params(rcfg)
    assert got == want
    for shape in port_configs.cells_for(arch):
        assert roofline.model_flops(cfg, SHAPES[shape], got["total"],
                                    got["active"]) \
            == ref_roofline.model_flops(rcfg, SHAPES[shape], want["total"],
                                        want["active"])


@settings(max_examples=60, deadline=None)
@given(perm=st.integers(0, 64), red=st.integers(0, 64),
       gather=st.integers(0, 8), scatter=st.integers(0, 8),
       a2a=st.integers(0, 8), mx=st.integers(1, 64), my=st.integers(1, 64),
       hop=st.floats(1e-9, 1e-3))
def test_collective_latency_equals_reference(perm, red, gather, scatter, a2a,
                                             mx, my, hop):
    coll = {"collective-permute_n": perm, "all-reduce_n": red,
            "all-gather_n": gather, "reduce-scatter_n": scatter,
            "all-to-all_n": a2a}
    assert roofline.collective_latency(coll, mx, my, hop) \
        == ref_roofline.collective_latency(coll, mx, my, hop)
    assert roofline.collective_latency(coll, mx, my) \
        == ref_roofline.collective_latency(coll, mx, my)


def test_analyze_terms():
    rec = roofline.analyze(flops_per_chip=2 * roofline.PEAK_BF16,
                           hbm_bytes_per_chip=roofline.HBM_BW,
                           collective_bytes_per_chip=3 * roofline.ICI_BW)
    assert (rec["t_compute"], rec["t_memory"], rec["t_collective"]) \
        == (2.0, 1.0, 3.0)
    assert rec["t_total"] == 5.0 and rec["bound"] == "collective"
    assert roofline.PEAK_BF16 == 989e12 and roofline.ICI_BW == 450e9


def _deep(arch):
    """``smoke()`` cut to its first three segments, each two layers deep
    (three where there is one segment; zamba2: mamba 2, shared 2, mamba 2),
    with the published scan chunks (64: fewer chunks to count)."""
    cfg = port_configs.get_config(arch).smoke()
    depth = 3 if len(cfg.segments) == 1 else 2
    segs = tuple((k, depth) for k, _ in cfg.segments[:3])
    ssm = cfg.ssm and dataclasses.replace(cfg.ssm, chunk=64)
    return dataclasses.replace(cfg, segments=segs, ssm=ssm, rwkv_chunk=64,
                               n_layers=sum(c for _, c in segs))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_extrapolated_counts_equal_direct_count(arch):
    """Layer extrapolation (every cell kind) and sequence extrapolation
    (prefill above ``seq_direct``) give the direct count exactly."""
    cfg = _deep(arch)
    cells = [ShapeCfg("t", 512, 4, "train"), ShapeCfg("p", 4096, 2,
                                                      "prefill"),
             ShapeCfg("d", 2048, 3, "decode")]
    cfg = dataclasses.replace(cfg, num_microbatches=2)
    for shape in cells:
        direct = roofline.count_cell(cfg, shape, seq_direct=shape.seq_len)
        got = roofline.layer_extrapolated(cfg, shape, seq_direct=2048)
        assert got == direct, (shape, got, direct)
        assert direct["flops"] > 0 and direct["matmul_bytes"] > 0


def test_train_collective_is_the_ring_gradient_reduction():
    """The train cell's collective bytes are ``2(n−1)/n`` of the float32
    parameter blocks a position holds, over the batch axes; prefill and
    decode make none."""
    mesh = make_production_mesh(device="meta")
    c = specs.cell_specs("qwen3-0.6b", "train_4k", mesh)
    coll = roofline.gradient_reduction(c, mesh)
    n = roofline.count_params(c["cfg"])["total"]
    # qwen3's parameters divide over model (16): 4 bytes / 16 a parameter
    held = specs.block_bytes(
        {k: torch.empty(t.shape, dtype=torch.float32, device="meta")
         for k, t in enumerate(leaves(c["args"][0].tree()))},
        dict(enumerate(leaves(c["in_specs"][0]))), mesh)
    assert held < 4 * n
    assert coll["all-reduce"] == 2 * 15 * held // 16
    assert coll["all-reduce_n"] == coll["count"] == 1
    for shape in ("prefill_32k", "decode_32k"):
        c = specs.cell_specs("qwen3-0.6b", shape, mesh)
        assert roofline.gradient_reduction(c, mesh)["count"] == 0


# ---------------------------------------------------------------------------
# heat cells
# ---------------------------------------------------------------------------

#: the port's one-step schedule: (plane shifts, reductions)
SCHEDULE = {"explicit_baseline": (4, 0), "explicit_overlap": (4, 0),
            "explicit_wide_halo4": (4, 0), "explicit_kernel": (4, 0),
            "explicit_kernel_planes": (4, 0), "implicit_cg": (4, 2),
            "implicit_cg_kernel": (4, 2), "implicit_pipecg": (4, 1),
            "implicit_chebyshev": (4, 0)}


def test_heat_cells_names_and_schedules(ref):
    mesh = make_production_mesh(device="meta")
    recs = heat_cell.run_heat_cells(mesh)
    assert list(recs) == list(SCHEDULE) and set(recs) == set(ref["heat"])
    for name, rec in recs.items():
        perm, red = SCHEDULE[name]
        assert rec["collective_schedule"] == {"collective-permute": perm,
                                              "all-reduce": red}
        assert rec["n_collectives"] == perm + red == ref["heat"][name]
        every = 4 if name == "explicit_wide_halo4" else 1
        assert rec["t_latency"] == pytest.approx(
            (perm + 64 * red) * 1e-6 / every)
        assert rec["brick"] == (128, 128, 512)
        assert rec["t_total"] > 0 and rec["bound"] in (
            "compute", "memory", "collective")
    base = recs["explicit_baseline"]
    assert base["state_bytes_per_device"] == 128 * 128 * 512 * 4
    assert base["t_memory"] == pytest.approx(2 * 128 * 128 * 512 * 4
                                             / 3.35e12)
    assert recs["implicit_pipecg"]["state_bytes_per_device"] \
        == (6 * 128 * 128 * 512 + 2) * 4
    assert recs["explicit_wide_halo4"]["collective_bytes_per_chip"] \
        == base["collective_bytes_per_chip"]
    assert heat_cell.run_heat_cells(
        mesh, variants=["implicit_cg"]).keys() == {"implicit_cg"}


def test_collectives_count_psums_and_shifts():
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh_mod.reset_collectives()
    mesh_mod.psum([torch.ones(())] * 4, mesh)
    mesh_mod.psum_axes([torch.ones(())] * 4, mesh, "data")
    from repro_torch.core.halo import halo_pad
    halo_pad([torch.zeros(2, 2, 3)] * 4, 1, mesh)
    assert mesh_mod.collectives == {"collective-permute": 4,
                                    "all-reduce": 2}
    mesh_mod.reset_collectives()
    assert set(mesh_mod.collectives.values()) == {0}


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

def test_small_mesh_dryrun_and_multipod():
    """A reduced-scale dry-run (2×2 and 1×2×2 with a pod axis)."""
    for mesh in (make_mesh2d(2, 2, device="meta"),
                 make_mesh2d(1, 2, pod=2, device="meta")):
        rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", mesh=mesh,
                              verbose=False, calibrate=False)
        assert rec["t_total"] > 0 and rec["bound"] in (
            "compute", "memory", "collective")
        assert rec["chips"] == 4 and rec["argument_size_in_bytes"] > 0
        assert "total_bytes_per_device" not in rec
        assert "temp_size_in_bytes" not in rec


def test_all_walk_allocates_nothing(tmp_path):
    """Every cell of ``--all`` at published width on 16×16: specs, the
    memory sizes and the collectives of every cell, and every decode cell
    counted whole (its ``model`` collectives, counted from the split, above
    0), with no tensor off the meta device."""
    mesh = make_production_mesh(device="meta")
    n = 0
    with _HostTensors() as guard:
        for arch in ARCHS:
            for shape in port_configs.cells_for(arch):
                c = specs.cell_specs(arch, shape, mesh)
                mem = specs.memory_fields(c, mesh)
                assert mem["argument_size_in_bytes"] > 0
                roofline.gradient_reduction(c, mesh)
                if c["shape"].kind == "decode":
                    rec = dryrun.run_cell(arch, shape, mesh=mesh,
                                          verbose=False)
                    assert rec["t_total"] > 0
                    assert rec["collective_bytes_per_chip"] > 0
                n += 1
    assert guard.seen == [] and n == 33


def test_main_writes_skips_and_fails(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["mesh"] == str({"data": 16, "model": 16})
    assert rec["chips"] == 256 and rec["useful_flop_ratio"] > 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                     "--out", str(out), "--skip-existing"])
    assert e.value.code == 0 and "skip" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "nope"])
    assert e.value.code == 1


def test_dryrun_modules_import_no_jax():
    """The four modules import neither ``jax`` nor ``repro``, directly
    or through what they import."""
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.heat_cell\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
