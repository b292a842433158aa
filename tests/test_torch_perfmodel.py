"""The port's cost model (``repro_torch.core.perfmodel``) and the planner
decisions it steers, on the CPU, against the JAX reference's.

The port's counterpart of ``tests/test_overlap.py``'s cost-model cases and
``tests/test_property.py``'s equation properties.  Tolerances, and why:

* the paper's equations, the brick costs, ``roofline_time`` with explicit
  constants, ``tile_cells``, ``_split_cells``, ``predict_step_us`` and
  ``_fit_line`` equal the reference's bit for bit, under hypothesis: both
  are the same plain float arithmetic in the same order;
* ``roofline_time``'s defaults are the H100 data sheet's constants (the
  port states no TPU number);
* manifests round-trip exactly (JSON keeps a float's 17 digits), within
  the port and across the two packages;
* the planner's ``time_tile`` and ``Segment.split`` equal the reference's
  for the same ``MeasuredCost`` values, on one device, on a 2×2 mesh and
  with members (the reference's mesh plans run in a subprocess with four
  fake CPU devices); model-driven ``auto_tile`` picks the reference's k;
* a calibration on the CPU tags ``"cpu"`` and steers the next CPU plan,
  never one tagged for a card, and the calibrated ``make`` equals the
  uncalibrated one bitwise (a tile factor or a split never changes the
  bits: ``test_torch_sweep.py``, ``test_torch_overlap.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.compiler.ir as ref_ir
import repro.core as ref_core
import repro.core.perfmodel as ref_pm
import repro.engine as ref_engine
import repro_torch.core as port_core
import repro_torch.core.perfmodel as pm
import repro_torch.engine as port_engine
from repro_torch.compiler import LoweringError, auto_tile, lower_group
from repro_torch.core.mesh import make_mesh
from repro_torch.core.program import _group_ops
from repro_torch.engine import RunOptions
from test_torch_program import build_heat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(deadline=None, max_examples=40)
#: a card's tag, which no CPU plan looks up
CARD_TAG = "cuda:NVIDIA H100 80GB HBM3"
FLOATS = st.floats(0.0, 1e4, allow_nan=False, allow_infinity=False)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' process-wide models empty around every test, so no
    other test file's plan changes."""
    for m in (pm, ref_pm):
        m.cost_model.clear()
    port_engine.reset_stats()
    ref_engine.reset_stats()
    yield
    for m in (pm, ref_pm):
        m.cost_model.clear()


def _t0(shape=(12, 12, 4)):
    rng = np.random.default_rng(7)
    return rng.uniform(250.0, 500.0, size=shape).astype(np.float32)


def _program(m, T0, steps):
    wse, _ = build_heat(m, T0, steps)
    wse.__exit__()
    return wse.program


def _group(m, program):
    lower = lower_group if m is port_core else ref_ir.lower_group
    _, ops = next(g for g in _group_ops(program) if g[0] is not None)
    return lower(ops)


def _cost(mod, **vals):
    return mod.MeasuredCost(signature="x", device="cpu", **vals)


# -- the paper's equations and the roofline ----------------------------------

@given(st.floats(1.0, 1e9), st.integers(1, 2000), st.integers(1, 2000),
       st.floats(1e6, 1e10), st.floats(1e9, 1e13))
@settings(**SMALL)
def test_paper_equations_equal_reference(W, X, Y, fc, bw):
    """Eqs. 6, 12, 16 and 17 bit for bit, at the default clock and any."""
    for name, args in (("wse_explicit_rate", (W,)),
                       ("wse_explicit_rate", (W, fc)),
                       ("wse_implicit_rate", (W, X, Y)),
                       ("wse_implicit_rate", (W, X, Y, fc)),
                       ("wse_dot_time", (W, X, Y)),
                       ("wse_dot_time", (W, X, Y, fc)),
                       ("gpu_max_rate", (W, bw))):
        assert getattr(pm, name)(*args) == getattr(ref_pm, name)(*args), name
    assert pm.WSE_CLOCK_HZ == ref_pm.WSE_CLOCK_HZ


@pytest.mark.parametrize("name,W", [
    ("openfoam_explicit_rate", 4096), ("openfoam_explicit_rate", 15625),
    ("openfoam_implicit_rate", 13824), ("openfoam_implicit_rate", 21952),
    ("openfoam_implicit_rate", 27000)])
@given(n_cells=st.floats(0.0, 1e9))
@settings(**SMALL)
def test_openfoam_fits_equal_reference(name, W, n_cells):
    """Eqs. 4–5 and 13–15 at each benchmarked workload, bit for bit."""
    assert getattr(pm, name)(W, n_cells) == getattr(ref_pm, name)(W, n_cells)


@pytest.mark.parametrize("name", ["openfoam_explicit_rate",
                                  "openfoam_implicit_rate"])
def test_openfoam_fits_refuse_unknown_workloads(name):
    for mod in (pm, ref_pm):
        with pytest.raises(ValueError, match="no fit"):
            getattr(mod, name)(1000, 1e6)


@given(st.integers(1, 4096), st.integers(1, 4096), st.integers(1, 1024),
       st.integers(1, 4), st.integers(1, 8), st.integers(1, 8),
       st.sampled_from([4, 8]), st.booleans(), st.integers(1, 4))
@settings(**SMALL)
def test_brick_costs_equal_reference(bx, by, nz, halo, mx, my, nbytes, fused,
                                     hops):
    """``ftcs_brick_cost`` / ``cg_brick_cost`` field for field."""
    pairs = ((pm.ftcs_brick_cost(bx, by, nz, nbytes, halo),
              ref_pm.ftcs_brick_cost(bx, by, nz, nbytes, halo)),
             (pm.cg_brick_cost(bx, by, nz, mx, my, nbytes, fused),
              ref_pm.cg_brick_cost(bx, by, nz, mx, my, nbytes, fused)))
    for got, want in pairs:
        assert (got.flops, got.hbm_bytes, got.collective_bytes, got.hops) \
            == (want.flops, want.hbm_bytes, want.collective_bytes, want.hops)
    assert pm.StepCost(1.0, 2.0, 3.0).hops == ref_pm.StepCost(1.0, 2.0, 3.0).hops


@given(st.floats(1e3, 1e15), st.floats(1e3, 1e12), st.floats(0.0, 1e9),
       st.integers(0, 16), st.floats(1e12, 1e15), st.floats(1e11, 1e13),
       st.floats(1e9, 1e12), st.floats(1e-7, 1e-5), st.booleans())
@settings(**SMALL)
def test_roofline_time_equals_reference(flops, nbytes, coll, hops, peak, bw,
                                        link, lat, overlap):
    """The Eq. 7 structure with explicit constants, key for key."""
    kw = dict(flops_peak=peak, hbm_bw=bw, ici_bw=link, hop_lat=lat,
              overlap_collective=overlap)
    got = pm.roofline_time(pm.StepCost(flops, nbytes, coll, hops), **kw)
    want = ref_pm.roofline_time(ref_pm.StepCost(flops, nbytes, coll, hops),
                                **kw)
    assert got == want
    assert got["t_total"] >= max(got["t_compute"], got["t_memory"])


def test_roofline_defaults_are_the_h100s():
    """The defaults are the H100 SXM data sheet's: 67 TFLOP/s float32,
    3.35 TB/s of HBM3, NVLink at 450 GB/s per direction; the module
    defines no TPU constant; the bounds' peaks come from these."""
    assert (pm.H100_SXM_FP32_FLOPS, pm.H100_SXM_FP64_FLOPS,
            pm.H100_SXM_HBM_BW, pm.H100_NVLINK_BW) == (67e12, 34e12, 3.35e12,
                                                       450e9)
    assert pm.HBM_BYTES_PER_S == 3.35e12
    assert pm.PEAK_FLOPS == {"float32": 67e12, "float64": 34e12}
    c = pm.ftcs_brick_cost(512, 512, 128)
    assert pm.roofline_time(c) == pm.roofline_time(
        c, flops_peak=67e12, hbm_bw=3.35e12, ici_bw=450e9,
        hop_lat=pm.H100_NVLINK_LAT)
    assert pm.roofline_time(c)["bound"] == "memory"
    assert not [n for n in dir(pm) if "TPU" in n.upper()]


# -- the schedule model --------------------------------------------------------

@given(st.integers(1, 600), st.integers(1, 600), st.integers(1, 256),
       st.integers(0, 3), st.integers(1, 16))
@settings(**SMALL)
def test_tile_and_split_cells_equal_reference(bx, by, nz, h, k):
    assert pm.tile_cells((bx, by), nz, h, k) == ref_pm.tile_cells(
        (bx, by), nz, h, k)
    assert pm._split_cells((bx, by), nz, h, k) == ref_pm._split_cells(
        (bx, by), nz, h, k)


@given(FLOATS, FLOATS, FLOATS, FLOATS, st.integers(1, 600),
       st.integers(1, 600), st.integers(1, 256), st.integers(0, 3),
       st.integers(1, 16))
@settings(**SMALL)
def test_predict_step_us_equals_reference(cell, launch, exch, bnd, bx, by, nz,
                                          h, k):
    """Fused and split schedules, bit for bit (an illegal split ``inf``)."""
    vals = dict(cell_ns=cell, launch_us=launch, exchange_us=exch,
                boundary_us=bnd)
    for split in (False, True):
        assert pm.predict_step_us(_cost(pm, **vals), (bx, by), nz, h, k,
                                  split) \
            == ref_pm.predict_step_us(_cost(ref_pm, **vals), (bx, by), nz, h,
                                      k, split)


@given(st.lists(st.tuples(st.floats(0.0, 1e8), st.floats(-1e4, 1e6)),
                min_size=1, max_size=6))
@settings(**SMALL)
def test_fit_line_equals_reference(points):
    xs, ys = [p[0] for p in points], [p[1] for p in points]
    assert pm._fit_line(xs, ys) == ref_pm._fit_line(xs, ys)
    assert pm._fit_line(xs, ys)[0] >= 0.0


# -- the manifest and the signature ------------------------------------------

def _entry(mod, program, **kw):
    group = _group(port_core if mod is pm else ref_core, program)
    vals = dict(cell_ns=0.001, launch_us=1.0, exchange_us=1.0, boundary_us=1.0)
    vals.update(kw)
    if mod is pm:
        return pm.MeasuredCost(signature=pm.body_signature(
            group, 4, np.float32, "cpu"), device="cpu", **vals)
    return ref_pm.MeasuredCost(signature=ref_pm.body_signature(
        group, 4, np.float32), device=ref_pm.current_device(), **vals)


def test_manifest_roundtrip_within_port(tmp_path):
    program = _program(port_core, _t0(), 4)
    model = pm.CostModel()
    entry = _entry(pm, program, cell_ns=0.1 + 0.2, launch_us=3.0 ** 0.5)
    model.put(entry)
    path = str(tmp_path / "cost.json")
    model.save_manifest(path)
    fresh = pm.CostModel()
    assert fresh.load_manifest(path) == 1
    assert fresh.entries[entry.signature] == entry
    assert json.load(open(path))["schema"] == pm.MANIFEST_SCHEMA == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifest_loads_across_packages(tmp_path, writer):
    """A manifest either package writes loads in the other, entry for entry
    (the same JSON layout, schema 1)."""
    src, dst = (pm, ref_pm) if writer == "port" else (ref_pm, pm)
    program = _program(port_core if src is pm else ref_core, _t0(), 4)
    model = src.CostModel()
    model.put(_entry(src, program, exchange_us=1.0 / 3.0))
    model.put(src.MeasuredCost("feedface", CARD_TAG, 0.0098, 5.5, 12.25, 60.0))
    path = str(tmp_path / "cost.json")
    model.save_manifest(path)
    other = dst.CostModel()
    assert other.load_manifest(path) == 2
    for sig, e in model.entries.items():
        assert other.entries[sig].to_json() == e.to_json()
    back = src.CostModel()
    other.save_manifest(path)
    back.load_manifest(path)
    assert back.entries == model.entries


def test_manifest_env_preload(tmp_path, monkeypatch):
    program = _program(port_core, _t0(), 4)
    entry = _entry(pm, program)
    boxed = pm.CostModel()
    boxed.put(entry)
    path = str(tmp_path / "env_cost.json")
    boxed.save_manifest(path)
    monkeypatch.setenv(pm.MANIFEST_ENV, path)
    assert pm.MANIFEST_ENV == ref_pm.MANIFEST_ENV == "REPRO_COST_MANIFEST"
    fresh = pm.CostModel()
    assert fresh.get(entry.signature) == entry  # lazy env-manifest load
    # the planner's model preloads it too: a CPU plan is served by it
    p = port_engine.plan(program, RunOptions(backend="pallas", device="cpu"))
    assert port_engine.stats.cost_model_hits == 1
    assert p.segments[0].time_tile == auto_tile(
        _group(port_core, program), (12, 12), 4, cost=entry, nz=4)


def test_manifest_rejects_wrong_schema(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"schema": 99, "entries": {}}')
    with pytest.raises(ValueError, match="schema"):
        pm.CostModel().load_manifest(str(path))


def test_signature_ignores_brick_but_not_dtype_nz_or_device():
    """One entry serves every brick of a body; dtype, nz and the device tag
    each make another key; a torch and a NumPy dtype make the same one."""
    program = _program(port_core, _t0(), 4)
    group = _group(port_core, program)
    s32 = pm.body_signature(group, 4, np.float32, "cpu")
    assert pm.body_signature(group, 4, np.float32, "cpu") == s32
    assert pm.body_signature(group, 4, torch.float32, "cpu") == s32
    assert pm.body_signature(group, 4, np.dtype("float32"), "cpu") == s32
    assert pm.body_signature(group, 4, "float32", torch.device("cpu")) == s32
    assert pm.body_signature(group, 4, np.float64, "cpu") != s32
    assert pm.body_signature(group, 4, torch.float64, "cpu") != s32
    assert pm.body_signature(group, 8, np.float32, "cpu") != s32
    assert pm.body_signature(group, 4, np.float32, CARD_TAG) != s32
    other = _group(port_core, _program(port_core, _t0((20, 16, 4)), 4))
    assert pm.body_signature(other, 4, np.float32, "cpu") == s32
    assert pm.current_device("cpu") == "cpu"
    assert pm.current_device(torch.device("cpu")) == "cpu"


# -- the planner's decisions against the reference's -------------------------

#: (grid, steps) of the planner cases: the reference tests' 12×12×4 over 6
#: steps, and 16×16×4 over 8 (8×8 bricks on the mesh: k = 4 keeps no
#: interior there, k = 8 still tiles)
GRIDS = {"12": ((12, 12, 4), 6), "16": ((16, 16, 4), 8)}
#: cost entries: none; exchange-bound with free shells (the split wins);
#: costly shells (it loses); and the adversarial entries of the reference's
#: ``test_auto_tile_never_loses_to_k1``
COSTS = {
    "none": None,
    "win": dict(cell_ns=0.001, launch_us=1.0, exchange_us=500.0,
                boundary_us=0.0),
    "loss": dict(cell_ns=0.001, launch_us=1.0, exchange_us=0.1,
                 boundary_us=1000.0),
    "cells": dict(cell_ns=100.0, launch_us=0.0, exchange_us=0.0,
                  boundary_us=0.0),
    "launch": dict(cell_ns=0.0, launch_us=500.0, exchange_us=0.0,
                   boundary_us=0.0),
    "exchange": dict(cell_ns=0.001, launch_us=1.0, exchange_us=900.0,
                     boundary_us=0.1),
    "even": dict(cell_ns=50.0, launch_us=50.0, exchange_us=50.0,
                 boundary_us=50.0),
}
PLACES = ("one", "mesh", "members")
TILES = {"k2": 2, "auto": None}
PLAN_CASES = [(g, p, t, c) for g in GRIDS for p in PLACES for t in TILES
              for c in COSTS]

REF_PLANS = """
import json, sys, warnings
import numpy as np
warnings.simplefilter("ignore")
sys.path.insert(0, {tests!r})
import jax
import repro.core as rc
from repro.core import perfmodel
from repro.core.jaxcompat import make_mesh
from repro.engine import RunOptions, plan, reset_stats, stats
from test_torch_perfmodel import (COSTS, GRIDS, PLAN_CASES, TILES, _group,
                                  _program, _t0)
assert len(jax.devices()) == 4
mesh = make_mesh((2, 2), ("data", "model"))
out = {{}}
for g, place, tile, case in PLAN_CASES:
    shape, steps = GRIDS[g]
    program = _program(rc, _t0(shape), steps)
    perfmodel.cost_model.clear()
    if COSTS[case] is not None:
        sig = perfmodel.body_signature(_group(rc, program), shape[2],
                                       np.float32)
        perfmodel.cost_model.put(perfmodel.MeasuredCost(
            signature=sig, device=perfmodel.current_device(), **COSTS[case]))
    reset_stats()
    p = plan(program, RunOptions(
        backend="pallas", time_tile=TILES[tile],
        mesh=mesh if place == "mesh" else None,
        batch=3 if place == "members" else 1))
    seg = next(s for s in p.segments if s.loop is not None)
    out["/".join((g, place, tile, case))] = [seg.time_tile, seg.split,
                                             stats.cost_model_hits]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_plans():
    """The reference's (time_tile, split, cost_model_hits) of every planner
    case, from one subprocess with four fake CPU devices (its 2×2 mesh)."""
    code = REF_PLANS.format(tests=os.path.join(ROOT, "tests"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("grid,place,tile,case", PLAN_CASES)
def test_planner_decisions_match_reference(ref_plans, grid, place, tile,
                                           case):
    """``time_tile`` and ``Segment.split`` of ``overlap="auto"`` plans equal
    the reference's for the same entry: on one device, per brick of a 2×2
    mesh (the entry looked up for the mesh's home device) and with 3
    members; one hit with an entry, none without."""
    shape, steps = GRIDS[grid]
    program = _program(port_core, _t0(shape), steps)
    if COSTS[case] is not None:
        sig = pm.body_signature(_group(port_core, program), shape[2],
                                np.float32, "cpu")
        pm.cost_model.put(pm.MeasuredCost(signature=sig, device="cpu",
                                          **COSTS[case]))
    p = port_engine.plan(program, RunOptions(
        backend="pallas", time_tile=TILES[tile], device="cpu",
        mesh=make_mesh((2, 2), ("data", "model"), device="cpu")
        if place == "mesh" else None,
        batch=3 if place == "members" else 1))
    seg = next(s for s in p.segments if s.loop is not None)
    got = [seg.time_tile, seg.split, port_engine.stats.cost_model_hits]
    assert got == ref_plans["/".join((grid, place, tile, case))]
    assert got[2] == (COSTS[case] is not None)


@pytest.mark.parametrize("case", ["cells", "launch", "exchange", "even"])
def test_auto_tile_matches_reference_and_never_loses_to_k1(case):
    """Model-driven ``auto_tile`` on the reference's adversarial entries:
    the reference's k, and a predicted time no worse than k = 1's."""
    group = _group(port_core, _program(port_core, _t0(), 8))
    ref_group = _group(ref_core, _program(ref_core, _t0(), 8))
    cost, ref_cost = _cost(pm, **COSTS[case]), _cost(ref_pm, **COSTS[case])
    k = auto_tile(group, (16, 16), 8, cost=cost, nz=4)
    assert k == ref_ir.auto_tile(ref_group, (16, 16), 8, cost=ref_cost, nz=4)
    t_k = min(pm.predict_step_us(cost, (16, 16), 4, group.halo, k),
              pm.predict_step_us(cost, (16, 16), 4, group.halo, k,
                                 split=True))
    assert t_k <= pm.predict_step_us(cost, (16, 16), 4, group.halo, 1)
    tiny = _cost(pm, cell_ns=1.0, launch_us=1.0, exchange_us=1.0,
                 boundary_us=1.0)
    assert pm.predict_step_us(tiny, (4, 4), 4, 1, 2, split=True) == float(
        "inf")


#: the heat body lowered by each package
HEAT_GROUPS = (_group(port_core, _program(port_core, _t0(), 4)),
               _group(ref_core, _program(ref_core, _t0(), 4)))


@given(FLOATS, FLOATS, FLOATS, FLOATS, st.integers(3, 64),
       st.integers(3, 64), st.integers(1, 64), st.integers(1, 32))
@settings(**SMALL)
def test_auto_tile_matches_reference_under_hypothesis(cell, launch, exch, bnd,
                                                      bx, by, nz, n):
    """For any entry, brick and trip count: the reference's k, with and
    without an entry (the static rule unchanged)."""
    vals = dict(cell_ns=cell, launch_us=launch, exchange_us=exch,
                boundary_us=bnd)
    for cost, ref_cost in ((None, None),
                           (_cost(pm, **vals), _cost(ref_pm, **vals))):
        assert auto_tile(HEAT_GROUPS[0], (bx, by), n, cost=cost, nz=nz) == \
            ref_ir.auto_tile(HEAT_GROUPS[1], (bx, by), n, cost=ref_cost,
                             nz=nz)



# -- calibration on the CPU ----------------------------------------------------

def test_calibrate_on_cpu_tags_cpu_and_steers_the_next_cpu_plan(tmp_path):
    """``calibrate_program`` at 16×16×4 times the plain versions, tags the
    entry ``"cpu"``, counts one calibration, writes the manifest; the next
    CPU plan counts one hit and takes the model's pick."""
    program = _program(port_core, _t0((16, 16, 4)), 4)
    manifest = str(tmp_path / "cost.json")
    entries = pm.calibrate_program(program, device="cpu", ks=(1, 2), reps=1,
                                   inner=2, manifest=manifest)
    entry = entries["T_n"]
    assert entry.device == "cpu" and port_engine.stats.calibrations == 1
    assert entry.signature == pm.body_signature(
        _group(port_core, program), 4, np.float32, "cpu")
    assert min(entry.cell_ns, entry.launch_us, entry.exchange_us,
               entry.boundary_us) >= 0.0
    fresh = pm.CostModel()
    assert fresh.load_manifest(manifest) == 1
    assert fresh.entries[entry.signature] == entry
    port_engine.reset_stats()
    p = port_engine.plan(program, RunOptions(backend="pallas", device="cpu"))
    assert port_engine.stats.cost_model_hits == 1
    assert p.segments[0].time_tile == auto_tile(
        _group(port_core, program), (16, 16), 4, cost=entry, nz=4)


def test_card_entry_does_not_steer_a_cpu_plan():
    """An entry tagged for a card (a split predicted to win) is never
    looked up by a CPU plan: no hit, the static tile, no split."""
    program = _program(port_core, _t0(), 6)
    sig = pm.body_signature(_group(port_core, program), 4, np.float32,
                            CARD_TAG)
    pm.cost_model.put(pm.MeasuredCost(sig, CARD_TAG, **COSTS["win"]))
    p = port_engine.plan(program, RunOptions(backend="pallas", device="cpu"))
    assert port_engine.stats.cost_model_hits == 0
    assert (p.segments[0].time_tile, p.segments[0].split) == (2, 0)


@pytest.mark.parametrize("place", ["one", "mesh"])
def test_calibrated_make_equals_uncalibrated_bitwise(place):
    """``make`` with ``time_tile=None`` and ``overlap="auto"`` after a CPU
    calibration (and at ``time_tile=2`` with an entry predicting the split
    faster, which splits) equals the uncalibrated ``make`` bit for bit.
    32×32×4: the 2×2 mesh's 16×16 bricks hide enough interior cells under
    the exchange for the split to win (on 8×8 bricks it loses)."""
    T0 = _t0((32, 32, 4))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu") \
        if place == "mesh" else None

    def make(time_tile=None):
        wse, T = build_heat(port_core, T0, 8)
        return wse.make(answer=T, options=RunOptions(
            backend="pallas", device="cpu", mesh=mesh, time_tile=time_tile))

    want = make()
    program = _program(port_core, T0, 8)
    pm.calibrate_program(program, device="cpu", ks=(1, 2), reps=1, inner=2)
    port_engine.reset_stats()
    np.testing.assert_array_equal(make(), want)
    assert port_engine.stats.cost_model_hits == 1
    pm.cost_model.clear()
    sig = pm.body_signature(_group(port_core, program), 4, np.float32, "cpu")
    pm.cost_model.put(pm.MeasuredCost(sig, "cpu", **COSTS["win"]))
    port_engine.reset_stats()
    np.testing.assert_array_equal(make(2), want)
    assert port_engine.stats.interior_launches == port_engine.stats.launches


def test_calibrate_raises_for_a_body_that_does_not_fuse():
    """A body that does not lower raises ``LoweringError`` from
    ``calibrate`` (nothing is timed on the interpreter);
    ``calibrate_program`` skips it, as the reference does."""
    T0 = _t0()
    wse = port_core.WSE_Interface()
    T = port_core.WSE_Array("T", init_data=T0, dtype=T0.dtype)
    with port_core.WSE_For_Loop("t", 4):
        T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[1:-1, 0, 0] * T[1:-1, 1, 0]
    wse.__exit__()
    shapes = {n: f.shape for n, f in wse.program.fields.items()}
    dtypes = {n: f.dtype for n, f in wse.program.fields.items()}
    with pytest.raises(LoweringError):
        pm.calibrate(wse.program.ops, shapes, dtypes, device="cpu")
    assert pm.calibrate_program(wse.program, device="cpu") == {}
    assert port_engine.stats.calibrations == 0


def test_calibrate_refuses_a_missing_card():
    """The default device is the card; without one calibration raises
    instead of timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    program = _program(port_core, _t0(), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.calibrate_program(program)
    assert pm.cost_model.entries == {}
