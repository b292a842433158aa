"""The PyTorch port's exchange/compute overlap (``RunOptions(overlap=True)``)
on the CPU, against its monolithic launch and the JAX reference.

The port's counterpart of ``tests/test_overlap.py`` (its cases that need no
calibrated cost model).  Tolerances, and why:

* ``split_regions`` equals the reference's and partitions the brick;
* ``wrap_slabs`` / ``strip_window`` / ``land_region`` equal the reference's
  bitwise, and each shell's window equals the same window of a refreshed
  buffer (``wrap_refresh`` on one device, ``halo_refresh`` on a 2×2 mesh)
  bitwise: they move values, they compute none;
* K1's region mode in its plain versions (``fused_step_ref``,
  ``fused_sweep_ref``) equals the monolithic launch's region cells bitwise
  and leaves every other cell of its output alone: each cell's arithmetic
  is the same, from the same global coordinates;
* ``overlap=True`` through every entry point (``make``, ``run_program``,
  ``Ensemble.make``, ``make(mesh=…)``, ``run_sharded``) equals the
  monolithic run bitwise, and ``make_sharded_ftcs(overlap=True)`` the
  plain step;
* against the reference's ``overlap=True`` runs (one device and a 2×2
  mesh of 4 fake CPU devices) and its ``make_sharded_ftcs(overlap=True)``:
  bitwise at f32 and f64.  The reference runs in a subprocess with
  ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``: without FMA instructions XLA
  does not contract ``a·b + c``, and every operation rounds on its own, as
  torch's do (under ``jax.disable_jit`` alone the interpret-mode kernel
  still differs by about an f32 ulp).
"""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.compiler.ir as ref_ir
import repro.core as ref_core
import repro.engine.layout as ref_layout
import repro_torch as wfa
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from conftest import heat_init
from repro_torch.compiler import LoweredGroup, lower_group
from repro_torch.compiler.codegen import compile_group_sharded
from repro_torch.compiler.ir import RegionSpec, split_regions
from repro_torch.core import explicit
from repro_torch.core.halo import exchange_slabs, halo_refresh
from repro_torch.core.mesh import NamedSharding, device_get, make_mesh
from repro_torch.engine import HaloLayout, RunOptions
from repro_torch.engine.layout import (land_region, strip_window, wrap_refresh,
                                       wrap_slabs)
from repro_torch.kernels.fused import (fused_step_ref, fused_sweep_ref,
                                       k1_launch_shape, sweep_geoms)
from test_torch_cuda import k1_kernel
from test_torch_program import build_heat, build_wide

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA = 0.1
#: what split_regions reads of a halo-1 body
HALO1 = LoweredGroup(updates=(), halo=1)


def _mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"), device="cpu")


def _groups(build):
    """The port's and the reference's lowering of ``build``'s body."""
    out = []
    for m, lower in ((port_core, lower_group), (ref_core, ref_ir.lower_group)):
        wse, _ = build(m)
        out.append(lower(wse.program.ops))
        wse.__exit__()
    return out


# -- the region split -----------------------------------------------------------

@pytest.mark.parametrize("body", ["heat", "wide"])
def test_split_regions_match_reference_and_partition(body):
    """The reference's split, region for region, and a partition of the
    brick (``test_split_regions_partition``); ``None`` where the brick keeps
    no interior or the body has no halo."""
    T0 = heat_init((8, 8, 4))
    P0 = np.ones((8, 8, 9), np.float32)
    build = {"heat": lambda m: build_heat(m, T0, 2),
             "wide": lambda m: build_wide(m, P0, P0[..., :7], P0[..., :6],
                                          2)}[body]
    port, ref = _groups(build)
    assert port.halo == ref.halo
    for k, brick in itertools.product((1, 2, 3, 8), ((8, 8), (17, 12),
                                                     (40, 33), (6, 50))):
        got, want = split_regions(port, k, brick), ref_ir.split_regions(
            ref, k, brick)
        assert (got is None) == (want is None), (k, brick)
        if got is None:
            continue
        assert [tuple(vars(r).values()) for r in (got.interior, *got.shells)] \
            == [tuple(vars(r).values()) for r in (want.interior, *want.shells)]
        cover = np.zeros(brick, int)
        for r in (got.interior, *got.shells):
            cover[r.x0:r.x0 + r.rx, r.y0:r.y0 + r.ry] += 1
        assert (cover == 1).all(), (k, brick)
    assert split_regions(LoweredGroup(updates=(), halo=0), 2, (40, 40)) is None


# -- the layout primitives --------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_slabs_windows_and_landing_match_reference(rng, k, lead):
    """``wrap_slabs`` / ``strip_window`` / ``land_region`` equal the
    reference's on the same buffer, with held ``out=`` buffers too, and each
    shell's window equals the same window of a ``wrap_refresh``-ed buffer
    (the monolithic launch's input)."""
    import jax.numpy as jnp

    h = k                                   # a halo-1 body at time tile k
    bx, by, M = 2 * h + 5, 2 * h + 3, h + 1
    buf = rng.normal(size=(*lead, bx + 2 * M, by + 2 * M, 4)).astype(np.float32)
    t = torch.tensor(buf)
    slabs = wrap_slabs(t, M, h)
    want = ref_layout.wrap_slabs(jnp.asarray(buf), M, h)
    held = {n: torch.full_like(s, -7.0) for n, s in slabs.items()}
    wrap_slabs(t, M, h, out=held)
    for n in want:
        np.testing.assert_array_equal(slabs[n].numpy(), np.asarray(want[n]))
        assert torch.equal(held[n], slabs[n])
    refreshed = wrap_refresh(t.clone(), M, h)
    assert torch.equal(t, torch.tensor(buf))          # only read
    split = split_regions(HALO1, k, (bx, by))
    for r in (split.interior, *split.shells):
        win = strip_window(t, slabs, M, h, r, bx, by)
        ref_win = ref_layout.strip_window(jnp.asarray(buf), want, M, h,
                                          ref_ir.RegionSpec(r.x0, r.y0, r.rx,
                                                            r.ry), bx, by)
        np.testing.assert_array_equal(win.numpy(), np.asarray(ref_win))
        x0, y0 = M + r.x0 - h, M + r.y0 - h
        assert torch.equal(win, refreshed[..., x0:x0 + r.rx + 2 * h,
                                          y0:y0 + r.ry + 2 * h, :])
        into = torch.full_like(win, 3.0)
        assert strip_window(t, slabs, M, h, r, bx, by, out=into) is into
        assert torch.equal(into, win)
        piece = torch.tensor(rng.normal(size=(*lead, r.rx, r.ry, 4))
                             .astype(np.float32))
        landed = land_region(t.clone(), piece, M, r)
        np.testing.assert_array_equal(landed.numpy(), np.asarray(
            ref_layout.land_region(jnp.asarray(buf), jnp.asarray(piece.numpy()),
                                   M, ref_ir.RegionSpec(r.x0, r.y0, r.rx,
                                                        r.ry))))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_exchanged_windows_equal_halo_refresh(rng, k):
    """On a 2×2 mesh each shell's window, from ``exchange_slabs`` into held
    buffers, equals the same window of ``halo_refresh``'s buffers (zero fill
    on the domain's edges, corners from the diagonal neighbour)."""
    mesh = _mesh()
    h, M = k, k + 1
    bx, by = 2 * h + 4, 2 * h + 3
    x = rng.normal(size=(2 * bx, 2 * by, 3)).astype(np.float64)
    lay = HaloLayout(pad=M, shapes={})
    bricks = [lay.enter({"x": b})["x"]
              for b in NamedSharding(mesh).shard(torch.tensor(x)).bricks]
    refreshed = halo_refresh([b.clone() for b in bricks], M, h, mesh)
    held = [{n: torch.full_like(s, 9.0) for n, s in d.items()}
            for d in exchange_slabs(bricks, M, h, mesh)]
    slabs = exchange_slabs(bricks, M, h, mesh, out=held)
    split = split_regions(HALO1, k, (bx, by))
    for b, r in itertools.product(range(mesh.size), (split.interior,
                                                     *split.shells)):
        assert slabs[b]["lo_y"] is held[b]["lo_y"]
        win = strip_window(bricks[b], slabs[b], M, h, r, bx, by)
        x0, y0 = M + r.x0 - h, M + r.y0 - h
        assert torch.equal(win, refreshed[b][x0:x0 + r.rx + 2 * h,
                                             y0:y0 + r.ry + 2 * h]), (b, r)


# -- K1's region mode -------------------------------------------------------------

def _kernel(name, dtype, k, margin, shape, batch=1, region=None, brick=None):
    """K1 of ``k1_body`` ``name`` on the CPU on a grid of (X, Y) ``shape``
    (large enough for an interior at k = 8), at time tile ``k``, for the
    whole grid or a ``brick`` extent (a shell's padded launch)."""
    return k1_kernel(name, dtype, "cpu", margin=margin, k=k, brick=brick,
                     batch=batch, grid=shape, region=region)[0]


def _split(kern, k, shape):
    return split_regions(LoweredGroup(kern.updates, kern.halo), k, shape)


@pytest.mark.parametrize("name", ["heat", "hazard"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_region_mode_plain_equals_monolithic(rng, k, dtype, name):
    """The interior of ``split_regions`` through K1's region mode — its
    plain launch and its plain sweep schedule (``sweep_geoms`` moved by the
    origin) — equals the monolithic launch's interior cells bitwise, 1 and 3
    members; every other output cell keeps its value.  Each shell's padded
    launch on its ``strip_window`` equals the monolithic launch's shell."""
    shape = (2 * k + 7, 2 * k + 6)
    mono = _kernel(name, dtype, k, k + 1, shape)
    split = _split(mono, k, shape)
    M, ph = mono.margin, mono.pad
    for B in (1, 3):
        kern = _kernel(name, dtype, k, M, shape, batch=B,
                       region=split.interior)
        assert kern.extent == mono.extent and kern.span == (
            split.interior.rx, split.interior.ry)
        lead = (B,) if B > 1 else ()
        ins = [torch.tensor(rng.uniform(0.5, 1.5, (*lead, *mono.extent, nz))
                            .astype(dtype)) for nz in mono.nz]
        whole = fused_step_ref(
            _kernel(name, dtype, k, M, shape, batch=B), ins,
            out=[torch.full_like(ins[mono.in_names.index(n)], -7.0)
                 for n in mono.written])
        r = split.interior
        for call in (fused_step_ref, fused_sweep_ref):
            out = [torch.full_like(ins[mono.in_names.index(n)], -7.0)
                   for n in mono.written]
            got = call(kern, ins, (r.x0, r.y0), out=out)
            for g, w in zip(got, whole):
                cells = (..., slice(M + r.x0, M + r.x0 + r.rx),
                         slice(M + r.y0, M + r.y0 + r.ry), slice(None))
                assert torch.equal(g[cells], w[cells]), (call.__name__, B)
                keep = torch.ones(g.shape[-3:-1], dtype=torch.bool)
                keep[cells[1], cells[2]] = False
                assert (g[..., keep, :] == -7.0).all()
        # the shells: padded launches on windows cut from the same buffers
        for s in split.shells:
            shell = _kernel(name, dtype, k, 0, shape, batch=B,
                            brick=(s.rx, s.ry))
            wins = [t[..., M + s.x0 - ph:M + s.x0 + s.rx + ph,
                      M + s.y0 - ph:M + s.y0 + s.ry + ph, :].contiguous()
                    for t in ins]
            got = fused_sweep_ref(shell, wins, (s.x0, s.y0))
            for g, w in zip(got, whole):
                assert torch.equal(g, w[..., M + s.x0:M + s.x0 + s.rx,
                                        M + s.y0:M + s.y0 + s.ry, :])


def test_region_geometry_and_refusals():
    """Region geometry: every sub-step's window and destination move by the
    origin, a 1-wide region is a one-x grid; a region without a margin, off
    the diagonal or outside the brick is refused."""
    k, shape = 2, (12, 9)
    mono = _kernel("heat", np.float32, k, 3, shape)
    r = _split(mono, k, shape).interior
    kern = _kernel("heat", np.float32, k, 3, shape, region=r)
    for g0, g in zip(sweep_geoms(mono), sweep_geoms(kern, (r.x0, r.y0))):
        assert (g.in_off, g.out_off) == (g0.in_off + r.x0, g0.out_off + r.x0)
        assert (g.cx, g.cy) == (g0.cx + r.x0, g0.cy + r.y0)
        assert (g.bx, g.by) == (g0.bx - 2 * r.x0, g0.by - 2 * r.y0)
    one = _kernel("heat", np.float32, 1, 1, shape,
                  region=RegionSpec(1, 1, 1, 7))
    assert k1_launch_shape(one)[0][1] == 1
    for bad, margin, msg in ((r, 0, "margin"),
                             (RegionSpec(2, 3, 4, 4), 3, "diagonal"),
                             (RegionSpec(2, 2, 11, 4), 3, "leaves")):
        with pytest.raises(ValueError, match=msg):
            _kernel("heat", np.float32, k, margin, shape, region=bad)



@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_builders_refuse_a_split_that_does_not_fit(mesh):
    """The planner alone decides the split; the builders take it and refuse
    one made for another tile depth, another brick or a repacking step."""
    T0 = _t0(16, 12)
    wse, _ = build_heat(port_core, T0, 4)
    ops = wse.program.ops
    wse.__exit__()
    group = lower_group(ops)
    shapes, dtypes = {"T_n": T0.shape}, {"T_n": T0.dtype}
    brick = (16, 12) if mesh is None else (8, 6)
    if mesh is None:
        build = lambda **kw: port_compiler.compile_group(  # noqa: E731
            ops, shapes, dtypes, device="cpu", group=group, **kw)
    else:
        build = lambda **kw: compile_group_sharded(  # noqa: E731
            ops, shapes, dtypes, _mesh(mesh), group=group, **kw)
    build(time_tile=2, resident=2, split=split_regions(group, 2, brick))
    for k, resident, at in ((2, 2, (brick[0] + 2, brick[1])),
                            (2, 2, brick[::-1]), (1, 2, brick), (2, 0, brick)):
        with pytest.raises(ValueError, match="is not the split"):
            build(time_tile=k, resident=resident,
                  split=split_regions(group, 2, at))

# -- overlap=True through the entry points ------------------------------------------

def _t0(nx=12, ny=12, nz=4):
    return np.random.default_rng(7).uniform(250.0, 500.0,
                                            (nx, ny, nz)).astype(np.float32)


def _make(T0, steps, mesh=None, **opts):
    wse, T = build_heat(port_core, T0, steps)
    return wse.make(answer=T, options=RunOptions(backend="pallas",
                                                 device="cpu", mesh=mesh,
                                                 **opts))


@pytest.mark.parametrize("mesh", [None, (2, 2)])
@pytest.mark.parametrize("steps,k", [(6, 1), (6, 2), (7, 2)])
def test_split_matches_monolithic_bitwise(steps, k, mesh):
    """Forced split == monolithic, the n % k remainder included, on one
    device and on a 2×2 mesh."""
    T0 = _t0(16, 12)
    mesh = mesh and _mesh(mesh)
    base = _make(T0, steps, mesh, time_tile=k, overlap=False)
    port_compiler.reset_stats()
    ov = _make(T0, steps, mesh, time_tile=k, overlap=True)
    np.testing.assert_array_equal(base, ov)
    assert port_compiler.stats.fallbacks == 0


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_split_matches_monolithic_batched(mesh):
    """B > 1 members split bitwise too (``Ensemble.make``), each member its
    own split run."""
    T0 = _t0(16, 12)
    mesh = mesh and _mesh(mesh)
    stack = np.stack([T0, T0 + 1.0, T0 * np.float32(1.01)])
    opts = dict(backend="pallas", time_tile=2, device="cpu", mesh=mesh)
    out = {}
    for ov in (False, True):
        wse, T = build_heat(port_core, T0, 6)
        out[ov] = wfa.make(wfa.Ensemble(wse.program, T,
                                        overrides={"T_n": stack}),
                           options=RunOptions(overlap=ov, **opts))
    assert out[True].shape == stack.shape
    np.testing.assert_array_equal(out[False], out[True])
    single = _make(T0, 6, mesh, time_tile=2, overlap=True)
    np.testing.assert_array_equal(out[True][0], single)


def test_overlap_stats_counters():
    """Split runs count interior/boundary launches + overlapped exchanges."""
    T0 = _t0()
    port_engine.reset_stats()
    _make(T0, 6, time_tile=2, overlap=True)
    st = port_engine.stats
    assert (st.interior_launches, st.boundary_launches,
            st.overlapped_exchanges) == (3, 12, 3)
    port_engine.reset_stats()
    _make(T0, 6, time_tile=2, overlap=False)
    assert (st.interior_launches, st.boundary_launches,
            st.overlapped_exchanges) == (0, 0, 0)


def test_split_refused_keeps_monolithic_and_auto_stays():
    """A brick too small for an interior at depth k·h keeps the monolithic
    launch (split = 0) and still runs right; so does ``resident=False``;
    ``overlap="auto"`` (no cost model) never splits."""
    T0 = _t0(6, 6)
    wse, T = build_heat(port_core, T0, 8)
    prog = wse.program
    wse.__exit__()
    for opts in (dict(time_tile=4, overlap=True),
                 dict(time_tile=1, overlap=True, resident=False),
                 dict(time_tile=1), dict(time_tile=2, overlap="auto")):
        p = port_engine.plan(prog, RunOptions(backend="pallas", device="cpu",
                                              **opts))
        assert next(s for s in p.segments if s.loop is not None).split == 0
    p = port_engine.plan(prog, RunOptions(backend="pallas", device="cpu",
                                          time_tile=1, overlap=True))
    assert next(s for s in p.segments if s.loop is not None).split == 4
    np.testing.assert_array_equal(_make(T0, 8, time_tile=4, overlap=False),
                                  _make(T0, 8, time_tile=4, overlap=True))


def test_run_program_and_run_sharded_entry_points():
    T0 = _t0(16, 12)
    wse, T = build_heat(port_core, T0, 5)
    prog = wse.program
    wse.__exit__()
    want = _make(T0, 5, time_tile=1)
    opts = RunOptions(backend="pallas", device="cpu", overlap=True)
    np.testing.assert_array_equal(
        port_engine.run_program(prog, {"T_n": T0}, opts)["T_n"], want)
    np.testing.assert_array_equal(
        wfa.run_sharded(prog, {"T_n": T0}, _mesh(), options=opts)["T_n"], want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_ftcs_overlapped_equals_plain(dtype):
    G = np.random.default_rng(5).uniform(300.0, 500.0, (8, 12, 10)).astype(dtype)
    for shape in ((1, 1), (2, 2)):
        out = {}
        for ov in (False, True):
            step, sh = explicit.make_sharded_ftcs(_mesh(shape), G.shape, OMEGA,
                                                  overlap=ov, steps_per_call=3)
            out[ov] = device_get(step(sh.shard(torch.tensor(G))))
        np.testing.assert_array_equal(out[False], out[True])


# -- against the reference ---------------------------------------------------------

def ref_cases():
    """key -> (record(module) -> (wse, answer), env, time tile) of the
    reference's ``overlap=True`` runs: heat (h = 1) at k = 1 and 2 with a
    remainder, f32 and f64, and a halo-2 body with mixed nz at f32."""
    cases = {}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        T0 = heat_init((16, 12, 10)).astype(dtype)
        rng = np.random.default_rng(3)
        P0, Q0, R0 = (rng.uniform(0.0, hi, (24, 20, nz)).astype(dtype)
                      for hi, nz in ((1.0, 9), (0.1, 7), (1.0, 6)))
        for k in (1, 2):
            cases[f"heat_{name}_k{k}"] = (
                lambda m, T0=T0: build_heat(m, T0, 7), {"T_n": T0}, k)
        if dtype == np.float32:
            cases[f"wide_{name}_k2"] = (
                lambda m, P0=P0, Q0=Q0, R0=R0: build_wide(m, P0, Q0, R0, 5),
                {"P": P0, "Q": Q0, "R": R0}, 2)
    return cases


def ftcs_field(dtype):
    return np.random.default_rng(5).uniform(300.0, 500.0,
                                            (8, 12, 10)).astype(dtype)


REF_SCRIPT = """
import sys, warnings
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
warnings.simplefilter("ignore")
sys.path.insert(0, {tests!r})
import jax.numpy as jnp
import repro.core as rc
from repro.core.explicit import make_sharded_ftcs
from repro.core.halo import run_sharded
from repro.core.jaxcompat import make_mesh
from repro.engine import RunOptions
from repro.engine.executor import run_program
from test_torch_overlap import ftcs_field, ref_cases
assert len(jax.devices()) == 4
mesh = make_mesh((2, 2), ("data", "model"))
out = {{}}
for key, (body, env, k) in ref_cases().items():
    wse, ans = body(rc)
    prog = wse.program
    wse.__exit__()
    opts = RunOptions(backend="pallas", time_tile=k, overlap=True)
    out[key + "_one"] = run_program(prog, env, opts)[ans.name]
    out[key + "_mesh"] = run_sharded(prog, env, mesh, options=opts)[ans.name]
one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                        ("data", "model"))
for dtype in (np.float32, np.float64):
    G = ftcs_field(dtype)
    for tag, m in (("1x1", one), ("2x2", mesh)):
        step, sh = make_sharded_ftcs(m, G.shape, {omega}, overlap=True,
                                     steps_per_call=3)
        out[f"ftcs_{{tag}}_{{np.dtype(dtype).name}}"] = np.asarray(
            jax.device_get(step(jax.device_put(jnp.asarray(G), sh))))
np.savez({path!r}, **out)
"""


def test_overlap_matches_reference_bitwise(tmp_path):
    """The port's ``overlap=True`` runs equal the reference's bitwise: one
    device and a 2×2 mesh, heat and a halo-2 body, f32 and f64; and
    ``make_sharded_ftcs(overlap=True)`` on 1×1 and 2×2."""
    path = str(tmp_path / "ref.npz")
    code = REF_SCRIPT.format(tests=os.path.join(ROOT, "tests"), omega=OMEGA,
                             path=path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_max_isa=SSE4_2")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = np.load(path)
    for key, (body, env, k) in ref_cases().items():
        for tag, mesh in (("one", None), ("mesh", _mesh())):
            wse, ans = body(port_core)
            with wse:
                got = port_engine.run_program(wse.program, env, RunOptions(
                    backend="pallas", time_tile=k, overlap=True, device="cpu",
                    mesh=mesh))[ans.name]
            assert got.dtype == ref[f"{key}_{tag}"].dtype
            np.testing.assert_array_equal(got, ref[f"{key}_{tag}"],
                                          err_msg=f"{key}_{tag}")
    for dtype in (np.float32, np.float64):
        G = ftcs_field(dtype)
        for shape in ((1, 1), (2, 2)):
            step, sh = explicit.make_sharded_ftcs(_mesh(shape), G.shape, OMEGA,
                                                  overlap=True,
                                                  steps_per_call=3)
            key = f"ftcs_{shape[0]}x{shape[1]}_{np.dtype(dtype).name}"
            np.testing.assert_array_equal(
                device_get(step(sh.shard(torch.tensor(G)))), ref[key],
                err_msg=key)
