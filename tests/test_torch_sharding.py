"""The PyTorch port's sharded execution on single-process CPU meshes vs its
single-device runs and the JAX reference.

The port's counterpart of ``tests/test_sharded.py`` and the mesh cases of
``tests/test_solver_api.py`` / ``tests/test_multigrid.py``.  Tolerances,
and why:

* the margin exchange (``exchange_slabs``, ``halo_refresh``) equals the
  port's ``halo_pad`` bitwise, and ``land_slabs`` the reference's: they
  move values, they compute none;
* sharded ``make`` on ``backend="pallas"`` equals the single-device
  ``make`` bitwise (heat, advection–diffusion: halo-1 bodies, whose Moat
  keeps every out-of-domain cell away from the interior), resident and
  repacking, at k = 1 and 4, f32 and f64; an ensemble member equals its
  own sharded run bitwise;
* ``backend="shard_map"`` is within 2e-3 of the reference's single-device
  ``jit`` (``tests/test_sharded.py``'s bound);
* solves on a mesh: the Krylov methods within 2e-4 of the single-device
  solve (``tests/test_solver_api.py``'s bound: dots summed brick by brick
  in another order), ``method="mg"`` within 1e-5 with the same iteration
  count and mg-PCG within 1e-4 and ±1 iteration
  (``tests/test_multigrid.py``'s bounds), ``make_sharded_implicit``
  within 5e-3 of the reference's ``btcs_solve`` (``tests/test_sharded.py``);
* against the reference's own 4-device ``run_sharded`` (a subprocess with
  four fake CPU devices): bitwise at f64 and at f32, on the heat body and
  on a halo-2 body, on both backends.  A halo-2 body reads out-of-domain
  cells next to the Moat, where a sharded run (zero fill) and a
  single-device run (wrap) differ, so it is held against the reference's
  sharded run.  The subprocess runs XLA with ``--xla_cpu_max_isa=SSE4_2``:
  without FMA instructions XLA does not contract ``a·b + c``, and every
  operation rounds on its own, as torch's do.
"""
import itertools
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch as wfa
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from conftest import heat_init
from repro.core import implicit as ref_implicit
from repro.core.boundary import local_interior_mask as ref_local_mask
from repro.engine import RunOptions as RefOptions
from repro.engine.layout import land_slabs as ref_land_slabs
from repro_torch.core import implicit
from repro_torch.core.boundary import local_interior_mask
from repro_torch.core.halo import (exchange_slabs, halo_pad, halo_refresh,
                                   local_moat_mask)
from repro_torch.core.mesh import NamedSharding, device_get, make_mesh
from repro_torch.engine import HaloLayout, RunOptions
from repro_torch.engine.hooks import set_compile_hook
from repro_torch.engine.layout import land_slabs, slab_views
from repro_torch.kernels.fused import fused_step_ref, fused_sweep_ref
from repro_torch.solver import poisson_program, record_btcs
from test_torch_cuda import k1_kernel, zero_window
from test_torch_program import build_advdiff, build_heat, build_wide

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA = 0.1
#: the reference's sharded test field (tests/test_sharded.py's PREAMBLE)
T_SHAPE = (8, 12, 10)


def _mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"), device="cpu")


def _bricks(x, mesh):
    return list(NamedSharding(mesh).shard(torch.tensor(x)).bricks)


# -- the margin exchange ------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 1)])
def test_refresh_and_exchange_equal_halo_pad(rng, mesh_shape, h, dtype, lead):
    """Resident bricks refreshed in place (and slabs exchanged, then
    landed) hold exactly ``halo_pad``'s padded bricks in their window,
    corners and the zero fill of edge bricks included; the margin beyond
    depth h and the interior are untouched."""
    mesh = _mesh(mesh_shape)
    x = rng.normal(size=(*lead, 12, 8, 5)).astype(dtype)
    bricks = _bricks(x, mesh)
    padded = halo_pad(bricks, h, mesh)
    M = h + 1
    lay = HaloLayout(pad=M, shapes={})
    enter = [lay.enter({"x": t})["x"] for t in bricks]
    for t in enter:
        t[..., :1, :, :] = -7.0          # outside the depth-h window
    resident = [t.clone() for t in enter]
    out = halo_refresh(resident, M, h, mesh)
    landed = [t.clone() for t in enter]
    for t, slabs in zip(landed, exchange_slabs(landed, M, h, mesh)):
        land_slabs(t, slabs, M, h)
    for b, (p, r, g, e) in enumerate(zip(padded, resident, landed, enter)):
        assert out[b] is r
        win = (..., slice(M - h, r.shape[-3] - M + h),
               slice(M - h, r.shape[-2] - M + h), slice(None))
        assert torch.equal(r[win], p) and torch.equal(g, r)
        keep = torch.ones(r.shape[-3:-1], dtype=torch.bool)
        keep[M - h:r.shape[-3] - M + h, M - h:r.shape[-2] - M + h] = False
        keep[M:-M, M:-M] = True
        assert torch.equal(r[..., keep, :], e[..., keep, :])


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("h", [1, 2])
def test_land_slabs_matches_reference(rng, h, lead):
    M = h + 1
    buf = rng.normal(size=(*lead, 7 + 2 * M, 6 + 2 * M, 4)).astype(np.float32)
    slabs = {n: rng.normal(size=tuple(v.shape)).astype(np.float32)
             for n, v in slab_views(torch.tensor(buf), M, h).items()}
    want = ref_land_slabs(jnp.asarray(buf), {n: jnp.asarray(v) for n, v
                                             in slabs.items()}, M, h)
    got = land_slabs(torch.tensor(buf), {n: torch.tensor(v) for n, v
                                         in slabs.items()}, M, h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_local_masks_match_reference():
    for mesh_xy in ((2, 2), (3, 1), (1, 1), (3, 3)):
        for cx in range(mesh_xy[0]):
            for cy in range(mesh_xy[1]):
                want = ref_local_mask((5, 4), (cx, cy), mesh_xy, np)
                np.testing.assert_array_equal(
                    local_interior_mask((5, 4), (cx, cy), mesh_xy, np), want)
                got = local_interior_mask((5, 4), (cx, cy), mesh_xy, torch)
                np.testing.assert_array_equal(got.numpy(), want)
                moat = local_moat_mask(5, 4, (cx, cy), *mesh_xy, "cpu")
                np.testing.assert_array_equal(moat.numpy(), want)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 3)])
@pytest.mark.parametrize("name", ["heat", "hazard"])
def test_sweep_schedule_on_sharded_bricks(name, mesh_shape):
    """K1's plain sweep schedule (the card's route at k > 1) equals its
    plain launch on every brick of a mesh at ``wrap=False``: the regions of
    edge bricks start below 0 and end past the grid, where both mask the
    cells out rather than wrapping them."""
    mx, my = mesh_shape
    for k, M in itertools.product((2, 3, 8), (0, None)):
        whole, env = k1_kernel(name, np.float64, "cpu")
        bx, by = whole.nx // mx, whole.ny // my
        M = 0 if M == 0 else k * whole.halo + 1
        kern, _ = k1_kernel(name, np.float64, "cpu", margin=M, k=k,
                            brick=(bx, by), wrap=False)
        for cx, cy in itertools.product(range(mx), range(my)):
            coords = (cx * bx, cy * by)
            ins = [torch.tensor(zero_window(env[n], coords, bx, by,
                                            M or kern.pad))
                   for n in kern.in_names]
            outs = []
            for call in (fused_step_ref, fused_sweep_ref):
                out = ([torch.full_like(ins[kern.in_names.index(n)], -7.0)
                        for n in kern.written] if M else None)
                outs.append(call(kern, ins, coords, out=out))
            for a, b in zip(*outs):
                assert torch.equal(a, b), (name, k, M, coords)


# -- make on a mesh -------------------------------------------------------------

def _heat(dtype):
    T0 = heat_init((16, 12, 10)).astype(dtype)
    return lambda m, n: build_heat(m, T0, n)


def _advdiff(dtype):
    T0 = np.random.default_rng(4).uniform(0.0, 1.0, (16, 12, 8)).astype(dtype)
    return lambda m, n: build_advdiff(m, T0, n)


def _make(build, steps, **opts):
    wse, ans = build(port_core, steps)
    return wse.make(answer=ans, options=RunOptions(device="cpu", **opts))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("body", ["heat", "advdiff"])
def test_sharded_make_equals_single_device(body, k, resident, dtype):
    build = {"heat": _heat, "advdiff": _advdiff}[body](dtype)
    opts = dict(backend="pallas", time_tile=k, resident=resident)
    single = _make(build, 8, **opts)
    port_engine.reset_stats()
    port_compiler.reset_stats()
    sharded = _make(build, 8, mesh=_mesh(), **opts)
    assert sharded.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(sharded, single)
    st = port_engine.stats
    assert st.exchanges_per_step == 1 / k
    assert st.tiles_fused == (8 // k if k > 1 else 0)
    assert st.launches == 8 // k              # per plan, not per brick
    assert st.repacks == (2 if resident else 8 // k)
    assert port_compiler.stats.fallbacks == 0
    assert port_compiler.stats.kernels_built == 1   # one K1 for 4 bricks


def test_shard_map_matches_reference_jit():
    T0 = heat_init(T_SHAPE)
    wse, T = build_heat(ref_core, T0, 5)
    want = wse.make(answer=T, options=RefOptions(backend="jit"))
    got = _make(lambda m, n: build_heat(m, T0, n), 5, backend="shard_map",
                mesh=_mesh())
    assert np.abs(got - want).max() < 2e-3
    # shard_map is the jit backend on a mesh: the roll interpreter on
    # halo-padded bricks gives the single-device interpreter's bits
    np.testing.assert_array_equal(
        got, _make(lambda m, n: build_heat(m, T0, n), 5, backend="jit"))


def test_sharded_fallback_and_numpy():
    """A body refused at lowering runs on the sharded interpreter (counted,
    with its per-op exchanges); ``numpy`` drops the mesh."""
    from repro_torch.compiler import LoweringError

    build = _advdiff(np.float32)

    def refuse(loop_name):
        raise LoweringError(f"injected for {loop_name}")

    port_compiler.reset_stats()
    port_engine.reset_stats()
    prev = set_compile_hook(refuse)
    try:
        out = _make(build, 3, backend="pallas", mesh=_mesh())
    finally:
        set_compile_hook(prev)
    assert port_compiler.stats.fallbacks == 1
    assert port_engine.stats.exchanges == 3 and port_engine.stats.repacks == 3
    np.testing.assert_array_equal(out, _make(build, 3, backend="jit"))
    np.testing.assert_array_equal(
        _make(build, 3, backend="numpy", mesh=_mesh()),
        _make(build, 3, backend="numpy"))


def test_mesh_refusals():
    build = _heat(np.float32)
    wse, T = build(port_core, 2)
    prog = wse.program
    wse.__exit__()
    # a CPU mesh under the card default, and a mesh the grid does not divide
    with pytest.raises(ValueError, match="mesh's bricks are on"):
        port_engine.plan(prog, RunOptions(backend="pallas", mesh=_mesh()))
    with pytest.raises(ValueError, match="not divisible"):
        port_engine.plan(prog, RunOptions(backend="pallas", device="cpu",
                                          mesh=_mesh((3, 1))))
    wse, T = record_btcs(heat_init(T_SHAPE), OMEGA)
    with pytest.raises(ValueError, match="single-device"):
        wse.solve(T, options=RunOptions(device="cpu", mesh=_mesh(), batch=2))


@pytest.mark.parametrize("backend,k,resident", [
    ("pallas", 1, True), ("pallas", 2, True), ("pallas", 2, False),
    ("jit", 1, True)])
def test_ensemble_on_a_mesh_equals_its_single_runs(rng, backend, k, resident):
    T0 = heat_init((8, 12, 10))
    members = np.stack([T0 + rng.uniform(-5.0, 5.0, T0.shape).astype(np.float32)
                        for _ in range(3)])
    opts = RunOptions(backend=backend, time_tile=k, resident=resident,
                      device="cpu", mesh=_mesh())
    wse, T = build_heat(port_core, T0, 4)
    out = wfa.make(wfa.Ensemble(wse.program, T, overrides={"T_n": members}),
                   options=opts)
    assert out.shape == members.shape
    for b in range(3):
        wse, T = build_heat(port_core, members[b], 4)
        np.testing.assert_array_equal(out[b], wse.make(answer=T, options=opts))


def test_run_sharded_entry_point():
    T0 = heat_init(T_SHAPE)
    wse, T = build_heat(port_core, T0, 4)
    prog = wse.program
    wse.__exit__()
    want = _make(lambda m, n: build_heat(m, T0, n), 4, backend="pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = wfa.run_sharded(prog, {"T_n": T0}, _mesh(), use_pallas=True,
                              options=RunOptions(device="cpu"))
    np.testing.assert_array_equal(got["T_n"], want)
    # no mesh: the default one over the CPU, one brick
    got = wfa.run_sharded(prog, {"T_n": T0},
                          options=RunOptions(backend="pallas", device="cpu"))
    np.testing.assert_array_equal(got["T_n"], want)


# -- solves on a mesh -----------------------------------------------------------

@pytest.mark.parametrize("method,tol,maxiter", [
    ("cg", 1e-4, 200), ("pipecg", 1e-4, 200), ("chebyshev", 1e-4, 60),
    ("jacobi", 5e-3, 60), ("bicgstab", 1e-4, 200)])
def test_sharded_solve_matches_single_device(method, tol, maxiter):
    T0 = heat_init(T_SHAPE)
    out = {}
    for mesh in (None, _mesh()):
        wse, T = record_btcs(T0, OMEGA)
        out[mesh is None] = wse.solve(
            T, method=method, tol=tol, maxiter=maxiter, steps=2,
            options=RunOptions(backend="pallas", device="cpu", mesh=mesh),
            return_info=True)
    (x1, i1), (x4, i4) = out[True], out[False]
    assert x4.shape == T0.shape and x4.dtype == np.float32
    assert np.abs(x4.astype(np.float64) - x1).max() < 2e-4
    assert list(i4.outcomes) == list(i1.outcomes) == ["CONVERGED"] * 2


def test_sharded_multigrid_matches_single_device():
    rng = np.random.default_rng(0)
    shape = (16, 16, 12)
    F = np.zeros(shape, np.float32)
    F[1:-1, 1:-1, 1:-1] = rng.normal(size=(14, 14, 10)).astype(np.float32)
    out = {}
    for key, kw in (("mg", dict(method="mg", tol=1e-5, maxiter=50)),
                    ("pcg", dict(method="cg", precondition="mg", tol=1e-6,
                                 maxiter=100))):
        for mesh in (None, _mesh()):
            out[key, mesh is None] = wfa.solve(
                poisson_program(shape, rhs=F), "T", return_info=True,
                options=RunOptions(backend="pallas", device="cpu", mesh=mesh),
                **kw)
    (a, ia), (b, ib) = out["mg", True], out["mg", False]
    assert np.abs(a - b).max() < 1e-5
    assert ia.iterations[0] == ib.iterations[0]
    (c, ic), (d, idd) = out["pcg", True], out["pcg", False]
    assert np.abs(c - d).max() < 1e-4
    assert abs(int(ic.iterations[0]) - int(idd.iterations[0])) <= 1
    assert list(ib.outcomes) == list(idd.outcomes) == ["CONVERGED"]


@pytest.mark.parametrize("method", ["cg", "pipecg", "chebyshev"])
def test_make_sharded_implicit_matches_reference_btcs(method):
    T0 = np.ones(T_SHAPE, np.float32) * 500.0
    T0[1:-1, 1:-1, 0] = 300.0
    T0[1:-1, 1:-1, -1] = 400.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref, _ = ref_implicit.btcs_solve(jnp.asarray(T0), OMEGA, 2,
                                         method="cg", tol=1e-7, maxiter=400)
        for kernel in (False, True):
            step, sh = implicit.make_sharded_implicit(
                _mesh(), T0.shape, OMEGA, method=method, tol=1e-6,
                maxiter=200, steps=2, use_kernel=kernel)
            got = device_get(step(T0))
            assert np.abs(got - np.asarray(ref)).max() < 5e-3, (method, kernel)


# -- against the reference's 4-device run ---------------------------------------

REF_SCRIPT = """
import sys, warnings
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
warnings.simplefilter("ignore")
sys.path.insert(0, {tests!r})
import repro.core as rc
from repro.core.halo import run_sharded
from repro.core.jaxcompat import make_mesh
from repro.solver import btcs_program, solve
from test_torch_sharding import case_inputs
from test_torch_program import build_heat, build_wide
assert len(jax.devices()) == 4
mesh = make_mesh((2, 2), ("data", "model"))
out = {{}}
for key, (body, dtype, env) in case_inputs().items():
    wse, ans = body(rc)
    out[key] = run_sharded(wse.program, env, mesh, use_pallas="pallas" in key,
                           time_tile=2)[ans.name]
    wse.__exit__()
T0 = case_inputs()["heat_pallas_float32"][2]["T_n"][:8]
x = solve(btcs_program(T0.shape, {omega}, init_data=T0), "T", method="cg",
          backend="pallas", mesh=mesh, steps=2, tol=1e-4, maxiter=200)
out["solve_cg"] = np.asarray(x)
np.savez({path!r}, **out)
"""


def case_inputs():
    """key -> (record(module) -> (wse, answer), dtype, env) of the runs the
    reference makes on 4 devices: heat and a halo-2 body at f32 and f64, on
    both backends, 6 steps at time_tile 2."""
    cases = {}
    for dtype in (np.float32, np.float64):
        T0 = heat_init((16, 12, 10)).astype(dtype)
        rng = np.random.default_rng(3)
        P0 = rng.uniform(0.0, 1.0, (16, 12, 9)).astype(dtype)
        Q0 = rng.uniform(0.0, 0.1, (16, 12, 7)).astype(dtype)
        R0 = rng.uniform(0.0, 1.0, (16, 12, 9)).astype(dtype)
        for backend in ("pallas", "jit"):
            name = np.dtype(dtype).name
            cases[f"heat_{backend}_{name}"] = (
                lambda m, T0=T0: build_heat(m, T0, 6), dtype, {"T_n": T0})
            cases[f"wide_{backend}_{name}"] = (
                lambda m, P0=P0, Q0=Q0, R0=R0: build_wide(m, P0, Q0, R0, 6),
                dtype, {"P": P0, "Q": Q0, "R": R0})
    return cases


def test_sharded_runs_match_reference_on_4_devices(tmp_path):
    path = str(tmp_path / "ref.npz")
    code = REF_SCRIPT.format(tests=os.path.join(ROOT, "tests"), omega=OMEGA,
                             path=path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_max_isa=SSE4_2")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = np.load(path)
    mesh = _mesh()
    for key, (body, dtype, env) in case_inputs().items():
        wse, ans = body(port_core)
        backend = "pallas" if "pallas" in key else "jit"
        with wse:
            got = wfa.run_sharded(wse.program, env, mesh, options=RunOptions(
                backend=backend, time_tile=2, device="cpu"))[ans.name]
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, ref[key], err_msg=key)
    T0 = case_inputs()["heat_pallas_float32"][2]["T_n"][:8]
    wse, T = record_btcs(T0, OMEGA)
    x = wse.solve(T, method="cg", steps=2, tol=1e-4, maxiter=200,
                  options=RunOptions(backend="pallas", device="cpu",
                                     mesh=mesh))
    assert np.abs(x - ref["solve_cg"]).max() < 2e-4
