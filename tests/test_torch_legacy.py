"""The port's legacy brick drivers and their kernels K5–K7 vs the JAX
reference, on the CPU.

The same NumPy inputs, made from a seed, go through ``repro`` and
``repro_torch``; the port runs on CPU meshes (``make_mesh(...,
device="cpu")``), where K5–K7 run as their plain versions.  Every exchange
check runs a random field as well as the heat field: the heat field is
uniform in x and y away from the Moat, so swapped or misplaced halo planes
would not show on it alone.

Tolerances, and why:

* the plain versions of K5–K7 equal the reference's ``repro.kernels.ref``
  oracles bit for bit under ``jax.disable_jit()`` (every op rounds on its
  own on both sides), and lie within 2 ulp of the larger addend of
  ``c_diag·c + c_off·Σ6`` of the reference's Pallas kernels in interpret
  mode (compiled XLA contracts a·b + c into an FMA, which skips one
  product's rounding; the ulp of the result alone is no bound where the
  two addends cancel);
* K5's dot: within ``1e-5·Σ|c·Ap|`` (float32) / ``1e-13·Σ|c·Ap|``
  (float64) of the same dot evaluated in float64 — the two sum in other
  orders;
* ``halo_pad`` and every ``make_sharded_ftcs`` variant, on 1×1 and 2×2
  meshes, agree bit for bit inside the port (one association everywhere);
  against the reference's compiled steps within 2 float32 ulp of the
  field's magnitude per step (FMA contraction), in process on one device
  and, in a subprocess, on a 2×2 mesh of 4 fake devices;
* ``make_sharded_iteration``: within 4 float32 ulp of the field per
  iteration for the vectors, and a relative 1e-4 for the recurrence
  scalars (the dots sum in other orders; with 5 iterations of ~1000-term
  float32 sums that is far above the drift and far below a wrong
  iteration); chebyshev's kernel and plain runs are bitwise equal;
* ``btcs_solve``: the tolerances of ``tests/test_solvers.py`` against the
  dense solution and against the reference, iteration counts within ±1.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from conftest import heat_init
from repro.core import explicit as ref_explicit
from repro.core import implicit as ref_implicit
from repro.core.jaxcompat import make_mesh as ref_make_mesh
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import explicit, implicit
from repro_torch.core.halo import default_mesh2d, halo_pad
from repro_torch.core.mesh import device_get, device_put, make_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.spmv import spmv_dot_ref
from repro_torch.kernels.stencil7 import affine_stencil_ref, stencil_planes_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA = 0.1
SHAPE = (8, 12, 10)
#: the shapes of tests/test_kernels.py (brick extents; padded is +2 in x, y)
KERNEL_SHAPES = [(4, 4, 4), (6, 10, 5), (3, 7, 9), (7, 130, 12)]
DOT_REL = {np.float32: 1e-5, np.float64: 1e-13}
#: (name, make_sharded_ftcs keywords, calls per run of STEPS steps)
STEPS = 6
VARIANTS = [("base", {}, STEPS), ("overlap", dict(overlap=True), STEPS),
            ("wide", dict(halo_depth=3), STEPS // 3),
            ("kernel", dict(use_kernel=True), STEPS),
            ("planes", dict(use_kernel="planes"), STEPS)]


def _ulp(a) -> float:
    return float(np.spacing(np.float32(np.abs(a).max())))


def _field(kind: str, shape=SHAPE, seed=0, dtype=np.float32):
    """The heat field, or a random field with the same Moat scale."""
    if kind == "heat":
        return heat_init(shape).astype(dtype)
    return np.random.default_rng(seed).uniform(300.0, 500.0, shape).astype(dtype)


def _padded(rng, shape, dtype):
    bx, by, nz = shape
    return rng.normal(size=(bx + 2, by + 2, nz)).astype(dtype)


def _planes(rng, T):
    bx, by, nz = T.shape
    return [rng.normal(size=s).astype(T.dtype)
            for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]


# -- the plain versions of K5, K6, K7 ----------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_kernels_bitwise_vs_reference_oracles(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    P = _padded(rng, shape, dtype)
    T = rng.normal(size=shape).astype(dtype)
    planes = _planes(rng, T)
    coords, nx, ny = (1, 0), 2 * shape[0], 3 * shape[1]
    with jax.enable_x64(dtype == np.float64), jax.disable_jit():
        want6 = np.asarray(ref_oracles.affine_stencil_ref(jnp.asarray(P), 0.4, 0.1))
        want5, _ = ref_oracles.spmv_dot_ref(jnp.asarray(P), 1.0, -0.0625)
        want7 = np.asarray(ref_oracles.stencil_planes_ref(
            jnp.asarray(T), *map(jnp.asarray, planes),
            np.array([coords], np.int32), 0.4, 0.1, nx, ny))
    Pt = torch.from_numpy(P)
    got5, dot5 = spmv_dot_ref(Pt, 1.0, -0.0625)
    got7 = stencil_planes_ref(torch.from_numpy(T), *map(torch.from_numpy, planes),
                              coords, 0.4, 0.1, nx, ny)
    assert np.array_equal(affine_stencil_ref(Pt, 0.4, 0.1).numpy(), want6)
    assert np.array_equal(got5.numpy(), np.asarray(want5))
    assert np.array_equal(got7.numpy(), want7)
    # K5's dot over the unmasked Ap, in promote(dtype, float32)
    c = P[1:-1, 1:-1].astype(np.float64)
    exact = float((c * got5.numpy()).sum())
    scale = float(np.abs(c * got5.numpy()).sum())
    assert dot5.dtype == torch.promote_types(Pt.dtype, torch.float32)
    assert abs(float(dot5) - exact) <= DOT_REL[dtype] * scale


def _addend_ulp(P, c_diag, c_off):
    """Per cell of the padded brick ``P``: the float32 ulp of the larger
    addend of ``c_diag·c + c_off·Σ6`` — an FMA skips the product's rounding,
    at most an ulp of that addend."""
    P = P.astype(np.float64)
    c = P[1:-1, 1:-1]
    zp = np.concatenate([c[:, :, 1:], c[:, :, -1:]], axis=2)
    zm = np.concatenate([c[:, :, :1], c[:, :, :-1]], axis=2)
    s = sum(np.abs(a) for a in (P[:-2, 1:-1], P[2:, 1:-1], P[1:-1, :-2],
                                P[1:-1, 2:], zp, zm))
    return np.spacing(np.maximum(abs(c_diag) * np.abs(c),
                                 abs(c_off) * s).astype(np.float32))


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_kernels_within_2ulp_of_interpret_pallas(shape):
    rng = np.random.default_rng(7 + sum(shape))
    P = _padded(rng, shape, np.float32)
    T = rng.normal(size=shape).astype(np.float32)
    planes = _planes(rng, T)
    coords, nx, ny = (0, 1), shape[0], 2 * shape[1]
    # the planes' padded assembly (zero corners), for the addend scale
    PT = np.pad(np.concatenate([planes[0], T, planes[1]]), ((0, 0), (1, 1), (0, 0)))
    PT[1:-1, :1], PT[1:-1, -1:] = planes[2], planes[3]
    refs = {
        "stencil7": np.asarray(ref_ops.stencil7(jnp.asarray(P), 0.4, 0.1)),
        "spmv": np.asarray(ref_ops.spmv_hex_dot(jnp.asarray(P), 1.0, -0.0625)[0]),
        "planes": np.asarray(ref_ops.stencil7_planes(
            jnp.asarray(T), *map(jnp.asarray, planes),
            jnp.asarray([coords], jnp.int32), 0.4, 0.1, nx, ny)),
    }
    Pt = torch.from_numpy(P)
    ports = {
        "stencil7": ops.stencil7(Pt, 0.4, 0.1).numpy(),
        "spmv": ops.spmv_hex(Pt, 1.0, -0.0625).numpy(),
        "planes": ops.stencil7_planes(torch.from_numpy(T),
                                      *map(torch.from_numpy, planes), coords,
                                      0.4, 0.1, nx, ny).numpy(),
    }
    ulps = {"stencil7": _addend_ulp(P, 0.4, 0.1),
            "spmv": _addend_ulp(P, 1.0, -0.0625),
            "planes": _addend_ulp(PT, 0.4, 0.1)}
    for key, want in refs.items():
        assert (np.abs(ports[key] - want) <= 2 * ulps[key]).all(), key


def test_spmv_hex_dot_matches_reference_dot():
    rng = np.random.default_rng(11)
    P = _padded(rng, (6, 10, 5), np.float32)
    _, want = ref_ops.spmv_hex_dot(jnp.asarray(P), 1.0, -0.0625)
    av, got = ops.spmv_hex_dot(torch.from_numpy(P), 1.0, -0.0625)
    scale = float(np.abs(P[1:-1, 1:-1].astype(np.float64) * av.numpy()).sum())
    assert abs(float(got) - float(want)) <= 2 * DOT_REL[np.float32] * scale


# -- halo exchange --------------------------------------------------------------

@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("kind", ["heat", "random"])
def test_halo_pad_2x2_matches_numpy_assembly(h, kind):
    """Every padded brick equals the zero-padded global field's window:
    neighbours' planes and corners in place, zeros outside the domain."""
    G = _field(kind)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    x = device_put(G, explicit.make_sharded_ftcs(mesh, G.shape, OMEGA)[1])
    Gp = np.pad(G, ((h, h), (h, h), (0, 0)))
    bx, by = G.shape[0] // 2, G.shape[1] // 2
    for b, P in enumerate(halo_pad(x.bricks, h, mesh)):
        cx, cy = mesh.coords(b)
        want = Gp[cx * bx:cx * bx + bx + 2 * h, cy * by:cy * by + by + 2 * h]
        assert np.array_equal(P.numpy(), want), (b, h)


def test_mesh_round_trip_and_state_conversion():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    _, sharding = explicit.make_sharded_ftcs(mesh, SHAPE, OMEGA)
    G = _field("random")
    x = device_put(G, sharding)
    assert x.shape == SHAPE and len(x.bricks) == 4
    assert np.array_equal(device_get(x), G)
    state = state_from_numpy((G, G * 2, np.float32(3.0)), sharding)
    back = state_to_numpy(state)
    assert np.array_equal(back[1], G * 2) and back[2] == np.float32(3.0)
    assert state[2].ndim == 0 and state[2].dtype == torch.float32


# -- make_sharded_ftcs ----------------------------------------------------------

def _port_ftcs(G, mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for name, kw, calls in VARIANTS:
        step, sharding = explicit.make_sharded_ftcs(
            mesh, G.shape, OMEGA, steps_per_call=calls, **kw)
        out[name] = device_get(step(device_put(G, sharding)))
    return out


@pytest.mark.parametrize("kind", ["heat", "random"])
def test_sharded_ftcs_variants_and_meshes_bitwise(kind):
    G = _field(kind)
    one = _port_ftcs(G, (1, 1))
    two = _port_ftcs(G, (2, 2))
    base = one["base"]
    assert not np.array_equal(base, G)
    for name in one:
        assert np.array_equal(one[name], base), name
        assert np.array_equal(two[name], base), name
    # float64 too
    G64 = G.astype(np.float64)
    one64, two64 = _port_ftcs(G64, (1, 1)), _port_ftcs(G64, (2, 2))
    for name in one64:
        assert np.array_equal(one64[name], one64["base"]), name
        assert np.array_equal(two64[name], one64["base"]), name


@pytest.mark.parametrize("kind", ["heat", "random"])
def test_sharded_ftcs_matches_reference_one_device(kind):
    G = _field(kind)
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    port = _port_ftcs(G, (1, 1))
    tol = 2 * STEPS * _ulp(G)
    for name, kw, calls in VARIANTS:
        step, sh = ref_explicit.make_sharded_ftcs(mesh, G.shape, OMEGA,
                                                  steps_per_call=calls, **kw)
        want = np.asarray(jax.device_get(step(jax.device_put(jnp.asarray(G), sh))))
        assert np.abs(port[name] - want).max() <= tol, name


def test_sharded_ftcs_2x2_matches_reference_on_4_devices(tmp_path):
    """The reference's 2×2 mesh of 4 fake CPU devices (a subprocess, as
    tests/test_sharded.py runs it) against the port's 2×2 CPU mesh, on a
    random field."""
    G = _field("random", seed=5)
    np.save(tmp_path / "G.npy", G)
    code = f"""
import jax, jax.numpy as jnp, numpy as np
from repro.core.jaxcompat import make_mesh
from repro.core.explicit import make_sharded_ftcs
mesh = make_mesh((2, 2), ("data", "model"))
G = np.load({str(tmp_path / "G.npy")!r})
out = {{}}
for name, kw, calls in {VARIANTS!r}:
    step, sh = make_sharded_ftcs(mesh, G.shape, {OMEGA}, steps_per_call=calls, **kw)
    out[name] = np.asarray(jax.device_get(step(jax.device_put(jnp.asarray(G), sh))))
np.savez({str(tmp_path / "ref.npz")!r}, **out)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    ref = np.load(tmp_path / "ref.npz")
    port = _port_ftcs(G, (2, 2))
    tol = 2 * STEPS * _ulp(G)
    for name, _, _ in VARIANTS:
        assert np.abs(port[name] - ref[name]).max() <= tol, name


@pytest.mark.parametrize("kind", ["heat", "random"])
def test_ftcs_solve_matches_reference(kind):
    G = _field(kind)
    tol = 2 * STEPS * _ulp(G)
    got = explicit.ftcs_solve(torch.from_numpy(G), OMEGA, STEPS).numpy()
    repack = explicit.ftcs_solve_repack(torch.from_numpy(G), OMEGA, STEPS).numpy()
    assert np.abs(got - np.asarray(ref_explicit.ftcs_solve(
        jnp.asarray(G), OMEGA, STEPS))).max() <= tol
    assert np.abs(repack - np.asarray(ref_explicit.ftcs_solve_repack(
        jnp.asarray(G), OMEGA, STEPS))).max() <= tol
    # the sharded drivers sum in another order: equal to rounding
    assert np.abs(got - _port_ftcs(G, (1, 1))["base"]).max() <= STEPS * _ulp(G)


# -- make_sharded_iteration ---------------------------------------------------

def _apply_np(x, w):
    """The BTCS operator in float64 by plain slicing: A = I − ωψ·S on the
    interior, identity on the Moat."""
    wpsi = w / (1.0 + 6.0 * w)
    Ax = x.copy()
    c = (slice(1, -1),) * 3
    s = 0.0
    for ax in range(3):
        lo, hi = list(c), list(c)
        lo[ax], hi[ax] = slice(0, -2), slice(2, None)
        s = s + x[tuple(lo)] + x[tuple(hi)]
    Ax[c] = x[c] - wpsi * s
    return Ax


def _initial_state(method, x0):
    """A seeded iteration state in float64, rounded to float32: the start
    of the method on ``A x = b`` with ``b = rhs(x0)``."""
    x = x0.astype(np.float64)
    b = x.copy()
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * OMEGA)
    r = b - _apply_np(x, OMEGA)
    f32 = lambda *a: tuple(np.asarray(v, np.float32) for v in a)  # noqa: E731
    if method == "cg":
        return f32(x, r, r, (r * r).sum())
    if method == "pipecg":
        z = np.zeros_like(x)
        return f32(x, r, _apply_np(r, OMEGA), z, z, z, 1e30, 1.0)
    lmin, lmax = 0.625, 1.375
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    d = r / theta
    return f32(x + d, r, d, delta / theta)


def _run_port_iteration(method, use_kernel, state, mesh_shape, n):
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    step, specs = implicit.make_sharded_iteration(mesh, state[0].shape, OMEGA,
                                                  method=method,
                                                  use_kernel=use_kernel)
    s = state_from_numpy(state, specs[0].sharding)
    for _ in range(n):
        s = step(s)
    return state_to_numpy(s)


def _run_ref_iteration(method, use_kernel, state, n):
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    step, sds = ref_implicit.make_sharded_iteration(mesh, state[0].shape, OMEGA,
                                                    method=method,
                                                    use_kernel=use_kernel)
    s = tuple(jax.device_put(jnp.asarray(a), d.sharding) if a.ndim == 3
              else jnp.asarray(a) for a, d in zip(state, sds))
    for _ in range(n):
        s = step(s)
    return tuple(np.asarray(jax.device_get(a)) for a in s)


def _assert_state_close(got, want, n, field):
    tol = 4 * n * _ulp(field)
    for g, w in zip(got, want):
        if g.ndim:
            assert np.abs(g - w).max() <= tol
        else:
            assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["cg", "pipecg", "chebyshev"])
def test_sharded_iteration_matches_reference(method, use_kernel):
    n = 5
    x0 = _field("random", seed=3)
    state = _initial_state(method, x0)
    got = _run_port_iteration(method, use_kernel, state, (1, 1), n)
    want = _run_ref_iteration(method, use_kernel, state, n)
    _assert_state_close(got, want, n, x0)
    # the 2×2 mesh sums its dots in another order; the plain chebyshev
    # iteration has no dot and equals its kernel run bit for bit
    two = _run_port_iteration(method, use_kernel, state, (2, 2), n)
    _assert_state_close(two, got, n, x0)
    if method == "chebyshev":
        other = _run_port_iteration(method, not use_kernel, state, (1, 1), n)
        assert all(np.array_equal(a, b) for a, b in zip(got, other))
        assert all(np.array_equal(a, b) for a, b in zip(two, got))


# -- btcs_solve -----------------------------------------------------------------

def _dense_btcs(T0, w):
    """The dense solution of tests/test_solvers.py::_dense_btcs."""
    n = T0.size
    A = np.empty((n, n))
    for k in range(n):
        e = np.zeros(n)
        e[k] = 1.0
        A[:, k] = _apply_np(e.reshape(T0.shape), w).ravel()
    b = T0.astype(np.float64).copy()
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * w)
    return np.linalg.solve(A, b.reshape(n)).reshape(T0.shape)


@pytest.mark.parametrize("method,maxiter,atol", [
    ("cg", 400, 2e-4), ("pipecg", 400, 5e-3), ("chebyshev", 80, 2e-4),
    ("bicgstab", 400, 2e-4), ("jacobi", 40, 5e-4)])
def test_btcs_solve_matches_reference_and_dense(method, maxiter, atol):
    T0 = heat_init((7, 8, 9))
    dense = _dense_btcs(T0, OMEGA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, (wi, _) = ref_implicit.btcs_solve(jnp.asarray(T0), OMEGA, 1,
                                                method=method, tol=1e-7,
                                                maxiter=maxiter)
        got, (gi, res) = implicit.btcs_solve(T0, OMEGA, 1, method=method,
                                             tol=1e-7, maxiter=maxiter,
                                             device="cpu")
    got = got.numpy()
    assert np.abs(got - dense).max() <= atol
    assert np.abs(got - np.asarray(want)).max() <= atol
    assert abs(int(gi[0]) - int(np.asarray(wi)[0])) <= 1
    assert res.shape == (1,) and torch.isfinite(res).all()


def test_btcs_multistep_and_operator():
    """Two steps agree with the reference; the legacy operator is SPD on
    the interior and warns once."""
    T0 = heat_init((6, 6, 6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, _ = ref_implicit.btcs_solve(jnp.asarray(T0), OMEGA, 2, method="cg",
                                          tol=1e-7, maxiter=300)
        got, (gi, _) = implicit.btcs_solve(torch.from_numpy(T0), OMEGA, 2,
                                           method="cg", tol=1e-7, maxiter=300)
    assert gi.shape == (2,)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-4
    implicit._DEPRECATION_WARNED.discard("make_operator")
    with pytest.warns(DeprecationWarning, match="make_operator"):
        A, rhs, dot, mask = implicit.make_operator(OMEGA, (6, 7, 5), device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = torch.where(mask, torch.from_numpy(
            rng.normal(size=(6, 7, 5)).astype(np.float32)), 0.0)
        assert float(dot(x, A(x))) > 0.0
    assert implicit.chebyshev_bounds(OMEGA) == pytest.approx((0.625, 1.375))


# -- entry points -------------------------------------------------------------

def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` a mesh is built for the card, and a machine
    without one raises instead of building it on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh((2, 2), ("data", "model")),
                 lambda: default_mesh2d(),
                 lambda: implicit.btcs_solve(heat_init((5, 5, 5)), OMEGA, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_unported_entry_points_name_their_slices():
    """Every entry point is ported now: the sharded implicit shim returns a
    working step (one BTCS step on a 1×1 mesh equals the single-device
    ``btcs_solve`` to solver tolerance), and the checkpointed FTCS loop
    of the adjoint slice gives ``ftcs_solve``'s bits."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    T0 = heat_init(SHAPE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        step, sharding = implicit.make_sharded_implicit(
            mesh, SHAPE, OMEGA, tol=1e-6, maxiter=200)
        want, _ = implicit.btcs_solve(T0, OMEGA, 1, tol=1e-6, maxiter=200,
                                      device="cpu")
    got = step(device_put(T0, sharding))
    assert got.shape == SHAPE
    assert np.abs(device_get(got) - want.numpy()).max() < 5e-3
    # the adjoint slice is in: the checkpointed loop gives ftcs_solve's bits
    T0 = torch.tensor(heat_init(SHAPE))
    assert torch.equal(explicit.ftcs_solve_checkpointed(T0, OMEGA, 4),
                       explicit.ftcs_solve(T0, OMEGA, 4))
