"""The PyTorch port's reverse-mode AD on the CPU, against the JAX reference.

The port's counterpart of ``tests/test_adjoint.py``: each of its
assertions under the same name with ``_torch``, plus live reference runs.
Tolerances, and why:

* ``transpose_taps`` equals the reference's on the same groups (the same
  canonical tuples), and is an involution;
* float64 gradients through ``make_differentiable_solver`` (cg, pipecg,
  bicgstab for the state and a coefficient field, mg, cg + mg) pass
  ``tests/gradcheck.py``'s central-difference check at its float64
  tolerances (``atol`` 1e-8, ``rtol`` 1e-5, probe points mixing Moat and
  interior), and the Krylov ones agree with the reference's adjoints
  within ``1e-9·max|g|``: both solve forward and adjoint systems to an
  absolute residual of 1e-12–1e-13, so the two gradients differ by solver
  tolerance, not rounding (the multigrid ones are held to finite
  differences only: the reference's take 8 s to compile);
* the symmetric adjoint builds no kernel in the backward pass: the
  transposed group hits the forward operator's cache entry.  The port
  builds one more kernel than the reference at build time, the ``Rhs()``
  body's (which it runs on K1 forward, as ``make_solver`` does; the
  reference runs it on the roll interpreter);
* the checkpointed runner's gradient equals the all-residuals gradient
  bitwise (the recompute runs the same launches), and at k = 4 with a
  remainder the reference's within 8 f32 ulp of the gradient's scale (its
  own bound between its checkpointed and plain gradients); the forward
  equals the repacking ``make`` bitwise;
* on a 2×2 mesh: the forward bitwise the single device, the gradient
  within 4 f64 ulp of it and of the reference's sharded gradient (the
  reference runs in a subprocess on 4 fake devices with
  ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` and the mesh of
  ``repro.core.jaxcompat.make_mesh``, the only mesh its sharded gradient
  accepts on this JAX);
* ``checkpointed_vjp`` (in memory and spilled to disk) equals the plain
  VJP bitwise.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
import repro_torch.core as port_core
from conftest import heat_init
from gradcheck import assert_gradcheck, gradcheck
from repro.core import explicit as ref_explicit
from repro.engine import RunOptions as RefOptions
from repro.engine import differentiable_runner as ref_runner
from repro.engine import plan as ref_plan
from repro_torch import compiler
from repro_torch.checkpoint import CheckpointManager
from repro_torch.compiler import (LoweringError, Tap, lower_group,
                                  transpose_taps)
from repro_torch.core import explicit
from repro_torch.core.field import Field
from repro_torch.core.mesh import make_mesh
from repro_torch.core.program import ForLoop, scoped_program
from repro_torch.engine import (RunOptions, checkpointed_vjp,
                                differentiable_runner, plan, run_program)
from repro_torch.solver import (ADJOINT_METHODS, make_differentiable_solver,
                                make_solver)
from repro_torch.solver.api import _answer_name, _lower_operator, _split
from repro_torch.solver.frontend import Operator
from repro_torch.solver.presets import (_record_btcs_body,
                                        _record_poisson_body, btcs_program)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


def _lowered(program, answer="T"):
    name = _answer_name(program, answer)
    (_, op_ops), _ = _split(program, name)
    return _lower_operator(op_ops, name), name


def _canon(group):
    """A lowered group as plain tuples, comparable across the packages."""
    return (group.halo, tuple(
        (u.field, u.z0, u.zlen, u.const,
         tuple((c, tuple((t.field, t.dz, t.dx, t.dy) for t in taps))
               for c, taps in u.terms))
        for u in group.updates))


def _body_ops(m, record):
    """The ops of one recorded loop body, in package ``m``."""
    wse = m.WSE_Interface()
    record(m)
    ops = list(wse.program.ops)
    wse.__exit__()
    return ops


def _asym(m):
    T = m.WSE_Array("T", shape=(8, 8, 6))
    with m.WSE_For_Loop("t", 1):
        T[1:-1, 0, 0] = (T[1:-1, 0, 0] - 0.1 * (T[1:-1, 0, 0] - T[1:-1, -1, 0])
                         + 0.05 * (T[2:, 1, 1] - T[1:-1, 0, 0]))


def _coef_tap(m):
    T = m.WSE_Array("T", shape=(8, 8, 6))
    C = m.WSE_Array("C", shape=(8, 8, 6))
    with m.WSE_For_Loop("t", 1):
        T[1:-1, 0, 0] = T[1:-1, 0, 0] - 0.5 * C[1:-1, 0, 0] * T[2:, 0, 0]


# -- transpose_taps -----------------------------------------------------------


def test_transpose_taps_symmetric_fixed_point_torch():
    group, name = _lowered(btcs_program((8, 8, 6), 0.2))
    assert transpose_taps(group, name) == group


def test_transpose_taps_involution_nonsymmetric_torch():
    group = lower_group(_body_ops(port_core, _asym))
    t = transpose_taps(group, "T")
    assert t != group
    assert transpose_taps(t, "T") == group
    fwd = sorted(tap for u in group.updates for _, taps in u.terms
                 for tap in taps)
    bwd = sorted(Tap(tap.field, -tap.dz, -tap.dx, -tap.dy)
                 for u in t.updates for _, taps in u.terms for tap in taps)
    assert fwd == bwd


def test_transpose_taps_shifts_coefficient_taps_torch():
    group = lower_group(_body_ops(port_core, _coef_tap))
    t = transpose_taps(group, "T")
    assert transpose_taps(t, "T") == group
    (coeff, taps), = [term for u in t.updates for term in u.terms
                      if len(term[1]) == 2]
    by_field = {tap.field: tap for tap in taps}
    assert by_field["T"] == Tap("T", -1, 0, 0)
    assert by_field["C"] == Tap("C", -1, 0, 0)
    assert coeff == -0.5


@pytest.mark.parametrize("record", [_asym, _coef_tap])
def test_transpose_taps_equals_reference_torch(record):
    ours = lower_group(_body_ops(port_core, record))
    theirs = ref_compiler.lower_group(_body_ops(ref_core, record))
    assert _canon(ours) == _canon(theirs)
    assert (_canon(transpose_taps(ours, "T"))
            == _canon(ref_compiler.transpose_taps(theirs, "T")))


def test_transpose_taps_rejects_nonlinear_torch():
    def square(m):
        T = m.WSE_Array("T", shape=(8, 8, 6))
        with m.WSE_For_Loop("t", 1):
            T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[2:, 0, 0]

    group = lower_group(_body_ops(port_core, square))
    with pytest.raises(LoweringError, match="not linear in the unknown") as e:
        transpose_taps(group, "T")
    with pytest.raises(ref_compiler.LoweringError) as r:
        ref_compiler.transpose_taps(
            ref_compiler.lower_group(_body_ops(ref_core, square)), "T")
    assert str(e.value) == str(r.value)


# -- differentiable-path validation errors ------------------------------------


def test_nonaffine_operator_raises_under_grad_torch():
    with scoped_program() as prog:
        T = Field("T", shape=(8, 8, 6), dtype=np.float32)
        with Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[1:-1, 0, 0] * T[1:-1, 0, 0]
    with pytest.raises(ValueError, match="affine"):
        make_differentiable_solver(prog, "T", **CPU)


def test_nonlinear_operator_raises_under_grad_torch():
    with scoped_program() as prog:
        T = Field("T", shape=(8, 8, 6), dtype=np.float32)
        with Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[2:, 0, 0]
    with pytest.raises(ValueError, match="nonlinear"):
        make_differentiable_solver(prog, "T", **CPU)


def test_fixed_iteration_methods_rejected_torch():
    prog = btcs_program((8, 8, 6), 0.2)
    with pytest.raises(ValueError, match="chebyshev"):
        make_differentiable_solver(prog, "T", method="chebyshev", **CPU)
    assert "chebyshev" not in ADJOINT_METHODS


def test_make_solver_differentiable_rejects_batch_torch():
    prog = btcs_program((8, 8, 6), 0.2)
    with pytest.raises(ValueError, match="batch=1"):
        make_solver(prog, "T", batch=2, differentiable=True, **CPU)


def test_solve_differentiable_rejects_mesh_torch():
    from repro_torch.solver import solve

    prog = btcs_program((8, 8, 6), 0.2)
    with pytest.raises(ValueError, match="single-device"):
        solve(prog, "T", options=RunOptions(
            differentiable=True, mesh=make_mesh((2, 2), device="cpu"), **CPU))


@pytest.mark.parametrize("backend", ["jit", "pallas"])
@pytest.mark.parametrize("method", ["cg", "pipecg", "bicgstab"])
def test_solve_differentiable_route_matches_default_torch(method, backend):
    """options.differentiable=True must not change eager solve() numerics
    (bitwise: the same compiled steps and dots)."""
    from repro_torch.solver import record_btcs, solve

    T0 = heat_init((10, 10, 6))
    outs = []
    for diff in (False, True):
        wse, T = record_btcs(T0, 0.2)
        outs.append(solve(wse.program, T, method=method, tol=1e-6,
                          options=RunOptions(backend=backend,
                                             differentiable=diff, **CPU)))
    assert (outs[0] == outs[1]).all()


# -- gradients (float64) against finite differences and the reference --------

#: the systems of the reference's gradient checks
BTCS_SHAPE, MG_SHAPE = (10, 12, 6), (12, 12, 8)


def adjoint_inputs():
    """The seeded float64 inputs of every gradient case (shared with the
    reference's subprocess)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=BTCS_SHAPE)
    x0 = rng.normal(size=BTCS_SHAPE)
    C0 = 0.4 + 0.2 * rng.random(BTCS_SHAPE)
    F0 = rng.normal(size=MG_SHAPE)
    wm = rng.normal(size=MG_SHAPE)
    xm = rng.normal(size=MG_SHAPE)
    T0 = rng.normal(size=(12, 8, 6))
    wh = rng.normal(size=(12, 8, 6))
    return dict(w=w, x0=x0, C0=C0, F0=F0, wm=wm, xm=xm, T0=T0, wh=wh)


def btcs_prog(m_field=Field, m_scoped=scoped_program,
              record=_record_btcs_body):
    with m_scoped() as prog:
        T = m_field("T", shape=BTCS_SHAPE, dtype=np.float64)
        record(T, 0.3)
    return prog


def varcoef_prog(m_field, m_scoped, m_operator, C0):
    with m_scoped() as prog:
        T = m_field("T", shape=BTCS_SHAPE, dtype=np.float64)
        C = m_field("C", shape=BTCS_SHAPE, dtype=np.float64, init_data=C0)
        with m_operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] + 0.2 * C[1:-1, 0, 0] * (
                6.0 * T[1:-1, 0, 0]
                - (T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                   + T[1:-1, -1, 0] + T[1:-1, 0, 1] + T[1:-1, 0, -1]))
    return prog


def heat_prog(T0, steps, m_field=Field, m_scoped=scoped_program,
              m_loop=ForLoop):
    with m_scoped() as prog:
        T = m_field("T", init_data=T0, dtype=T0.dtype)
        with m_loop("t", steps):
            T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                + T[1:-1, -1, 0] + T[1:-1, 0, 1] + T[1:-1, 0, -1])
    return prog


REF_SCRIPT = """
import sys
sys.path.insert(0, {tests!r})
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.field import Field
from repro.core.jaxcompat import make_mesh
from repro.core.program import ForLoop, scoped_program
from repro.engine import RunOptions, differentiable_runner, plan
from repro.solver import make_differentiable_solver
from repro.solver.frontend import Operator
from repro.solver.presets import _record_btcs_body
from test_torch_adjoint import adjoint_inputs, btcs_prog, heat_prog, varcoef_prog
assert len(jax.devices()) == 4
d = adjoint_inputs()
w, x0 = jnp.asarray(d["w"]), jnp.asarray(d["x0"])
out = {{}}
for method in ("cg", "pipecg"):
    s = make_differentiable_solver(
        btcs_prog(Field, scoped_program, _record_btcs_body), "T",
        method=method, tol=1e-12, maxiter=400)
    out[method] = jax.grad(lambda v: jnp.sum(w * s(v)))(x0)
s = make_differentiable_solver(
    varcoef_prog(Field, scoped_program, Operator, d["C0"]), "T",
    method="bicgstab", tol=1e-13, maxiter=600)
C0 = jnp.asarray(d["C0"])
out["bicgstab_C"] = jax.grad(lambda c: jnp.sum(w * s(x0, {{"C": c}})))(C0)
out["bicgstab_x"] = jax.grad(lambda v: jnp.sum(w * s(v, {{"C": C0}})))(x0)
mesh = make_mesh((2, 2), ("x", "y"))
opts = RunOptions(backend="pallas", differentiable=True)
run = differentiable_runner(plan(heat_prog(d["T0"], 9, Field, scoped_program,
                                          ForLoop), options=opts.replace(mesh=mesh)))
env0 = {{"T": jnp.asarray(d["T0"])}}
wh = jnp.asarray(d["wh"])
out["sharded_out"] = run(env0)["T"]
out["sharded_grad"] = jax.grad(lambda e: jnp.sum(wh * run(e)["T"]))(env0)["T"]
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""


@pytest.fixture(scope="module")
def ref_grads(tmp_path_factory):
    """The reference's float64 gradients of every case, from one
    subprocess (x64, 4 fake devices, no FMA contraction)."""
    path = str(tmp_path_factory.mktemp("adjoint") / "ref.npz")
    code = REF_SCRIPT.format(tests=os.path.join(ROOT, "tests"), path=path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_max_isa=SSE4_2")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


def _grad(f, x):
    """d(sum)/dx of a scalar torch function at the float64 array ``x``."""
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(f(xt), xt)
    return g.numpy()


def _close_to_reference(g, want):
    assert np.abs(g - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("method", ["cg", "pipecg"])
def test_gradcheck_symmetric_methods_reuse_forward_kernel_torch(method,
                                                                ref_grads):
    """CG and PipeCG VJPs match FD at fp64 and the reference's adjoint;
    the backward solve builds no kernel (the transposed group is the
    forward's cache entry)."""
    d = adjoint_inputs()
    w = torch.tensor(d["w"])
    compiler.clear_cache()
    compiler.reset_stats()
    s = make_differentiable_solver(
        btcs_prog(), "T", method=method, tol=1e-12,
        maxiter=400, **CPU)
    assert s.symmetric_adjoint
    # the operator (forward = adjoint) and the Rhs() body: two builds,
    # and the transposed operator's compile was a cache hit
    assert compiler.stats.kernels_built == 2, compiler.stats
    assert compiler.stats.cache_hits >= 1
    loss = lambda v: torch.sum(w * s(v))  # noqa: E731
    g = _grad(loss, d["x0"])
    assert compiler.stats.kernels_built == 2
    assert compiler.stats.fallbacks == 0
    r = gradcheck(lambda v: loss(torch.tensor(v)).item(), d["x0"], g,
                  n_probes=8)
    assert r.ok, (method, str(r))
    _close_to_reference(g, ref_grads[method])


def test_gradcheck_bicgstab_coefficient_and_state_torch(ref_grads):
    """Non-symmetric variable-coefficient diffusion: the adjoint lowers the
    transposed tap set into ONE extra kernel, and both the coefficient and
    state gradients match FD at fp64 and the reference's adjoint."""
    d = adjoint_inputs()
    w, x0, C0 = (torch.tensor(d[k]) for k in ("w", "x0", "C0"))
    compiler.clear_cache()
    compiler.reset_stats()
    s = make_differentiable_solver(
        varcoef_prog(Field, scoped_program, Operator, d["C0"]), "T",
        method="bicgstab", tol=1e-13, maxiter=600, **CPU)
    assert not s.symmetric_adjoint
    assert compiler.stats.kernels_built == 2  # forward + transposed
    loss_C = lambda c: torch.sum(w * s(x0, {"C": c}))  # noqa: E731
    g_C = _grad(loss_C, d["C0"])
    assert compiler.stats.kernels_built == 2  # grad reuses both kernels
    r = gradcheck(lambda c: loss_C(torch.tensor(c)).item(), d["C0"], g_C,
                  n_probes=8)
    assert r.ok, str(r)
    loss_x = lambda v: torch.sum(w * s(v, {"C": C0}))  # noqa: E731
    g_x = _grad(loss_x, d["x0"])
    r2 = gradcheck(lambda v: loss_x(torch.tensor(v)).item(), d["x0"], g_x,
                   n_probes=8)
    assert r2.ok, str(r2)
    assert compiler.stats.fallbacks == 0
    _close_to_reference(g_C, ref_grads["bicgstab_C"])
    _close_to_reference(g_x, ref_grads["bicgstab_x"])


@pytest.mark.parametrize("method,precond", [("mg", None), ("cg", "mg")])
def test_gradcheck_multigrid_methods_torch(method, precond):
    """method='mg' and mg-preconditioned CG differentiate through the same
    cycle machinery (symmetric — reused verbatim in the backward solve)."""
    d = adjoint_inputs()
    with scoped_program() as prog:
        T = Field("T", shape=MG_SHAPE, dtype=np.float64)
        Ff = Field("T_rhs", shape=MG_SHAPE, dtype=np.float64,
                   init_data=d["F0"])
        _record_poisson_body(T, Ff)
    compiler.clear_cache()
    compiler.reset_stats()
    s = make_differentiable_solver(prog, "T", method=method,
                                   precondition=precond, tol=1e-13,
                                   maxiter=400, **CPU)
    assert s.symmetric_adjoint
    built = compiler.stats.kernels_built
    wm, xm = torch.tensor(d["wm"]), torch.tensor(d["xm"])
    loss = lambda f: torch.sum(wm * s(xm, {"T_rhs": f}))  # noqa: E731
    g = _grad(loss, d["F0"])
    assert compiler.stats.kernels_built == built, method
    r = gradcheck(lambda f: loss(torch.tensor(f)).item(), d["F0"], g,
                  n_probes=4)
    assert r.ok, (method, precond, str(r))
    assert compiler.stats.fallbacks == 0


@pytest.mark.parametrize("system", ["btcs_cg", "varcoef_bicgstab"])
def test_jit_backend_adjoint_matches_pallas_torch(system):
    """``backend="jit"`` differentiates through the roll interpreter and
    the interpreter's transposed operator (``_masked_group_step``): its
    gradients (state and coefficient) equal the ``pallas`` ones within
    solver tolerance."""
    d = adjoint_inputs()
    w, x0, C0 = (torch.tensor(d[k]) for k in ("w", "x0", "C0"))
    grads = {}
    for backend in ("jit", "pallas"):
        if system == "btcs_cg":
            s = make_differentiable_solver(btcs_prog(), "T", method="cg",
                                           backend=backend, tol=1e-12,
                                           maxiter=400, **CPU)
            coef = {}
        else:
            s = make_differentiable_solver(
                varcoef_prog(Field, scoped_program, Operator, d["C0"]), "T",
                method="bicgstab", backend=backend, tol=1e-13, maxiter=600,
                **CPU)
            coef = {"C": C0}
            grads[backend, "C"] = _grad(
                lambda c: torch.sum(w * s(x0, {"C": c})), d["C0"])
        grads[backend, "x"] = _grad(lambda v: torch.sum(w * s(v, coef)),
                                    d["x0"])
    for (backend, wrt), g in grads.items():
        if backend == "jit":
            _close_to_reference(g, grads["pallas", wrt])


def test_make_solver_differentiable_steps_torch():
    """make_solver(differentiable=True) over two implicit steps: the same
    (x, (iters, res, outcomes)) as the plain solver, bitwise, and a
    gradient that passes the FD check."""
    d = adjoint_inputs()
    prog = btcs_prog()
    plain = make_solver(prog, "T", method="cg", tol=1e-12, maxiter=400,
                        steps=2, **CPU)
    diff = make_solver(prog, "T", method="cg", tol=1e-12, maxiter=400,
                       steps=2, differentiable=True, **CPU)
    assert diff.symmetric_adjoint
    x1, aux1 = plain(d["x0"])
    x2, aux2 = diff(d["x0"])
    assert torch.equal(x1, x2.detach())
    for a, b in zip(aux1, aux2):
        assert np.array_equal(a, b)
    w = torch.tensor(d["w"])
    loss = lambda v: torch.sum(w * diff(v)[0])  # noqa: E731
    g = _grad(loss, d["x0"])
    assert_gradcheck(lambda v: loss(torch.tensor(v)).item(), d["x0"], g,
                     n_probes=6)


# -- checkpointed reverse stepping --------------------------------------------


def _runner_grad(T0, w, steps, time_tile, checkpoint, chunk_steps=None,
                 mesh=None):
    p = plan(heat_prog(T0, steps), RunOptions(
        backend="pallas", differentiable=True, time_tile=time_tile,
        mesh=mesh, **CPU))
    run = differentiable_runner(p, checkpoint=checkpoint,
                                chunk_steps=chunk_steps)
    x = torch.tensor(T0, requires_grad=True)
    out = run({"T": x})["T"]
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(w) * out), x)
    return out.detach().numpy(), g.numpy()


def _ref_runner_grad(T0, w, steps, time_tile):
    p = ref_plan(heat_prog(T0, steps, ref_core.Field,
                           ref_core.program.scoped_program,
                           ref_core.ForLoop),
                 options=RefOptions(backend="pallas", differentiable=True,
                                    time_tile=time_tile))
    run = ref_runner(p)
    loss = lambda env: jnp.sum(jnp.asarray(w) * run(env)["T"])  # noqa: E731
    return np.asarray(jax.grad(loss)({"T": jnp.asarray(T0)})["T"])


def _assert_ulp_close(a, b, ulps=4.0):
    scale = max(np.abs(a).max(), np.abs(b).max())
    tol = ulps * scale * np.finfo(a.dtype).eps
    assert np.abs(a - b).max() <= tol, (
        np.abs(a - b).max() / (scale * np.finfo(a.dtype).eps))


@pytest.mark.parametrize("time_tile,steps", [(1, 9), (2, 13), (4, 13), (4, 16)])
def test_checkpointed_runner_grad_matches_reference_torch(rng, time_tile,
                                                          steps):
    """Checkpointed reverse stepping == all-residuals reference, across
    time-tile factors (13 = remainder steps for k ∈ {2, 4}); the forward
    is the repacking make's, and at k = 4 over 13 steps (tiles and a
    remainder) the gradient is the reference's."""
    T0 = rng.normal(size=(10, 8, 6)).astype(np.float32)
    w = rng.normal(size=(10, 8, 6)).astype(np.float32)
    _, ref = _runner_grad(T0, w, steps, 1, checkpoint=False)
    out, got = _runner_grad(T0, w, steps, time_tile, checkpoint=True)
    assert np.array_equal(got, ref)
    make = run_program(heat_prog(T0, steps), options=RunOptions(
        backend="pallas", time_tile=time_tile, resident=False, **CPU))
    assert np.array_equal(out, make["T"])
    if (time_tile, steps) == (4, 13):
        _assert_ulp_close(got, _ref_runner_grad(T0, w, steps, time_tile),
                          ulps=8.0)


@pytest.mark.parametrize("steps", [1, 5, 18])
@pytest.mark.parametrize("time_tile,chunk_steps", [(1, None), (2, 2), (4, 5),
                                                   (2, None)])
def test_checkpointed_runner_grad_property_torch(steps, time_tile,
                                                 chunk_steps):
    """The reference's hypothesis property at fixed draws (hypothesis is
    not installed): any step count, tile and chunk gives the
    all-residuals gradient."""
    r = np.random.default_rng(steps * 10 + time_tile)
    T0 = r.normal(size=(8, 8, 5)).astype(np.float32)
    w = r.normal(size=(8, 8, 5)).astype(np.float32)
    _, ref = _runner_grad(T0, w, steps, 1, False)
    _, got = _runner_grad(T0, w, steps, time_tile, True, chunk_steps)
    _assert_ulp_close(got, ref, ulps=8.0)


def test_ftcs_checkpointed_matches_plain_torch(rng):
    T0 = torch.tensor(rng.normal(size=(10, 10, 6)))
    w = torch.tensor(rng.normal(size=(10, 10, 6)))
    for steps in (1, 5, 12, 16):
        a = explicit.ftcs_solve(T0, 0.1, steps)
        b = explicit.ftcs_solve_checkpointed(T0, 0.1, steps)
        assert torch.equal(a, b)
    g_ck = _grad(lambda t: torch.sum(
        w * explicit.ftcs_solve_checkpointed(t, 0.1, 13)), T0.numpy())
    g_nc = _grad(lambda t: torch.sum(w * explicit.ftcs_solve(t, 0.1, 13)),
                 T0.numpy())
    assert np.array_equal(g_ck, g_nc)
    with jax.enable_x64(True):
        g_ref = jax.grad(lambda t: jnp.sum(
            jnp.asarray(w.numpy()) * ref_explicit.ftcs_solve_checkpointed(
                t, 0.1, 13)))(jnp.asarray(T0.numpy()))
    _assert_ulp_close(g_ck, np.asarray(g_ref))


def test_gradcheck_harness_on_explicit_stepper_torch(rng):
    """The FD harness end to end on the explicit path, at float32 (its
    loosened fp32 tolerances, as the reference's test)."""
    T0 = rng.normal(size=(8, 8, 5)).astype(np.float32)
    w = torch.tensor(rng.normal(size=(8, 8, 5)).astype(np.float32))
    f = lambda t: torch.sum(  # noqa: E731
        w * explicit.ftcs_solve_checkpointed(t, 0.1, 7))
    g = _grad(f, T0)
    assert_gradcheck(lambda t: f(torch.tensor(t, dtype=torch.float32)).item(),
                     T0, g, eps=1e-2, atol=1e-2, rtol=5e-2)


# -- no reuse of the caller's buffers under AD -------------------------------


def test_donation_suppressed_under_differentiable_plan_torch():
    """A differentiable plan keeps the repacking steps (no resident layout,
    whose ping-pong buffers a reverse pass would need), and leaves the
    caller's tensors alone; the same program without it is resident."""
    T0 = heat_init()
    p = plan(heat_prog(T0, 4), RunOptions(backend="pallas",
                                          differentiable=True, **CPU))
    p_ref = plan(heat_prog(T0, 4), RunOptions(backend="pallas", **CPU))
    assert p.differentiable and not p_ref.differentiable
    assert p.layout.pad == 0 and p_ref.layout.pad > 0
    env = {"T": torch.tensor(T0)}
    before = env["T"].clone()
    differentiable_runner(p)(env)
    assert torch.equal(env["T"], before)


def test_differentiable_runner_requires_flag_torch():
    p = plan(heat_prog(heat_init((8, 8, 6)), 4),
             RunOptions(backend="pallas", **CPU))
    with pytest.raises(ValueError, match="differentiable"):
        differentiable_runner(p)


# -- sharded gradient parity (float64) ----------------------------------------


def test_sharded_gradient_matches_single_device_fp64_torch(ref_grads):
    """2×2-mesh gradient of the differentiable runner vs one device and vs
    the reference's sharded gradient: forward bitwise, gradient within 4
    ulp (the bricks' halo reduction order)."""
    d = adjoint_inputs()
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    o1, g1 = _runner_grad(d["T0"], d["wh"], 9, 1, True)
    o2, g2 = _runner_grad(d["T0"], d["wh"], 9, 1, True, mesh=mesh)
    assert np.array_equal(o1, o2)
    assert np.array_equal(o2, ref_grads["sharded_out"])
    _assert_ulp_close(g2, g1)
    _assert_ulp_close(g2, ref_grads["sharded_grad"])


def test_checkpointed_vjp_spill_matches_in_memory_fp64_torch(tmp_path):
    """Out-of-core reverse sweep: disk-spilled chunk snapshots give the
    same gradient as in-memory snapshots and as a plain VJP, bitwise."""
    rng = np.random.default_rng(0)
    env0 = {"T": torch.tensor(rng.normal(size=(10, 10, 5)))}
    w = torch.tensor(rng.normal(size=(10, 10, 5)))

    def chunk(env):
        return {"T": explicit.ftcs_step(explicit.ftcs_step(env["T"], 0.1),
                                        0.1)}

    final, vjp = checkpointed_vjp(chunk, env0, 6)
    g_mem = vjp({"T": w})
    final2, vjp2 = checkpointed_vjp(chunk, env0, 6, spill_dir=str(tmp_path))
    g_disk = vjp2({"T": w})
    x = env0["T"].clone().requires_grad_()
    e = {"T": x}
    for _ in range(6):
        e = chunk(e)
    (g_ref,) = torch.autograd.grad(e["T"], x, w)
    assert torch.equal(final["T"], e["T"].detach())
    assert torch.equal(final2["T"], final["T"])
    assert torch.equal(g_mem["T"], g_ref)
    assert torch.equal(g_disk["T"], g_ref)


# -- the checkpoint manager ---------------------------------------------------


def test_checkpoint_manager_round_trip_torch(tmp_path):
    """Atomic snapshots restore with their exact dtypes (bfloat16 through
    its float32 upcast), onto the target's structure; ``keep`` prunes."""
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0, dtype=torch.bfloat16).reshape(2, 3),
            "b": [torch.tensor([1.5], dtype=torch.float64),
                  np.arange(3, dtype=np.int32)]}
    for step in (1, 2, 3):
        m.save(step, tree, extra={"step": step}, blocking=step != 2)
    assert m.steps() == [2, 3] and m.latest_step() == 3
    got, step, extra = m.restore(tree)
    assert (step, extra) == (3, {"step": 3})
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    assert got["b"][0].dtype == torch.float64
    assert np.array_equal(got["b"][1], tree["b"][1])
    assert not any(n.startswith("tmp-") for n in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)
