"""The PyTorch port's ``solve`` (Krylov methods, health words, validation)
vs the JAX reference, on the CPU.

The same NumPy inputs go through ``repro.solver`` and ``repro_torch.solver``.
The reference runs as its own tests run it here: ``backend="jit"``
(compiled XLA on the CPU) and, in one case, ``backend="pallas"`` in
interpret mode; the port runs on ``RunOptions(device="cpu")``, where the
fused kernels K1/K2 run as their plain versions.

Tolerances, and why:

* solutions agree within ``10·tol``: both stop once ‖r‖ ≤ tol, and with
  the BTCS operator's smallest eigenvalue ≥ 0.625 each solution lies within
  1.6·tol of the exact one, so the two differ by at most 3.2·tol;
  ``method="mg"``'s tol is relative, so there it is ``10·tol·‖b‖``;
* iteration counts agree within ±1: the two sum their dots in different
  orders (XLA's reduction vs ``torch.sum``), which can move the iteration
  at which ‖r‖ first crosses tol by one;
* the taxonomy word, the Gershgorin bounds, the ``ValueError`` messages and
  the compiler's ``kernels_built`` / ``cache_hits`` / ``fallbacks`` are
  equal;
* ``dual_dot_ref`` against the reference's ``dual_dot`` (its Pallas kernel
  in interpret mode): rtol 1e-6 at float32, two float32 sums in different
  orders over a few hundred terms.
"""
import numpy as np
import pytest
import torch

import jax
import repro.compiler as ref_compiler
import repro.core as ref_core
import repro.solver as ref_solver
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
import repro_torch.solver as port_solver
from conftest import heat_init
from repro.engine import RunOptions as RefOptions
from repro_torch.engine import RunOptions
from repro_torch.solver import health

OMEGA = 0.1
SHAPE = (9, 10, 11)
PKGS = {"ref": (ref_core, ref_solver), "port": (port_core, port_solver)}


def _solve(pkg, record, method, backend, **kw):
    """Record with ``record(core, solver)`` and solve in package ``pkg``."""
    core, solver = PKGS[pkg]
    wse, T = record(core, solver)[:2]
    if pkg == "ref":
        return wse.solve(T, method=method, return_info=True,
                         options=RefOptions(backend=backend), **kw)
    return wse.solve(T, method=method, return_info=True,
                     options=RunOptions(backend=backend, device="cpu"), **kw)


def _btcs(T0):
    return lambda core, solver: solver.record_btcs(T0, OMEGA)


def _norm_b(T0):
    b = T0.astype(np.float64).copy()
    b[1:-1, 1:-1, 1:-1] *= port_solver.psi(OMEGA)
    return float(np.linalg.norm(b))


def _assert_same_solve(port, ref, atol):
    (x, info), (xr, ir) = port, ref
    assert x.shape == xr.shape and x.dtype == xr.dtype
    assert np.abs(x.astype(np.float64) - xr).max() <= atol
    assert np.abs(info.iterations - ir.iterations).max() <= 1, (
        info.iterations, ir.iterations)
    assert list(info.outcomes) == list(ir.outcomes)


# -- every method on BTCS ----------------------------------------------------

@pytest.mark.parametrize("method,backend,tol,maxiter", [
    ("cg", "jit", 1e-4, 200),
    ("pipecg", "jit", 1e-4, 200),
    ("bicgstab", "jit", 1e-4, 200),
    ("chebyshev", "jit", 1e-4, 60),
    ("jacobi", "jit", 5e-3, 60),      # its residual is recomputed: f32 floor ~1e-3
    ("mg", "jit", 1e-6, 30),
    ("pipecg", "pallas", 1e-4, 200),   # the reference's Pallas in interpret mode
])
def test_method_matches_reference(method, backend, tol, maxiter):
    T0 = heat_init(SHAPE)
    kw = dict(tol=tol, maxiter=maxiter, steps=2)
    ref = _solve("ref", _btcs(T0), method, backend, **kw)
    port = _solve("port", _btcs(T0), method, backend, **kw)
    atol = 10 * tol * (_norm_b(T0) if method == "mg" else 1.0)
    _assert_same_solve(port, ref, atol)
    assert list(port[1].outcomes) == ["CONVERGED"] * 2
    assert port[1].residual.shape == (2,)


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_mg_preconditioned_matches_reference(method):
    T0 = heat_init((17, 17, 9))
    kw = dict(tol=1e-4, maxiter=100, precondition="mg")
    ref = _solve("ref", _btcs(T0), method, "jit", **kw)
    port = _solve("port", _btcs(T0), method, "jit", **kw)
    _assert_same_solve(port, ref, 1e-3)


def test_varcoef_bicgstab_matches_reference(rng):
    T0 = heat_init((6, 7, 5))
    C0 = rng.uniform(0.05, 0.3, size=T0.shape).astype(np.float32)
    record = lambda core, solver: solver.record_varcoef_btcs(T0, C0, OMEGA)  # noqa: E731
    kw = dict(tol=1e-4, maxiter=200)
    ref = _solve("ref", record, "bicgstab", "jit", **kw)
    port = _solve("port", record, "bicgstab", "jit", **kw)
    _assert_same_solve(port, ref, 1e-3)


def test_chebyshev_varcoef_with_explicit_bounds(rng):
    T0 = heat_init((6, 7, 5))
    C0 = rng.uniform(0.05, 0.3, size=T0.shape).astype(np.float32)
    record = lambda core, solver: solver.record_varcoef_btcs(T0, C0, OMEGA)  # noqa: E731
    kw = dict(maxiter=60, tol=1e-4,
              lambda_bounds=(1.0 - 6 * OMEGA * 0.3, 1.0 + 6 * OMEGA * 0.3 + 0.2))
    ref = _solve("ref", record, "chebyshev", "jit", **kw)
    port = _solve("port", record, "chebyshev", "jit", **kw)
    _assert_same_solve(port, ref, 1e-3)


def test_maxiter_word_matches_reference():
    """A budget too small to converge: the same MAXITER word and count."""
    T0 = heat_init(SHAPE)
    kw = dict(tol=1e-9, maxiter=3)
    for method in ("cg", "pipecg", "bicgstab"):
        ref = _solve("ref", _btcs(T0), method, "jit", **kw)
        port = _solve("port", _btcs(T0), method, "jit", **kw)
        assert list(port[1].outcomes) == list(ref[1].outcomes) == ["MAXITER"]
        assert port[1].iterations[0] == ref[1].iterations[0] == 3


def test_nan_state_is_never_converged():
    T0 = heat_init(SHAPE)
    T0[4, 4, 4] = np.nan
    for method in ("cg", "pipecg", "bicgstab", "chebyshev"):
        ref = _solve("ref", _btcs(T0), method, "jit", tol=1e-4, maxiter=20)
        port = _solve("port", _btcs(T0), method, "jit", tol=1e-4, maxiter=20)
        assert list(port[1].outcomes) == list(ref[1].outcomes)
        assert port[1].outcomes[0] != "CONVERGED"


# -- the health guard on host scalars vs the reference's words ---------------

@pytest.mark.parametrize("seq,breakdown_at", [
    ([1.0, 0.5, 0.25], None),                  # healthy
    ([1.0, 0.5, float("nan")], None),          # NAN_RESIDUAL
    ([1.0, 0.5, 2e4], None),                   # DIVERGED
    ([1.0, 2.0, 3.0, 4.0, 5.0], None),         # STAGNATED (window 3)
    ([1.0, 0.5, 0.4], 1),                      # BREAKDOWN
    ([float("inf")], None),                    # poisoned entry
])
def test_guard_words_match_reference(seq, breakdown_at):
    import jax.numpy as jnp

    from repro.solver import health as ref_health

    cfg_p = health.GuardConfig(stagnation_window=3)
    cfg_r = ref_health.GuardConfig(stagnation_window=3)
    gp = health.guard_init(seq[0])
    gr = ref_health.guard_init(jnp.float32(seq[0]))
    for k, rr in enumerate(seq[1:], start=1):
        bd = breakdown_at == k
        gp = health.guard_update(gp, rr, breakdown=bd, config=cfg_p)
        gr = ref_health.guard_update(gr, jnp.float32(rr),
                                     breakdown=jnp.asarray(bd), config=cfg_r)
        assert health.running(gp) == bool(ref_health.running(gr))
        assert gp[0] == int(gr[0]) and gp[2] == int(gr[2])
    for tol2 in (0.3, 1e-6):
        assert health.classify(gp, seq[-1], tol2) == int(
            ref_health.classify(gr, jnp.float32(seq[-1]), tol2))
        assert health.classify_fixed(seq[-1], tol2) == int(
            ref_health.classify_fixed(jnp.float32(seq[-1]), tol2))
    codes = [0, 1, 4, 2]
    assert health.worst(codes) == ref_health.worst(codes)
    assert list(health.outcome_names(codes)) == list(
        ref_health.outcome_names(codes))
    assert health.any_failure(codes) == ref_health.any_failure(codes)


# -- bounds, validation, make guard ------------------------------------------

def _lowered_operator(pkg, record):
    core, solver = PKGS[pkg]
    compiler = ref_compiler if pkg == "ref" else port_compiler
    wse, T = record(core, solver)[:2]
    prog = wse.program
    wse.__exit__()
    op_ops = [op for op in prog.ops if getattr(op.loop, "role", None) == "operator"]
    return compiler.lower_group(op_ops), T.name


@pytest.mark.parametrize("system", ["btcs", "poisson", "varcoef"])
def test_gershgorin_bounds_equal(system):
    T0 = heat_init((6, 7, 5))
    record = {
        "btcs": _btcs(T0),
        "poisson": lambda core, solver: solver.record_poisson(T0),
        "varcoef": lambda core, solver: solver.record_varcoef_btcs(
            T0, np.full(T0.shape, 0.2, np.float32), OMEGA),
    }[system]
    bounds = {}
    for pkg in PKGS:
        group, name = _lowered_operator(pkg, record)
        bounds[pkg] = PKGS[pkg][1].gershgorin_bounds(group, name)
    assert bounds["port"] == bounds["ref"]
    assert (bounds["port"] is None) == (system != "btcs")


def _bad_program(core, solver, how):
    T0 = heat_init((6, 6, 6))
    wse = core.WSE_Interface()
    T = core.WSE_Array("T", init_data=T0)
    if how == "nonlinear":
        with solver.Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[1:-1, 0, 0]
    elif how == "constant":
        with solver.Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] + 1.0
    elif how == "no_operator":
        with solver.Rhs():
            T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
    elif how == "unlooped":
        T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
    elif how == "coef_only":
        C = core.WSE_Array("C", init_data=T0)
        with solver.Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] + C[1:-1, 0, 0]
    return wse, T


@pytest.mark.parametrize("how,method,kw", [
    ("nonlinear", "cg", {}),
    ("constant", "cg", {}),
    ("no_operator", "cg", {}),
    ("unlooped", "cg", {}),
    ("coef_only", "cg", {}),
    ("constant", "nonsense", {}),
    ("nonlinear", "chebyshev", {"precondition": "mg"}),
    ("nonlinear", "mg", {"precondition": "mg"}),
    ("nonlinear", "cg", {"precondition": "ilu"}),
])
def test_validation_errors_match_reference(how, method, kw):
    msgs = {}
    for pkg in PKGS:
        core, solver = PKGS[pkg]
        wse, T = _bad_program(core, solver, how)
        opts = (RefOptions(backend="jit") if pkg == "ref"
                else RunOptions(backend="jit", device="cpu"))
        with pytest.raises(ValueError) as e:
            wse.solve(T, method=method, options=opts, **kw)
        msgs[pkg] = str(e.value)
        assert port_core.program.current_program() is None
        assert ref_core.program.current_program() is None
    assert msgs["port"] == msgs["ref"]


def test_chebyshev_needs_bounds_message_matches(rng):
    T0 = heat_init((6, 7, 5))
    C0 = rng.uniform(0.05, 0.3, size=T0.shape).astype(np.float32)
    msgs = {}
    for pkg in PKGS:
        core, solver = PKGS[pkg]
        wse, T, _ = solver.record_varcoef_btcs(T0, C0, OMEGA)
        opts = (RefOptions(backend="jit") if pkg == "ref"
                else RunOptions(backend="jit", device="cpu"))
        with pytest.raises(ValueError, match="lambda_bounds") as e:
            wse.solve(T, method="chebyshev", maxiter=50, options=opts)
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["ref"]


def test_make_rejects_solver_programs():
    T0 = heat_init((6, 6, 6))
    msgs = {}
    for pkg in PKGS:
        core, solver = PKGS[pkg]
        wse, T = solver.record_btcs(T0, OMEGA)
        opts = (RefOptions(backend="jit") if pkg == "ref"
                else RunOptions(backend="jit", device="cpu"))
        with pytest.raises(ValueError, match="implicit") as e:
            wse.make(answer=T, options=opts)
        msgs[pkg] = str(e.value)
        # the failed make deactivates the program but leaves it attached
        assert core.program.current_program() is None
        x = wse.solve(T, method="cg", tol=1e-4, maxiter=100, options=opts)
        assert np.isfinite(x).all()
    assert msgs["port"] == msgs["ref"]


# -- compiler accounting -------------------------------------------------------

@pytest.mark.parametrize("system", ["btcs", "varcoef"])
def test_compiler_stats_match_reference(system, rng):
    T0 = heat_init((7, 8, 9))
    C0 = rng.uniform(0.05, 0.3, size=T0.shape).astype(np.float32)
    record, method = {
        "btcs": (_btcs(T0), "cg"),
        "varcoef": (lambda core, solver: solver.record_varcoef_btcs(
            T0, C0, OMEGA), "bicgstab"),
    }[system]
    counts = {}
    for pkg, comp in (("ref", ref_compiler), ("port", port_compiler)):
        comp.reset_stats()
        comp.clear_cache()
        seq = []
        for _ in range(2):   # the second solve is served from the cache
            _solve(pkg, record, method, "pallas", tol=1e-4, maxiter=100)
            s = comp.stats
            seq.append((s.kernels_built, s.cache_hits, s.fallbacks,
                        s.groups_fused))
        counts[pkg] = seq
    assert counts["port"] == counts["ref"]
    assert counts["port"][0][2] == 0


# -- K2's plain version vs the reference's dual_dot --------------------------

def test_dual_dot_ref_matches_reference():
    """The two float32 dots sum in other orders than the reference's, and
    a dot can cancel, so each is bounded by ``1e-6·Σ|aᵢbᵢ|`` (the measure
    that bounds a sum's rounding, and the card check's for K2), not
    relative to the result; the data are the test's own."""
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops as port_ops
    from repro_torch.kernels.dotprod import dual_dot_ref

    rng = np.random.default_rng(33)
    a, b, c, d = (rng.normal(size=(9, 10, 11)).astype(np.float32)
                  for _ in range(4))
    ref = np.asarray(ref_ops.dual_dot(a, b, c, d))
    got = dual_dot_ref(*(torch.tensor(v) for v in (a, b, c, d))).numpy()
    assert got.dtype == np.float32
    scale = np.array([np.abs(a.astype(np.float64) * b).sum(),
                      np.abs(c.astype(np.float64) * d).sum()])
    assert np.all(np.abs(got.astype(np.float64) - ref) <= 1e-6 * scale), \
        (got, ref, scale)
    # the device dispatch on CPU tensors is the plain version
    via_ops = port_ops.dual_dot(*(torch.tensor(v) for v in (a, b, c, d)))
    np.testing.assert_array_equal(via_ops.numpy(), got)
    # float64 operands accumulate in float64 (the reference's kernel would
    # drop to float32): exact to float64 rounding
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    got64 = dual_dot_ref(*(torch.tensor(v) for v in (a64, b64, a64, a64)))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), [np.dot(a64.ravel(), b64.ravel()),
                                               np.dot(a64.ravel(), a64.ravel())],
                               rtol=1e-13)


# -- the rest of the surface ---------------------------------------------------

def test_record_implicit_matches_reference():
    from repro.configs.heat3d import HeatConfig as RefHeat
    from repro.configs.heat3d import record_implicit as ref_record
    from repro_torch.configs.heat3d import HeatConfig, record_implicit

    outs = {}
    for pkg, cfg, rec in (("ref", RefHeat().smoke(), ref_record),
                          ("port", HeatConfig().smoke(), record_implicit)):
        wse, T = rec(cfg)
        opts = (RefOptions(backend="jit") if pkg == "ref"
                else RunOptions(backend="jit", device="cpu"))
        outs[pkg] = wse.solve(T, method=cfg.method, tol=1e-3,
                              maxiter=cfg.maxiter, options=opts,
                              return_info=True)
    _assert_same_solve(outs["port"], outs["ref"], 1e-2)


def test_operator_fns_match_reference():
    T0 = heat_init((7, 8, 9))
    prog_r = ref_solver.btcs_program(T0.shape, OMEGA, init_data=T0)
    prog_p = port_solver.btcs_program(T0.shape, OMEGA, init_data=T0)
    with jax.disable_jit():
        A_r, rhs_r = ref_solver.operator_fns(prog_r, "T", backend="jit")
        ref = np.asarray(A_r(rhs_r(T0)))
    A_p, rhs_p = port_solver.operator_fns(prog_p, "T", backend="jit",
                                          device="cpu")
    np.testing.assert_array_equal(A_p(rhs_p(torch.tensor(T0))).numpy(), ref)


def test_solve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wse, T = port_solver.record_btcs(heat_init((6, 6, 6)), OMEGA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wse.solve(T, method="cg")
    assert port_core.program.current_program() is None


def test_later_slices_raise():
    """The adjoint and health slices are in: make_solver(differentiable=True)
    builds the adjoint solver and RunOptions takes a RecoveryPolicy."""
    wse, T = port_solver.record_btcs(heat_init((6, 6, 6)), OMEGA)
    prog = wse.program
    wse.__exit__()
    step = port_solver.make_solver(prog, "T", device="cpu",
                                   differentiable=True)
    assert step.symmetric_adjoint
    # the sharding slice is in: a mesh must be the port's own Mesh
    with pytest.raises(TypeError, match="Mesh"):
        port_solver.make_sharded_solver(prog, "T", mesh=None)
    opts = RunOptions(recovery=port_solver.RecoveryPolicy())
    assert opts.recovery == port_solver.RecoveryPolicy()


def test_make_solver_leaves_the_callers_state_alone():
    T0 = heat_init((7, 8, 9))
    prog = port_solver.btcs_program(T0.shape, OMEGA, init_data=T0)
    step = port_solver.make_solver(prog, "T", method="cg", backend="pallas",
                                   tol=1e-4, device="cpu")
    x0 = torch.tensor(T0)
    before = x0.clone()
    x, (iters, res, outs) = step(x0)
    assert torch.equal(x0, before) and not torch.equal(x, x0)
    assert iters.dtype == np.int32 and outs.tolist() == [health.CONVERGED]
    x2, _ = step(T0)
    assert torch.equal(x, x2)
