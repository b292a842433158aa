"""The PyTorch port's geometric multigrid (IR hierarchy, transfers K3/K4,
V-cycles, ``method="mg"`` / ``precondition="mg"``) vs the JAX reference, on
the CPU.

The same NumPy inputs go through ``repro`` and ``repro_torch``.  The
reference runs ``backend="jit"`` (compiled XLA) and, in one case,
``backend="pallas"`` in interpret mode (its transfers are then its Pallas
kernels); the port runs on ``RunOptions(device="cpu")``, where K1, K3 and
K4 run as their plain versions.

Tolerances, and why:

* the hierarchy's shapes and taps are equal (pure Python on both sides);
* ``restrict_ref`` / ``prolong_ref`` are **bitwise** equal to the
  reference's under ``jax.disable_jit()`` (every op rounded on its own on
  both sides, at float32 and float64), and within 2 ulp of the reference's
  ``build_*_call(..., interpret=True)``, which XLA compiles with contracted
  multiply-adds;
* one V-cycle agrees with the reference's to 1e-5 relative: the smoother
  and residual bodies differ from the reference's compiled XLA by ~1 ulp
  per application (see ``test_torch_engine.py``) over a cycle of a few
  dozen applications;
* iteration counts agree within ±1 (different summation orders in the
  dots) and stay flat over the sizes (9, 17, 33);
* the kernel-cache counts and ``mg_level_log`` are equal.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import repro.compiler as ref_compiler
import repro.engine as ref_engine
import repro.solver as ref_solver
import repro_torch.compiler as port_compiler
import repro_torch.engine as port_engine
import repro_torch.solver as port_solver
from repro.engine import RunOptions as RefOptions
from repro.kernels import transfer as ref_transfer
from repro_torch.engine import RunOptions
from repro_torch.kernels import transfer as port_transfer

PKGS = {"ref": (ref_solver, ref_compiler, ref_engine),
        "port": (port_solver, port_compiler, port_engine)}


def _poisson_rhs(shape, seed=0):
    rng = np.random.default_rng(seed)
    F = np.zeros(shape, np.float32)
    F[1:-1, 1:-1, 1:-1] = rng.normal(size=tuple(n - 2 for n in shape)).astype(
        np.float32)
    return F


def _opts(pkg, backend):
    if pkg == "ref":
        return RefOptions(backend=backend)
    return RunOptions(backend=backend, device="cpu")


def _solve(pkg, prog_fn, method, backend, **kw):
    solver = PKGS[pkg][0]
    return solver.solve(prog_fn(solver), "T", method=method, return_info=True,
                        options=_opts(pkg, backend), **kw)


# -- IR: the level hierarchy ---------------------------------------------------

@pytest.mark.parametrize("shape,system", [
    ((512, 512, 128), "btcs"),     # the main path's hierarchy, 7 levels
    ((17, 17, 17), "poisson"),
    ((16, 12, 10), "poisson"),
])
def test_hierarchy_taps_and_shapes_equal(shape, system):
    levels = {}
    for pkg in PKGS:
        solver, compiler, _ = PKGS[pkg]
        prog = (solver.btcs_program(shape, 0.1) if system == "btcs"
                else solver.poisson_program(shape))
        ops = [op for op in prog.ops if op.loop.role == "operator"]
        fine = compiler.mg_fine_operator(compiler.lower_group(ops), "T", shape)
        levels[pkg] = [(op.shape, op.taps) for op in compiler.mg_hierarchy(fine)]
    assert levels["port"] == levels["ref"]
    if shape == (512, 512, 128):
        assert [s for s, _ in levels["port"]] == [
            (512, 512, 128), (257, 257, 65), (129, 129, 33), (65, 65, 17),
            (33, 33, 9), (17, 17, 5), (9, 9, 3)]


def test_transfer_stencil_and_coarsening_errors_match():
    msgs = {}
    for pkg, compiler in (("ref", ref_compiler), ("port", port_compiler)):
        with pytest.raises(compiler.LoweringError) as e:
            compiler.TransferStencil("restrict", (9, 9, 9), (4, 5, 5))
        with pytest.raises(compiler.LoweringError) as e2:
            compiler.mg_hierarchy(compiler.MGOperator((4, 9, 9),
                                                      (((0, 0, 0), 6.0),)))
        msgs[pkg] = (str(e.value), str(e2.value))
    assert msgs["port"] == msgs["ref"]


# -- K3/K4 plain versions vs the reference's ----------------------------------

SHAPES = [(9, 9, 9), (17, 17, 5), (16, 12, 10), (8, 7, 6)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(9, 9, 9), (16, 12, 10)])   # odd, even
def test_plain_transfers_bitwise_vs_reference(shape, dtype, rng):
    fine = rng.normal(size=shape).astype(dtype)
    coarse = rng.normal(size=port_transfer.coarsen_shape(shape)).astype(dtype)
    with jax.enable_x64(np.dtype(dtype) == np.float64), jax.disable_jit():
        r_ref = np.asarray(ref_transfer.restrict_ref(fine))
        p_ref = np.asarray(ref_transfer.prolong_ref(coarse, shape))
    r = port_transfer.restrict_ref(torch.tensor(fine)).numpy()
    p = port_transfer.prolong_ref(torch.tensor(coarse), shape).numpy()
    assert r.dtype == p.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_array_equal(p, p_ref)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_transfers_vs_reference_pallas(shape, rng):
    """Within 2 ulp of the reference's Pallas kernels in interpret mode."""
    fine = rng.normal(size=shape).astype(np.float32)
    cshape = port_transfer.coarsen_shape(shape)
    coarse = rng.normal(size=cshape).astype(np.float32)
    r_ref = np.asarray(ref_transfer.build_restrict_call(
        shape, cshape, np.float32, interpret=True)(fine))
    p_ref = np.asarray(ref_transfer.build_prolong_call(
        cshape, shape, np.float32, interpret=True)(coarse))
    r = port_transfer.restrict_ref(torch.tensor(fine)).numpy()
    p = port_transfer.prolong_ref(torch.tensor(coarse), shape).numpy()
    for got, ref in ((r, r_ref), (p, p_ref)):
        ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)).astype(np.float32))
        assert (np.abs(got - ref) <= 2 * ulp).all()


def test_compiled_transfer_dispatches_and_checks(rng):
    port_compiler.clear_cache()
    port_compiler.reset_stats()
    call = port_compiler.compile_transfer("restrict", (9, 9, 9), (5, 5, 5),
                                          np.float32, "cpu")
    again = port_compiler.compile_transfer("restrict", (9, 9, 9), (5, 5, 5),
                                           np.float32, "cpu")
    assert call is again
    assert (port_compiler.stats.kernels_built, port_compiler.stats.cache_hits) \
        == (1, 1)
    fine = torch.tensor(rng.normal(size=(9, 9, 9)).astype(np.float32))
    assert torch.equal(call(fine), port_transfer.restrict_ref(fine))
    up = port_compiler.compile_transfer("prolong", (9, 9, 9), (5, 5, 5),
                                        np.float32, "cpu")
    coarse = torch.tensor(rng.normal(size=(5, 5, 5)).astype(np.float32))
    assert torch.equal(up(coarse), port_transfer.prolong_ref(coarse, (9, 9, 9)))
    assert port_compiler.stats.kernels_built == 2
    with pytest.raises(ValueError, match="CUDA"):
        port_transfer.launch_restrict(fine)
    with pytest.raises(port_compiler.LoweringError, match="disagree"):
        port_compiler.compile_transfer("prolong", (9, 9, 9), (4, 4, 4),
                                       np.float32, "cpu")


@pytest.mark.parametrize("entry", ["build_multigrid", "plan_mg_levels",
                                   "compile_transfer"])
def test_multigrid_entry_points_default_to_the_card(entry, monkeypatch):
    """Without ``device=`` the hierarchy is built for the card, and a
    machine without one raises instead of building it on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = (9, 9, 9)
    prog = port_solver.poisson_program(shape, rhs=_poisson_rhs(shape))
    group = port_compiler.lower_group(
        [op for op in prog.ops if op.loop.role == "operator"])
    calls = {
        "build_multigrid": lambda: port_solver.build_multigrid(
            group, "T", shape, np.float32, "pallas"),
        "plan_mg_levels": lambda: port_engine.plan_mg_levels(
            [], "pallas", np.float32),
        "compile_transfer": lambda: port_compiler.compile_transfer(
            "restrict", shape, (5, 5, 5), np.float32),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


# -- one V-cycle ---------------------------------------------------------------

@pytest.mark.parametrize("smoother", ["jacobi", "rb"])
def test_vcycle_matches_reference(smoother):
    shape = (17, 17, 9)
    F = _poisson_rhs(shape)
    outs = {}
    for pkg in PKGS:
        solver, compiler, _ = PKGS[pkg]
        prog = solver.poisson_program(shape, rhs=F)
        ops = [op for op in prog.ops if op.loop.role == "operator"]
        group = compiler.lower_group(ops)
        opts = solver.MGOptions(smoother=smoother)
        if pkg == "ref":
            mg = solver.build_multigrid(group, "T", shape, np.float32, "jit", opts)
            outs[pkg] = np.asarray(jax.jit(mg.cycle)(np.zeros(shape, np.float32),
                                                     F))
        else:
            mg = solver.build_multigrid(group, "T", shape, np.float32, "jit", opts,
                                        device="cpu")
            outs[pkg] = mg.cycle(torch.zeros(shape), torch.tensor(F)).numpy()
    scale = np.abs(outs["ref"]).max()
    assert np.abs(outs["port"] - outs["ref"]).max() <= 1e-5 * scale


# -- solves ---------------------------------------------------------------------

@pytest.mark.parametrize("method,precondition,backend", [
    ("mg", None, "jit"),
    ("cg", "mg", "jit"),
    ("bicgstab", "mg", "jit"),
    ("mg", None, "pallas"),     # the reference's transfer kernels, interpreted
])
def test_poisson_solve_matches_reference(method, precondition, backend):
    shape = (9, 9, 9)
    F = _poisson_rhs(shape)
    prog_fn = lambda solver: solver.poisson_program(shape, rhs=F)  # noqa: E731
    kw = dict(tol=1e-5, maxiter=60, precondition=precondition)
    (x, info) = _solve("port", prog_fn, method, backend, **kw)
    (xr, ir) = _solve("ref", prog_fn, method, backend, **kw)
    assert abs(int(info.iterations[0]) - int(ir.iterations[0])) <= 1
    assert list(info.outcomes) == list(ir.outcomes) == ["CONVERGED"]
    # both stop at ‖r‖ ≤ tol·‖F‖ (mg) or ‖r‖ ≤ tol (‖F‖ ≈ 18 here); the
    # Poisson operator's smallest eigenvalue is ≈ 0.6 on this grid
    assert np.abs(x - xr).max() <= 10 * 1e-5 * np.linalg.norm(F) / 0.6


def test_iteration_counts_flat_and_match_reference():
    """mg ≈ 7 cycles and mg-pcg ≈ 5–7 iterations, flat over (9, 17, 33) —
    what plain CG does not manage — and the reference's counts at 17³."""
    counts = {"mg": [], "pcg": [], "cg": []}
    for n in (9, 17, 33):
        F = _poisson_rhs((n, n, n))
        prog_fn = lambda solver: solver.poisson_program((n, n, n), rhs=F)  # noqa: E731
        for key, method, pc in (("mg", "mg", None), ("pcg", "cg", "mg"),
                                ("cg", "cg", None)):
            _, info = _solve("port", prog_fn, method, "jit", tol=1e-5,
                             maxiter=300, precondition=pc)
            counts[key].append(int(info.iterations[0]))
            if n == 17 and key != "cg":
                _, ir = _solve("ref", prog_fn, method, "jit", tol=1e-5,
                               maxiter=300, precondition=pc)
                assert abs(counts[key][-1] - int(ir.iterations[0])) <= 1
    for key in ("mg", "pcg"):
        assert max(counts[key]) <= min(counts[key]) + 2, counts
        assert max(counts[key]) <= 10, counts
    assert counts["cg"][-1] > 3 * max(counts["pcg"]), counts


def test_kernel_cache_per_level_matches_reference():
    shape = (9, 9, 9)
    F = _poisson_rhs(shape)
    prog_fn = lambda solver: solver.poisson_program(shape, rhs=F)  # noqa: E731
    seen = {}
    for pkg in PKGS:
        _, compiler, engine = PKGS[pkg]
        compiler.clear_cache()
        compiler.reset_stats()
        engine.reset_stats()
        _solve(pkg, prog_fn, "mg", "pallas", tol=1e-5, maxiter=30)
        first = (compiler.stats.kernels_built, compiler.stats.cache_hits,
                 compiler.stats.fallbacks)
        levels = engine.stats.mg_levels_built
        log = engine.stats.mg_level_log
        _solve(pkg, prog_fn, "mg", "pallas", tol=1e-5, maxiter=30)
        seen[pkg] = (first, levels, log, compiler.stats.kernels_built,
                     engine.stats.mg_hierarchies)
    assert seen["port"] == seen["ref"]
    first, levels, log, built_after, hierarchies = seen["port"]
    assert levels == 3 and hierarchies == 2   # 9 -> 5 -> 3
    assert all(sf and rf for _, sf, rf in log)
    # smoother + residual per level, restrict + prolong per level pair,
    # operator + rhs bodies of the solve itself; the second solve builds none
    assert first == (2 * levels + 2 * (levels - 1) + 2, 0, 0)
    assert built_after == first[0]


# -- legality: the same errors, the same fallback --------------------------------

@pytest.mark.parametrize("how", ["uncoarsenable", "varcoef", "asymmetric"])
def test_mg_legality_errors_match_reference(how):
    msgs = {}
    for pkg in PKGS:
        solver = PKGS[pkg][0]
        core = __import__("repro.core" if pkg == "ref" else "repro_torch.core",
                          fromlist=["WSE_Interface"])
        if how == "uncoarsenable":
            prog = solver.poisson_program((4, 9, 9))
            with pytest.raises(ValueError) as e:
                solver.solve(prog, "T", method="mg", options=_opts(pkg, "jit"))
        else:
            if how == "varcoef":
                T0 = np.full((9, 9, 9), 500.0, np.float32)
                C0 = np.full((9, 9, 9), 0.2, np.float32)
                wse, T, _ = solver.record_varcoef_btcs(T0, C0, 0.1)
            else:
                wse = core.WSE_Interface()
                T = core.WSE_Array("T", shape=(9, 9, 9))
                with solver.Operator():
                    T[1:-1, 0, 0] = T[1:-1, 0, 0] - 0.25 * T[1:-1, -1, 0]
                with solver.Rhs():
                    T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
            with pytest.raises(ValueError) as e:
                wse.solve(T, method="mg", options=_opts(pkg, "jit"))
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["ref"]
    assert {"uncoarsenable": "coarsenable", "varcoef": "constant-coefficient",
            "asymmetric": "symmetric"}[how] in msgs["port"]


def test_precondition_fallback_logged_and_converges(caplog):
    T0 = np.full((9, 9, 9), 500.0, np.float32)
    C0 = np.random.default_rng(1).uniform(0.05, 0.3, T0.shape).astype(np.float32)
    wse, T, _ = port_solver.record_varcoef_btcs(T0, C0, 0.1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.solver"):
        x, info = wse.solve(T, method="bicgstab", precondition="mg", tol=1e-4,
                            maxiter=300, return_info=True,
                            options=RunOptions(backend="jit", device="cpu"))
    assert np.isfinite(x).all() and list(info.outcomes) == ["CONVERGED"]
    assert any("falling back" in r.message for r in caplog.records)
