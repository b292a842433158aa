"""The PyTorch port's ensembles (``Ensemble``, batched ``make``, masked
batched Krylov solves) on the CPU, against B single port runs and against
the JAX reference's ``repro.Ensemble``.

Members come from NumPy seeds, as ``tests/test_ensemble.py::member_inits``
makes them.  Tolerances, and why:

* a batched ``make`` equals its B single port runs **bitwise**, on every
  backend, tile and layout, at float32 and float64: each member's cells go
  through the same arithmetic as its own run (K1's plain version runs the
  members one at a time, the roll interpreter acts on the trailing three
  axes);
* the port's ``Ensemble.make`` against the reference's, on ``pallas`` (the
  reference in interpret mode, as its own tests run it here): within 2 ulp
  of the field's magnitude per step, as ``test_torch_engine.py`` holds
  single runs (the reference's XLA contracts ``a·b + c`` into fused
  multiply-adds, the port rounds each operation on its own);
* a batched solve against the B independent port solves: within ``10·tol``
  (both stop once ‖r‖ ≤ tol; with the operators' smallest eigenvalue ≥
  0.625 each solution lies within 1.6·tol of the exact one), as
  ``test_torch_solver.py::_assert_same_solve`` holds the port against the
  reference; the per-member iteration counts equal the reference's batched
  solve's;
* a member that converged early is frozen **bitwise**: cutting ``maxiter``
  at its count gives the same bits.
"""
import doctest
import importlib

import numpy as np
import pytest
import torch

import repro as ref
import repro.core  # noqa: F401  (ref.core, ref.solver below)
import repro.solver  # noqa: F401
import repro_torch as rt
import repro_torch.compiler as port_compiler
import repro_torch.engine as port_engine
from conftest import heat_init
from repro.engine import RunOptions as RefOptions
from repro.engine.layout import HaloLayout as RefLayout
from repro_torch.compiler import lower_group
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.engine import HaloLayout, RunOptions
from repro_torch.engine.layout import wrap_refresh
from repro_torch.kernels.fused import (build_fused_call, fused_step_ref,
                                       fused_sweep_ref)
from test_torch_cuda import k1_body


def heat_member(m, T0, steps=5, c=0.1):
    """The reference test's member: one heat program recorded into
    package ``m`` (``repro`` or ``repro_torch``)."""
    center = 1.0 - 6.0 * c
    with m.WFAInterface() as wse:
        T = m.Field("T_e", init_data=T0, dtype=T0.dtype)
        with m.ForLoop("t", steps):
            T[1:-1, 0, 0] = center * T[1:-1, 0, 0] + c * (
                T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, -1, 0]
                + T[1:-1, 0, 1] + T[1:-1, 0, -1])
    return wse, T


def member_inits(b, shape=(8, 9, 6), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(250.0, 550.0, shape).astype(dtype) for _ in range(b)]


def cpu(**kw):
    return RunOptions(device="cpu", **kw)


# -- batched explicit stepping ------------------------------------------------

MAKE_CASES = ([("numpy", None, True), ("jit", None, True)]
              + [("pallas", tt, res) for tt in (4, None) for res in (True, False)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("backend,time_tile,resident", MAKE_CASES)
def test_batched_make_equals_single_runs_bitwise(backend, time_tile, resident,
                                                 dtype):
    """7 steps: at time_tile=4 one tiled launch and three remainder ones;
    the auto pick here is 1 (the trip count is odd)."""
    inits = member_inits(3, dtype=dtype)
    opts = cpu(backend=backend, time_tile=time_tile, resident=resident)
    ens = rt.Ensemble.from_programs([heat_member(rt, T0, 7) for T0 in inits])
    out = ens.make(options=opts)
    assert out.shape == (3,) + inits[0].shape and out.dtype == dtype
    for b, T0 in enumerate(inits):
        wse, T = heat_member(rt, T0, 7)
        np.testing.assert_array_equal(out[b], wse.make(answer=T, options=opts),
                                      err_msg=f"member {b}")


@pytest.mark.parametrize("name", ["hazard_two_updates", "wide_halo2_mixed_nz",
                                  "advdiff_dz"])
@pytest.mark.parametrize("time_tile", [1, 2])
def test_batched_make_of_multi_field_bodies_bitwise(name, time_tile):
    """Hazard updates, halo 2 with mixed nz and off-axis taps: every field
    overridden per member (k1_body's fields from three seeds)."""
    members = []
    for seed in range(3):
        wse, env = k1_body(rt.core, name, np.float32, steps=5, seed=seed)
        answer = next(iter(wse.program.fields))
        wse.__exit__()
        members.append((wse, env, answer))
    ens = rt.Ensemble.from_programs([(w, a) for w, _, a in members])
    assert set(ens.overrides) == set(members[0][1])
    opts = cpu(backend="pallas", time_tile=time_tile)
    out = ens.make(options=opts)
    for b in range(3):
        wse, _ = k1_body(rt.core, name, np.float32, steps=5, seed=b)
        single = rt.make(wse, members[b][2], options=opts)
        np.testing.assert_array_equal(out[b], single)


def test_parameter_sweep_override_broadcasts_the_rest():
    """Overriding only a coefficient field: the state broadcasts to every
    member, and each member equals its own single run."""
    rng = np.random.default_rng(4)
    T0 = heat_init((8, 9, 10)).astype(np.float32) / 500.0
    coefs = [rng.uniform(0.02, 0.15, T0.shape).astype(np.float32)
             for _ in range(4)]

    def record(C0):
        with rt.WFAInterface() as wse:
            T = rt.Field("T", init_data=T0)
            C = rt.Field("C", init_data=C0)
            with rt.ForLoop("t", 4):
                T[1:-1, 0, 0] = T[1:-1, 0, 0] + C[1:-1, 0, 0] * (
                    T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                    + T[1:-1, -1, 0] + T[1:-1, 0, 1] + T[1:-1, 0, -1]
                    - 6.0 * T[1:-1, 0, 0])
        return wse, T

    wse, T = record(coefs[0])
    ens = rt.Ensemble(wse.program, T, overrides={"C": np.stack(coefs)})
    assert ens.batch == 4 and ens.stacked_env()["T"].shape == (4,) + T0.shape
    out = rt.make(ens, options=cpu(backend="pallas", time_tile=2))
    for b, C0 in enumerate(coefs):
        wse, T = record(C0)
        np.testing.assert_array_equal(
            out[b], wse.make(answer=T, options=cpu(backend="pallas",
                                                   time_tile=2)))


def test_batched_make_accounting_and_kernel_cache():
    """One ensemble run counts once, with its members; K1 is built once per
    member count (the cache key holds B) and reused by the next run."""
    port_engine.reset_stats()
    port_compiler.reset_stats()
    port_compiler.clear_cache()
    inits = member_inits(4, seed=5)
    opts = cpu(backend="pallas", time_tile=1)
    for _ in range(2):
        rt.Ensemble.from_programs([heat_member(rt, T0) for T0 in inits]).make(
            options=opts)
    assert port_engine.stats.ensemble_runs == 2
    assert port_engine.stats.ensemble_members == 8
    assert port_compiler.stats.kernels_built == 1
    assert port_compiler.stats.cache_hits == 1
    wse, T = heat_member(rt, inits[0])
    wse.make(answer=T, options=opts)
    assert port_compiler.stats.kernels_built == 2     # batch 1: its own kernel
    assert port_engine.stats.ensemble_runs == 2


def test_one_member_ensemble_keeps_its_axis():
    (T0,) = member_inits(1, seed=6)
    ens = rt.Ensemble.from_programs([heat_member(rt, T0)])
    out = ens.make(options=cpu(backend="pallas"))
    wse, T = heat_member(rt, T0)
    np.testing.assert_array_equal(out[0], wse.make(answer=T,
                                                   options=cpu(backend="pallas")))
    assert out.shape == (1,) + T0.shape


def test_batched_plan_refuses_unstacked_fields():
    wse, T = heat_member(rt, member_inits(1)[0])
    p = port_engine.plan(wse.program, cpu(backend="pallas", batch=2))
    with pytest.raises(ValueError, match=r"\(2, X, Y, Z\) stacks"):
        port_engine.execute(p, {"T_e": T.init_data})


@pytest.mark.parametrize("time_tile", [1, 4])
def test_ensemble_make_matches_reference(time_tile):
    """The port's Ensemble.make against repro.Ensemble.make on the same
    members (the reference's pallas in interpret mode)."""
    inits = member_inits(3, seed=7)
    steps = 8
    ens_ref = ref.Ensemble.from_programs([heat_member(ref, T0, steps)
                                          for T0 in inits])
    want = ens_ref.make(options=RefOptions(backend="pallas",
                                           time_tile=time_tile))
    ens = rt.Ensemble.from_programs([heat_member(rt, T0, steps)
                                     for T0 in inits])
    got = ens.make(options=cpu(backend="pallas", time_tile=time_tile))
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 2 * steps * float(np.spacing(np.abs(want).max()))
    assert np.abs(got.astype(np.float64) - want).max() <= tol


# -- Ensemble construction ----------------------------------------------------

def _raises_alike(make, match):
    """``make(pkg)`` raises ValueError matching ``match`` in both packages."""
    for pkg in (ref, rt):
        with pytest.raises(ValueError, match=match):
            make(pkg)


def test_from_programs_rejects_structural_mismatch():
    (T0,) = member_inits(1)
    _raises_alike(lambda m: m.Ensemble.from_programs(
        [heat_member(m, T0, steps=5), heat_member(m, T0, steps=6)]),
        "structurally different")
    _raises_alike(lambda m: m.Ensemble.from_programs(
        [heat_member(m, T0), heat_member(m, T0, c=0.2)]),
        "structurally different")
    _raises_alike(lambda m: m.Ensemble.from_programs(
        [heat_member(m, T0), (heat_member(m, T0)[0], "other")]),
        "disagree on the answer")
    _raises_alike(lambda m: m.Ensemble.from_programs([]), "at least one")


def test_ensemble_override_validation():
    (T0,) = member_inits(1)
    for overrides, match in (({}, "batch="),
                             ({"T_e": np.zeros((8, 9, 6))}, "stack"),
                             ({"T_e": np.zeros((2, 8, 9, 5))}, "stack"),
                             ({"nope": np.zeros((2, 8, 9, 6))}, "not a field")):
        _raises_alike(lambda m: m.Ensemble(heat_member(m, T0)[0].program,
                                           "T_e", overrides=overrides), match)
    _raises_alike(lambda m: m.Ensemble(heat_member(m, T0)[0].program, "T_e",
                                       overrides={"T_e": np.zeros((2, 8, 9, 6))},
                                       batch=3), "expected 3")
    _raises_alike(lambda m: m.Ensemble(heat_member(m, T0)[0].program, "nope",
                                       overrides={}, batch=2), "answer field")


def test_ensemble_infers_batch_and_options():
    inits = member_inits(4, seed=9)
    for m, opts in ((ref, RefOptions), (rt, RunOptions)):
        wse, T = heat_member(m, inits[0])
        ens = m.Ensemble(wse.program, T, overrides={"T_e": np.stack(inits)})
        assert ens.batch == 4 and ens.answer == "T_e"
        assert ens.stacked_env()["T_e"].shape == (4, 8, 9, 6)
        assert ens._options(None).batch == 4
        assert ens._options("jit").backend == "jit"
        with pytest.raises(ValueError, match="conflicts"):
            ens._options(opts(batch=3))
    wse, T = heat_member(rt, inits[0])
    ens = rt.Ensemble(wse.program, T, overrides={}, batch=2)
    assert ens.stacked_env()["T_e"].shape == (2, 8, 9, 6)


def test_module_level_entry_points_dispatch():
    inits = member_inits(2, seed=10)
    ens = rt.Ensemble.from_programs([heat_member(rt, T0) for T0 in inits])
    with pytest.raises(ValueError, match="already carries"):
        rt.make(ens, "T_e")
    with pytest.raises(ValueError, match="already carries"):
        rt.solve(ens, "T_e")
    with pytest.raises(TypeError, match="expects an Ensemble"):
        rt.make(object(), "T_e")
    with pytest.raises(TypeError, match="expects an Ensemble"):
        rt.solve(object(), "T_e")
    wse, _ = heat_member(rt, inits[0])
    with pytest.raises(ValueError, match="needs the answer"):
        rt.make(wse.program)
    wse, T = heat_member(rt, inits[0])
    single = rt.make(wse.program, "T_e", options=cpu(backend="jit"))
    np.testing.assert_array_equal(rt.make(ens, options=cpu(backend="jit"))[0],
                                  single)


def test_ensemble_docstring_example_runs():
    res = doctest.testmod(importlib.import_module("repro_torch.core.ensemble"))
    assert res.attempted > 0 and res.failed == 0, res


# -- the halo-resident layout over member stacks ------------------------------

def test_layout_on_member_stacks_equals_single_calls(rng):
    """enter / exit / wrap_refresh of a (B, …) stack equal B single calls
    (and the reference's layout on the stack) bit for bit."""
    stack = torch.tensor(rng.normal(size=(3, 7, 9, 5)).astype(np.float32))
    lay = HaloLayout(pad=3, shapes={"a": (7, 9, 5)})
    entered = lay.enter({"a": stack})["a"]
    assert tuple(entered.shape) == (3, 13, 15, 5)
    for b in range(3):
        assert torch.equal(entered[b], lay.enter({"a": stack[b]})["a"])
    for h in (1, 2, 3):
        refreshed = wrap_refresh(entered.clone(), 3, h)
        for b in range(3):
            assert torch.equal(refreshed[b], wrap_refresh(entered[b].clone(),
                                                          3, h))
    ref_entered = RefLayout(pad=3, shapes={"a": (7, 9, 5)}).enter(
        {"a": stack.numpy()})["a"]
    np.testing.assert_array_equal(entered.numpy(), np.asarray(ref_entered))
    back = lay.exit({"a": entered})["a"]
    assert torch.equal(back, stack) and back.is_contiguous()
    assert torch.equal(_wrap_pad(stack, 2)[1], _wrap_pad(stack[1], 2))


# -- K1's plain version over members ------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("mode", ["padded", "margin"])
@pytest.mark.parametrize("name", ["heat", "hazard", "wide_halo2_mixed_nz"])
def test_batched_plain_version_equals_single_launches(name, mode, k):
    """fused_step_ref and fused_sweep_ref of a kernel built for B = 3 on
    (3, …) stacks equal the single kernel on each member, bit for bit;
    margin mode writes each member's interior only."""
    envs = []
    for seed in range(3):
        wse, env = k1_body(rt.core, name, np.float64, seed=seed)
        prog = wse.program
        wse.__exit__()
        envs.append(env)
    group = lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(
        group, {n: f.shape for n, f in prog.fields.items()},
        {n: f.dtype for n, f in prog.fields.items()})
    M = k * group.halo + 1 if mode == "margin" else 0
    kerns = {B: build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                 ny, time_tile=k, wrap=True, device="cpu",
                                 margin=M, batch=B)[0] for B in (1, 3)}
    single, batched = kerns[1], kerns[3]
    assert batched.stacked((2, 2, 2)) == (3, 2, 2, 2)

    def inputs(env):
        ins = []
        for n in single.in_names:
            t = torch.tensor(env[n])
            if M:
                t = wrap_refresh(HaloLayout(pad=M, shapes={}).enter({n: t})[n],
                                 M, single.pad)
            else:
                t = _wrap_pad(t, single.pad) if single.pad else t
            ins.append(t)
        return ins

    per = [inputs(env) for env in envs]
    stacked = [torch.stack(ts) for ts in zip(*per)]

    def outs(ins):
        if not M:
            return None
        return [torch.full_like(ins[single.in_names.index(n)], -7.0)
                for n in single.written]

    for fn in (fused_step_ref, fused_sweep_ref):
        got = fn(batched, stacked, out=outs(stacked))
        for b in range(3):
            want = fn(single, per[b], out=outs(per[b]))
            for g, w in zip(got, want):
                assert torch.equal(g[b], w), (fn.__name__, b)
    bad_out = M and [torch.stack([o] * 3) for o in outs(per[0])]
    with pytest.raises(ValueError, match="not a stack"):
        fused_step_ref(batched, per[0], out=bad_out or None)


def test_build_refuses_a_batch_outside_the_grid_limit():
    wse, _ = k1_body(rt.core, "heat", np.float32)
    group = lower_group(wse.program.ops)
    wse.__exit__()
    for B in (0, 65536):
        with pytest.raises(ValueError, match="batch"):
            build_fused_call(group.updates, {"T": (14, torch.float32)},
                             group.halo, 10, 12, 10, 12, device="cpu", batch=B)


# -- masked batched Krylov ----------------------------------------------------

def varcoef_members(m, b=3, shape=(8, 8, 6), w=0.3):
    """The reference test's members: one structure, per-member diffusivity,
    so each member converges at its own rate."""
    T0 = heat_init(shape)
    coefs = [np.full(shape, 0.2 * (i + 1) ** 2, np.float32) for i in range(b)]
    members = []
    for C0 in coefs:
        wse, T, C = m.solver.record_varcoef_btcs(T0, C0, w)
        wse.__exit__()
        members.append((wse, T, C))
    return coefs, members


def _btcs_guesses(shape=(8, 8, 6), b=3):
    rng = np.random.default_rng(2)
    return np.stack([rng.uniform(250.0, 550.0, shape).astype(np.float32)
                     for _ in range(b)])


def _batched_solve(m, method, tol, maxiter=200):
    """``(x, info, singles)``: the batched solve in package ``m`` and, for
    the port, its B independent single solves."""
    opts = RefOptions(batch=3) if m is ref else cpu(batch=3)
    one = RefOptions() if m is ref else cpu()
    if method in ("cg", "pipecg"):
        shape = (8, 8, 6)
        prog = m.solver.btcs_program(shape, 0.15, init_data=heat_init(shape))
        x0s = _btcs_guesses(shape)
        x, info = m.solver.solve(prog, "T", method=method, tol=tol,
                                 maxiter=maxiter, options=opts,
                                 member_env={"T": x0s}, return_info=True)
        singles = [m.solver.solve(prog, "T", method=method, tol=tol,
                                  maxiter=maxiter, options=one,
                                  member_env={"T": x0s[b]}, return_info=True)
                   for b in range(3)]
    else:
        coefs, members = varcoef_members(m)
        wse, T, C = members[0]
        x, info = m.solver.solve(wse.program, T.name, method=method, tol=tol,
                                 maxiter=maxiter, options=opts,
                                 member_env={C.name: np.stack(coefs)},
                                 return_info=True)
        singles = [m.solver.solve(w.program, t.name, method=method, tol=tol,
                                  maxiter=maxiter, options=one,
                                  return_info=True)
                   for w, t, _ in members]
    return x, info, singles


@pytest.mark.parametrize("method", ["cg", "pipecg", "bicgstab"])
def test_batched_solve_matches_members_and_reference(method):
    tol = 1e-4
    port_engine.reset_stats()
    x, info, singles = _batched_solve(rt, method, tol)
    assert x.shape == (3,) + singles[0][0].shape
    iters = np.asarray(info.iterations)
    assert iters.shape == np.asarray(info.residual).shape == (1, 3)
    assert list(info.outcomes[0]) == ["CONVERGED"] * 3
    assert port_engine.stats.member_iterations == tuple(int(v) for v in iters[0])
    assert port_engine.stats.ensemble_runs == 1
    assert port_engine.stats.ensemble_members == 3
    for b, (xs, si) in enumerate(singles):
        assert np.abs(x[b].astype(np.float64) - xs).max() <= 10 * tol, b
        assert iters[0, b] == si.iterations[0]
    _, info_ref, _ = _batched_solve(ref, method, tol)
    np.testing.assert_array_equal(iters, np.asarray(info_ref.iterations))
    if method == "bicgstab":
        assert len(set(iters[0].tolist())) > 1, "members should converge apart"


@pytest.mark.parametrize("method", ["chebyshev", "jacobi"])
def test_batched_fixed_count_methods_report_per_member(method):
    shape = (8, 8, 6)
    prog = rt.solver.btcs_program(shape, 0.15, init_data=heat_init(shape))
    x0s = _btcs_guesses(shape)
    kw = dict(method=method, tol=5e-3, maxiter=60)
    x, info = rt.solver.solve(prog, "T", options=cpu(batch=3),
                              member_env={"T": x0s}, return_info=True, **kw)
    assert np.asarray(info.iterations).tolist() == [[60] * 3]
    for b in range(3):
        xs, si = rt.solver.solve(prog, "T", options=cpu(),
                                 member_env={"T": x0s[b]}, return_info=True,
                                 **kw)
        assert np.abs(x[b] - xs).max() <= 10 * kw["tol"]
        assert info.outcomes[0, b] == si.outcomes[0]


def test_converged_members_frozen_bitwise():
    """A member that converged early is bitwise the same whether the loop
    stops there or runs on for the slowest member."""
    coefs, members = varcoef_members(rt)
    wse, T, C = members[0]

    def run(maxiter):
        return rt.solver.solve(wse.program, T.name, method="bicgstab",
                               tol=1e-6, maxiter=maxiter, options=cpu(batch=3),
                               member_env={C.name: np.stack(coefs)},
                               return_info=True)

    x_all, info = run(200)
    iters = np.asarray(info.iterations)[0]
    fast, slow = int(np.argmin(iters)), int(np.argmax(iters))
    assert iters[fast] < iters[slow]
    x_cut, info_cut = run(int(iters[fast]))
    np.testing.assert_array_equal(x_cut[fast], x_all[fast])
    assert info_cut.outcomes[0, fast] == "CONVERGED"
    assert info_cut.outcomes[0, slow] == "MAXITER"


def test_ensemble_solve_through_the_top_level():
    """wfa.solve(ensemble, ...) with the guesses as overrides equals the
    solver entry with member_env=."""
    shape = (8, 8, 6)
    x0s = _btcs_guesses(shape)
    prog = rt.solver.btcs_program(shape, 0.15, init_data=heat_init(shape))
    ens = rt.Ensemble(prog, "T", overrides={"T": x0s})
    x = rt.solve(ens, method="cg", tol=1e-4, options=cpu())
    want = rt.solver.solve(prog, "T", method="cg", tol=1e-4,
                           options=cpu(batch=3), member_env={"T": x0s})
    np.testing.assert_array_equal(x, want)
    one = rt.Ensemble(prog, "T", overrides={"T": x0s[:1]})
    x1, info1 = one.solve(method="cg", tol=1e-4, options=cpu(),
                          return_info=True)
    assert x1.shape == (1,) + shape and info1.iterations.shape == (1, 1)


@pytest.mark.parametrize("kw", [{"method": "mg"},
                                {"method": "cg", "precondition": "mg"}])
def test_batched_multigrid_raises(kw):
    shape = (9, 9, 9)
    for m, opts in ((ref, RefOptions(batch=2)), (rt, cpu(batch=2))):
        prog = m.solver.btcs_program(shape, 0.15, init_data=heat_init(shape))
        with pytest.raises(ValueError, match="batch=1"):
            m.solver.solve(prog, "T", options=opts, **kw)
