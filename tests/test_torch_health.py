"""The PyTorch port's numerical health on the CPU, against the JAX reference.

The port's counterpart of ``tests/test_health.py``: each of its assertions
under the same name with ``_torch``, plus live runs of the reference where
the reference works.  Tolerances, and why:

* the explicit sentinels never touch the math: a guarded run
  (``check_finite=N``) equals its unguarded run bitwise on every backend,
  tile, layout, mesh, member count and the overlap split, and the port's
  guarded ``jit`` run equals the reference's under ``jax.disable_jit``
  bitwise (every op rounded on its own), with the same probe count;
* a trip raises the reference's ``step``, and its ``last_good`` equals
  the unguarded run at the last probed step bitwise (port) and the
  reference's ``last_good`` bitwise (``T ← 4·T`` and the heat body under
  ``disable_jit``);
* solves: the same outcome words and first-detection iterations as the
  reference's (the taxonomy is a word, not a float);
* the recovery ladder is held to ``test_health.py``'s assertions as
  written, not to a live reference run: the reference's float64 rung
  imports ``jax.experimental.enable_x64``, which this JAX lacks.
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

import repro as ref
import repro_torch as wfa
from conftest import heat_init
from repro.engine import reset_stats as ref_reset_stats
from repro.engine import stats as ref_stats
from repro.solver.api import solve as ref_solve
from repro.solver.presets import record_btcs as ref_record_btcs
from repro_torch.core.mesh import make_mesh
from repro_torch.engine import RunOptions, health as ehealth, reset_stats, stats
from repro_torch.solver import (GuardConfig, NumericalFault, RecoveryPolicy,
                                health, krylov)
from repro_torch.solver.api import solve
from repro_torch.solver.presets import record_btcs

METHODS = ("cg", "pipecg", "bicgstab", "chebyshev", "jacobi")
CPU = dict(device="cpu")


def poisoned_T0(shape=(8, 8, 6)):
    T0 = np.full(shape, 500.0, np.float32)
    T0[1:-1, 1:-1, 0] = 300.0
    T0[shape[0] // 2, shape[1] // 2, shape[2] // 2] = np.nan
    return T0


def growth_program(n, init, m=wfa):
    """n steps of T <- 4·T: finite inits stay finite, 1e38 overflows at
    step 1 — a deterministic mid-run poisoning for the explicit sentinel."""
    wse = m.WFAInterface()
    T = m.Field("T", init_data=init)
    with m.ForLoop("t", n):
        T[:, 0, 0] = 4.0 * T[:, 0, 0]
    return wse, T


def heat_program(n, init, m=wfa, centre=0.4):
    """The Fig. 3 heat body (halo 1, rounding in every step); a ``centre``
    above 0.4 makes the field grow by ``centre + 0.6`` a step."""
    wse = m.WFAInterface()
    T = m.Field("T", init_data=init)
    with m.ForLoop("t", n):
        T[1:-1, 0, 0] = centre * T[1:-1, 0, 0] + 0.1 * (
            T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, -1, 0]
            + T[1:-1, 0, 1] + T[1:-1, 0, -1])
    return wse, T


def _make(build, n, init, m=wfa, **opts):
    """``make`` of ``build``'s program (an :class:`Ensemble` of the members
    of a ``(B, X, Y, Z)`` init); the program released on a fault."""
    from repro_torch.core.ensemble import Ensemble

    wse, T = build(n, init if init.ndim == 3 else init[0], m)
    options = (RunOptions(**CPU, **opts) if m is wfa
               else ref.RunOptions(**opts))
    try:
        if m is not wfa:
            return ref.make(wse, T, options=options)
        if init.ndim == 4:
            return Ensemble(wse.program, "T", {"T": init}).make(
                options=options.replace(batch=1))
        return wfa.make(wse, T, options=options)
    finally:
        wse.__exit__()


def _fault(build, n, init, m=wfa, **opts) -> NumericalFault:
    err = (NumericalFault if m is wfa else ref.NumericalFault)
    with pytest.raises(err) as exc:
        _make(build, n, init, m, **opts)
    return exc.value


def _dot(a, b):
    return torch.sum(a * b, dtype=torch.float32)


# -- taxonomy vocabulary ------------------------------------------------------


def test_outcome_vocabulary_torch():
    assert health.outcome_name(health.CONVERGED) == "CONVERGED"
    assert [health.outcome_name(c) for c in health.FAILURES] == [
        "NAN_RESIDUAL", "BREAKDOWN", "STAGNATED", "DIVERGED"]
    assert not health.is_failure(health.CONVERGED)
    assert not health.is_failure(health.MAXITER)
    assert health.any_failure(np.array([health.MAXITER]), on_maxiter=True)
    codes = [health.MAXITER, health.STAGNATED, health.DIVERGED,
             health.BREAKDOWN, health.NAN_RESIDUAL]
    assert health.worst(np.array(codes)) == health.NAN_RESIDUAL
    assert health.worst(np.array(codes[:2])) == health.STAGNATED
    assert list(health.outcome_names(np.array([0, 2]))) == [
        "CONVERGED", "NAN_RESIDUAL"]


# -- deterministic failure constructions at the krylov level ------------------


def test_bicgstab_rho_breakdown_torch():
    A = torch.tensor([[0.0, -1.0], [1.0, 0.0]])
    b = torch.tensor([1.0, 0.0])
    x, it, rr, st = krylov.bicgstab(lambda v: A @ v, _dot, b, torch.zeros(2),
                                    tol=1e-10, maxiter=50)
    assert health.outcome_name(int(st)) == "BREAKDOWN"
    assert int(it) <= 2


def test_stationary_stagnation_and_divergence_torch():
    rhs = torch.tensor([1.0, 0.0])
    rnorm2 = lambda x: _dot(rhs - x, rhs - x)  # noqa: E731
    x, it, rr, st = krylov.stationary(lambda x: x, rnorm2, torch.zeros(2),
                                      tol=1e-12, maxiter=1000)
    assert health.outcome_name(int(st)) == "STAGNATED"
    assert int(it) == health.DEFAULT_GUARD.stagnation_window
    x, it, rr, st = krylov.stationary(lambda x: 2.0 * x - rhs, rnorm2,
                                      torch.tensor([0.5, 0.0]),
                                      tol=1e-12, maxiter=1000)
    assert health.outcome_name(int(st)) == "DIVERGED"
    assert int(it) < 1000


def test_cg_nan_rhs_detected_at_entry_torch():
    A = torch.tensor([[2.0, 0.0], [0.0, 2.0]])
    bn = torch.tensor([float("nan"), 0.0])
    x, it, rr, st = krylov.cg(lambda v: A @ v, _dot, bn, torch.zeros(2),
                              tol=1e-10, maxiter=50)
    assert health.outcome_name(int(st)) == "NAN_RESIDUAL"
    assert int(it) == 0


def test_guard_config_knobs_torch():
    g = GuardConfig(divergence_factor=2.0, stagnation_window=3)
    rhs = torch.tensor([1.0, 0.0])
    rnorm2 = lambda x: _dot(rhs - x, rhs - x)  # noqa: E731
    x, it, rr, st = krylov.stationary(lambda x: x, rnorm2, torch.zeros(2),
                                      tol=1e-12, maxiter=1000, guard=g)
    assert health.outcome_name(int(st)) == "STAGNATED" and int(it) == 3


# -- no path returns non-finite CONVERGED (every method) ----------------------


@pytest.mark.parametrize("backend", ["jit", "pallas"])
@pytest.mark.parametrize("method", METHODS)
def test_poisoned_solve_is_labeled_torch(method, backend):
    """As the reference's test, and the same words and iteration counts as
    the reference's live solve."""
    wse, T = record_btcs(poisoned_T0(), 0.1)
    x, info = solve(wse.program, T, method=method, tol=1e-6, maxiter=60,
                    return_info=True,
                    options=RunOptions(backend=backend, **CPU))
    assert list(info.outcomes) == ["NAN_RESIDUAL"]
    assert not np.all(np.isfinite(x))  # honest: the answer really is sick
    assert "CONVERGED" not in info.outcomes
    rw, rT = ref_record_btcs(poisoned_T0(), 0.1)
    _, rinfo = ref_solve(rw.program, rT, method=method, tol=1e-6, maxiter=60,
                         return_info=True,
                         options=ref.RunOptions(backend="jit"))
    assert list(rinfo.outcomes) == list(info.outcomes)
    assert np.array_equal(np.asarray(rinfo.iterations), info.iterations)


def test_healthy_solve_unaffected_by_guard_torch():
    wse, T = record_btcs(np.full((8, 8, 6), 400.0, np.float32), 0.1)
    x, info = solve(wse.program, T, method="cg", tol=1e-6, maxiter=200,
                    return_info=True, options=RunOptions(backend="jit", **CPU))
    assert list(info.outcomes) == ["CONVERGED"]
    assert np.all(np.isfinite(x))


def test_poisoned_solve_fp64_torch():
    """The reference's float64 subprocess case: torch needs no x64 switch."""
    T0 = np.full((8, 8, 6), 500.0, np.float64)
    T0[1:-1, 1:-1, 0] = 300.0
    T0[4, 4, 3] = np.inf
    wse, T = record_btcs(T0, 0.1)
    x, info = solve(wse.program, T, method="cg", tol=1e-10, maxiter=60,
                    return_info=True, options=RunOptions(backend="jit", **CPU))
    assert info.outcomes[0] == "NAN_RESIDUAL" and not np.all(np.isfinite(x))


def test_poisoned_solve_sharded_torch():
    """2×2 CPU mesh: the guard word travels through the bricks' psum
    reductions; recovery declines sharded solves with a one-attempt
    trace instead of silently re-running."""
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    T0 = np.full((8, 8, 6), 500.0, np.float32)
    T0[1:-1, 1:-1, 0] = 300.0
    T0[4, 4, 3] = np.nan
    wse, T = record_btcs(T0, 0.1)
    x, info = solve(wse.program, T, method="cg", tol=1e-6, maxiter=60,
                    return_info=True,
                    options=RunOptions(backend="jit", mesh=mesh, **CPU))
    assert info.outcomes[0] == "NAN_RESIDUAL" and not np.all(np.isfinite(x))
    wse2, T2 = record_btcs(T0, 0.1)
    with pytest.raises(NumericalFault) as exc:
        solve(wse2.program, T2, method="cg", tol=1e-6, maxiter=60,
              options=RunOptions(backend="pallas", mesh=mesh,
                                 recovery=RecoveryPolicy(), **CPU))
    assert exc.value.outcome == "NAN_RESIDUAL"
    assert len(exc.value.trace.attempts) == 1


def test_batched_poison_isolated_per_member_torch():
    T0 = np.full((8, 8, 6), 500.0, np.float32)
    T0[1:-1, 1:-1, 0] = 300.0
    stack = np.broadcast_to(T0, (4,) + T0.shape).copy()
    stack[2, 4, 4, 3] = np.nan
    wse, T = record_btcs(T0, 0.1)
    xb, infob = solve(wse.program, T, method="cg", tol=1e-6, maxiter=300,
                      return_info=True, member_env={"T": stack},
                      options=RunOptions(backend="jit", batch=4, **CPU))
    wse2, T2 = record_btcs(T0, 0.1)
    xr, infor = solve(wse2.program, T2, method="cg", tol=1e-6, maxiter=300,
                      return_info=True,
                      options=RunOptions(backend="jit", batch=4, **CPU))
    outs = np.asarray(infob.outcomes).ravel().tolist()
    assert outs == ["CONVERGED", "CONVERGED", "NAN_RESIDUAL", "CONVERGED"]
    assert not np.all(np.isfinite(xb[2]))
    for i in (0, 1, 3):
        assert np.array_equal(xb[i], xr[i])
    assert int(np.asarray(infob.iterations).ravel()[2]) == 0
    # a batched solve gets no ladder either: it fails loud
    wse3, T3 = record_btcs(T0, 0.1)
    with pytest.raises(NumericalFault) as exc:
        solve(wse3.program, T3, method="cg", tol=1e-6, maxiter=300,
              member_env={"T": stack},
              options=RunOptions(backend="jit", batch=4,
                                 recovery=RecoveryPolicy(), **CPU))
    assert len(exc.value.trace.attempts) == 1


# -- the recovery ladder ------------------------------------------------------


def overflow_T0(shape=(10, 10, 6)):
    """Amplitudes whose dots overflow fp32 (|b|^2 ~ 1e41·N > 3.4e38) but
    sit comfortably inside fp64 — the fp32 attempt NaNs, fp64 converges."""
    T0 = np.full(shape, 5.0e20, np.float32)
    T0[1:-1, 1:-1, 0] = 3.0e20
    return T0


@pytest.mark.parametrize("backend", ["jit", "pallas"])
def test_recovery_ladder_reaches_fp64_torch(backend):
    wse, T = record_btcs(overflow_T0(), 0.1)
    reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x, info = solve(wse.program, T, method="cg", tol=1e-6, maxiter=200,
                        return_info=True,
                        options=RunOptions(backend=backend,
                                           recovery=RecoveryPolicy(), **CPU))
    trace = info.recovery
    assert trace is not None and trace.succeeded
    assert list(info.outcomes) == ["CONVERGED"]
    assert x.dtype == np.float32 and np.all(np.isfinite(x))
    assert [a.method for a in trace.attempts] == ["cg", "bicgstab", "cg"]
    assert [a.dtype for a in trace.attempts] == ["float32", "float32",
                                                 "float64"]
    assert [a.outcome for a in trace.attempts] == [
        "NAN_RESIDUAL", "NAN_RESIDUAL", "CONVERGED"]
    assert stats.recovery_attempts == 2
    assert stats.numerical_faults == 0


def test_recovery_exhausted_raises_with_trace_torch():
    wse, T = record_btcs(poisoned_T0(), 0.1)
    reset_stats()
    with pytest.raises(NumericalFault) as exc:
        solve(wse.program, T, method="cg", tol=1e-6, maxiter=60,
              options=RunOptions(backend="jit", recovery=RecoveryPolicy(),
                                 **CPU))
    e = exc.value
    assert e.outcome == "NAN_RESIDUAL"
    assert len(e.trace.attempts) == 3  # initial + escalate + fp64
    assert not e.trace.succeeded
    assert stats.numerical_faults == 1
    assert "NAN_RESIDUAL" in stats.solve_outcomes


def test_recovery_policy_off_rungs_torch():
    wse, T = record_btcs(poisoned_T0(), 0.1)
    pol = RecoveryPolicy(max_restarts=0, escalate=False, safe_mode_fp64=False)
    with pytest.raises(NumericalFault) as exc:
        solve(wse.program, T, method="cg", tol=1e-6, maxiter=60,
              options=RunOptions(backend="jit", recovery=pol, **CPU))
    assert len(exc.value.trace.attempts) == 1


def test_recovery_restarts_after_breakdown_torch():
    """The restart rung: a BREAKDOWN restarts the same method from the
    current iterate once (``max_restarts=1``) before escalating."""
    from repro_torch.solver import api

    trace_calls = []
    real = api.make_solver

    def spy(prog, name, **kw):
        trace_calls.append(kw["method"])
        return real(prog, name, **kw)

    wse, T = record_btcs(poisoned_T0(), 0.1)
    first = (np.asarray(wse.program.fields["T"].init_data),
             np.zeros(1, np.int32), np.ones(1), np.array([health.BREAKDOWN]))
    kwargs = dict(method="bicgstab", backend="jit", tol=1e-6, maxiter=60,
                  steps=1, lambda_bounds=None, precondition=None,
                  mg_opts=None, member_env={}, device="cpu")
    api.make_solver = spy
    try:
        with pytest.raises(NumericalFault) as exc:
            api._recover_solve(wse.program, "T", first, first[0],
                               RecoveryPolicy(), kwargs)
    finally:
        api.make_solver = real
        wse.__exit__()
    reasons = [a.reason for a in exc.value.trace.attempts]
    assert reasons[:2] == ["initial", "restart 1 after BREAKDOWN"]
    assert trace_calls[0] == "bicgstab"


# -- explicit-path sentinels --------------------------------------------------


def test_guarded_run_bitwise_parity_and_amortized_probes_torch():
    init = np.full((8, 8, 4), 1.0e-3, np.float32)
    ref_out = _make(growth_program, 32, init, backend="jit")
    reset_stats()
    out = _make(growth_program, 32, init, backend="jit", check_finite=8)
    assert np.array_equal(ref_out, out)
    assert stats.health_probes <= 32 // 8 + 2
    assert stats.numerical_faults == 0
    # the reference counts the same probes
    ref_reset_stats()
    with jax.disable_jit():
        want = _make(growth_program, 32, init, ref, backend="jit",
                     check_finite=8)
    assert np.array_equal(np.asarray(want), out)
    assert ref_stats.health_probes == stats.health_probes


def test_guarded_run_trips_with_last_good_state_torch():
    w = np.full((8, 8, 4), 1.0e38, np.float32)
    reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        e = _fault(growth_program, 32, w, backend="jit", check_finite=4)
    assert e.step == 4  # first probe after the step-1 overflow
    assert e.last_good is not None
    assert np.all(np.isfinite(e.last_good["T"]))
    assert stats.numerical_faults == 1
    r = _fault(growth_program, 32, w, ref, backend="jit", check_finite=4)
    assert r.step == e.step
    assert np.array_equal(r.last_good["T"], e.last_good["T"])


def test_guarded_run_poisoned_entry_faults_at_step_zero_torch():
    bad = np.full((8, 8, 4), 1.0, np.float32)
    bad[2, 2, 2] = np.nan
    e = _fault(growth_program, 8, bad, backend="jit", check_finite=2)
    assert e.step == 0
    assert e.last_good is None


def test_numpy_backend_sentinel_torch():
    with np.errstate(over="ignore"):
        e = _fault(growth_program, 32, np.full((8, 8, 4), 1.0e38, np.float32),
                   backend="numpy", check_finite=4)
    assert e.step == 4


def test_explicit_deescalation_retries_conservative_schedule_torch():
    reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _fault(growth_program, 32, np.full((8, 8, 4), 1.0e38, np.float32),
               backend="pallas", check_finite=4, time_tile=4,
               recovery=RecoveryPolicy())
    assert stats.recovery_attempts == 1
    assert stats.numerical_faults == 2


def test_guarded_pallas_tiled_parity_torch():
    init = np.full((8, 8, 4), 1.0e-3, np.float32)
    want = _make(growth_program, 16, init, backend="pallas", time_tile=4)
    out = _make(growth_program, 16, init, backend="pallas", time_tile=4,
                check_finite=8)
    assert np.array_equal(want, out)


# -- the port's guarded runs, every layout ------------------------------------

#: (backend, time_tile, resident, overlap, mesh shape, members)
GUARDED = [
    ("jit", None, True, "auto", None, 1),
    ("pallas", 1, True, "auto", None, 1),
    ("pallas", None, True, "auto", None, 1),
    ("pallas", 4, True, "auto", None, 1),
    ("pallas", 4, False, "auto", None, 1),
    ("pallas", 1, True, True, None, 1),
    ("pallas", 1, True, "auto", (2, 2), 1),
    ("pallas", None, True, "auto", (2, 2), 1),
    ("pallas", 4, False, "auto", (2, 2), 1),
    ("pallas", 1, True, True, (2, 2), 1),
    ("pallas", 1, True, "auto", None, 3),
    ("pallas", None, True, "auto", None, 3),
    ("jit", None, True, "auto", (2, 2), 1),
]


def _opts(backend, k, resident, overlap, mesh, batch, **kw):
    return dict(backend=backend, time_tile=k, resident=resident,
                overlap=overlap, batch=batch,
                mesh=None if mesh is None else make_mesh(mesh, device="cpu"),
                **kw)


def _members(init, batch):
    if batch == 1:
        return init
    return np.stack([init * (1.0 + 0.1 * b) for b in range(batch)])


@pytest.mark.parametrize("case", GUARDED, ids=str)
def test_guarded_run_equals_unguarded_torch(case):
    """A guarded run with no fault is the unguarded run bit for bit, with
    the reference's chunking of probes: the entry probe, one per full
    chunk and one for the tail."""
    init = _members(heat_init((8, 12, 6)), case[-1])
    want = _make(heat_program, 37, init, **_opts(*case))
    reset_stats()
    got = _make(heat_program, 37, init, **_opts(*case, check_finite=8))
    assert np.array_equal(want, got)
    k = 1 if case[1] is None and case[0] == "jit" else case[1]
    if k is not None:
        per = max(1, -(-8 // k))
        full, tail = divmod(37 // k, per)
        chunks = full + (tail > 0) + (37 % k > 0 and k > 1)
        assert stats.health_probes == 1 + chunks


@pytest.mark.parametrize("case", [c for c in GUARDED if c[-1] == 1], ids=str)
def test_guarded_fault_last_good_is_the_unguarded_run_torch(case):
    """One cell overflows in the middle of the run: the fault carries the
    first probed step after it, and ``last_good`` equals the unguarded run
    stopped at the last probed-good step, bit for bit (on a resident plan
    the ping-pong buffers are rebuilt by replaying from the chunk run's
    retained entry)."""
    init = np.full((8, 12, 6), 1.0, np.float32)
    init[3, 5, 2] = 3.0e38 / 4.0 ** 11  # overflows at step 12 under 4·T
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        e = _fault(growth_program, 40, init, **_opts(*case, check_finite=3))
        assert e.step >= 12
        good = int(str(e).split("last finite probe at step ")[1].rstrip(")"))
        assert 0 < good < 12
        want = _make(growth_program, good, init, **_opts(*case))
    assert np.array_equal(want, e.last_good["T"])


def test_guarded_heat_last_good_matches_reference_torch():
    """A rounding body: the port's guarded jit run faults at the
    reference's step with the reference's ``last_good``, bit for bit
    (reference under ``jax.disable_jit``)."""
    init = heat_init((8, 8, 6))
    init[4, 4, 3] = np.inf  # spreads; the entry probe trips
    e = _fault(heat_program, 12, init, backend="jit", check_finite=5)
    assert e.step == 0 and e.last_good is None
    grow = functools.partial(heat_program, centre=1.3)  # × 1.9 a step
    init = heat_init((8, 8, 6)) * 1.0e33  # overflows at step 10 or so
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        e = _fault(grow, 20, init, backend="jit", check_finite=5)
        with jax.disable_jit():
            r = _fault(grow, 20, init, ref, backend="jit", check_finite=5)
    assert e.step == r.step and e.step in (10, 15)
    assert np.array_equal(np.asarray(r.last_good["T"]), e.last_good["T"])


def test_guarded_entry_points_torch():
    """run_program, Ensemble.make and run_sharded take the sentinel too."""
    from repro_torch.core.ensemble import Ensemble
    from repro_torch.engine import run_program

    init = heat_init((8, 8, 6))
    wse, T = heat_program(9, init)
    wse.__exit__()
    out = run_program(wse.program, options=RunOptions(
        backend="pallas", check_finite=4, **CPU))
    want = run_program(wse.program, options=RunOptions(backend="pallas", **CPU))
    assert np.array_equal(out["T"], want["T"])
    ens = Ensemble(wse.program, "T", {"T": np.stack([init, init + 1.0])})
    got = ens.make(options=RunOptions(backend="pallas", check_finite=4, **CPU))
    ref_ens = ens.make(options=RunOptions(backend="pallas", **CPU))
    assert np.array_equal(np.asarray(got), np.asarray(ref_ens))
    mesh = make_mesh((2, 2), device="cpu")
    got = wfa.run_sharded(wse.program, {"T": init}, mesh, options=RunOptions(
        backend="pallas", check_finite=4, **CPU))
    assert np.array_equal(got["T"], want["T"])


# -- engine.health on every env form ------------------------------------------


def test_probe_on_tensors_arrays_and_bricks_torch():
    from repro_torch.core.mesh import NamedSharding

    a = np.ones((4, 4, 3), np.float32)
    b = a.copy()
    b[1, 2, 0] = np.nan
    mesh = make_mesh((2, 2), device="cpu")
    bricks = lambda x: list(NamedSharding(mesh).shard(x).bricks)  # noqa: E731
    for env_ok, env_bad in (({"A": a, "B": a}, {"A": a, "B": b}),
                            ({"A": torch.tensor(a)}, {"A": torch.tensor(b)}),
                            ({"A": bricks(a)}, {"A": bricks(b), "C": a})):
        reset_stats()
        assert ehealth.probe(env_ok) and not ehealth.probe(env_bad)
        assert stats.health_probes == 2
        assert ehealth.probe_ok(env_ok).dtype == torch.bool
        assert ehealth.poisoned_fields(env_bad) == ["A" if "C" in env_bad
                                                    else list(env_bad)[-1]]
    assert ehealth.NumericalFault is NumericalFault


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_held_probe_matches_probe_ok_torch(value):
    """The held-buffer probe a service request runs once per chunk gives
    :func:`probe_ok`'s verdict (exact: a verdict is a word) on a field, a
    strided view, 2×2 bricks, a member stack and a float64 field beside
    float32 ones, for a bad value in every part; one probe serves a
    clean env again after a poisoned one."""
    from repro_torch.core.mesh import NamedSharding

    rng = np.random.default_rng(5)
    mesh = make_mesh((2, 2), device="cpu")
    a = rng.uniform(300.0, 500.0, (6, 8, 5)).astype(np.float32)
    padded = torch.tensor(rng.uniform(size=(8, 10, 5)).astype(np.float32))
    env = {"T": torch.tensor(a), "V": padded[1:-1, 1:-1],
           "U": list(NamedSharding(mesh).shard(a).bricks),
           "M": torch.tensor(rng.uniform(size=(3, 6, 8, 5))),
           "W": torch.tensor(a[..., :3])}
    probe = ehealth.HeldProbe(env)
    assert probe(env) and bool(ehealth.probe_ok(env))
    spots = {"T": (5, 7, 4), "V": (0, 0, 0), "M": (2, 1, 3, 0), "W": (3, 0, 2)}
    for name in env:
        bad = {n: ([b.clone() for b in v] if isinstance(v, list) else v.clone())
               for n, v in env.items()}
        if name == "U":
            bad["U"][3][1, 2, 4] = float(value)
        else:
            bad[name][spots[name]] = float(value)
        assert not bool(ehealth.probe_ok(bad)), name
        assert not probe(bad), name
        assert probe(env), name
