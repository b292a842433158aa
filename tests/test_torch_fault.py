"""The port's fault-tolerance primitives on the CPU, against the JAX reference.

The counterparts of ``tests/test_fault.py``'s heartbeat, resilient-loop,
injector and fail-fast tests, each under its name with ``_torch`` (its
``remesh`` / ``shrink_plan`` tests are in ``tests/test_torch_elastic.py``).
``repro_torch.runtime.fault`` is framework-free Python, so
there is no tolerance: the same scripted inputs give the same flags,
failures, restores and fired faults as the reference, exactly, and the
parity tests below drive both packages with one script and compare.  The
injector is bound to the port's own hooks (``repro_torch.engine.hooks``)
and raises the port's ``LoweringError``.
"""

import numpy as np
import pytest

import repro.engine.hooks as ref_hooks
import repro.runtime.fault as ref_fault
import repro_torch.runtime.fault as port_fault
from repro_torch.compiler import LoweringError
from repro_torch.engine import hooks
from repro_torch.runtime.fault import (
    FaultInjector,
    HeartbeatMonitor,
    InjectedFault,
    ResilientLoop,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- HeartbeatMonitor ---------------------------------------------------------


def _run_steps(mon, clock, durations):
    for i, dt in enumerate(durations):
        mon.start_step(i)
        clock.advance(dt)
        mon.end_step()


def test_heartbeat_threshold_is_a_strict_boundary_torch():
    clock = FakeClock()
    flags = []
    mon = HeartbeatMonitor(
        threshold=3.0, on_straggler=lambda s, r: flags.append((s, r)),
        clock=clock,
    )
    # history of 1.0s steps, then exactly 3.0x the median: NOT flagged
    _run_steps(mon, clock, [1.0, 1.0, 1.0, 3.0])
    assert mon.flagged == [] and flags == []
    # strictly above the boundary: flagged, with the ratio reported
    mon.start_step(4)
    clock.advance(3.5)
    mon.end_step()
    assert mon.flagged == [4]
    assert flags == [(4, pytest.approx(3.5))]


def test_heartbeat_first_step_never_flags_torch():
    clock = FakeClock()
    mon = HeartbeatMonitor(threshold=1.01, clock=clock)
    _run_steps(mon, clock, [1000.0])  # no history yet -> no median to trail
    assert mon.flagged == []


def test_heartbeat_median_window_slides_torch():
    clock = FakeClock()
    mon = HeartbeatMonitor(threshold=2.0, window=4, clock=clock)
    # slow history ages out of the window; a 1.0s step against a 0.1s
    # recent median is a straggler even though the *global* median is not
    _run_steps(mon, clock, [5.0, 5.0, 5.0, 5.0, 0.1, 0.1, 0.1, 0.1])
    assert mon.flagged == []
    mon.start_step(8)
    clock.advance(1.0)
    mon.end_step()
    assert mon.flagged == [8]


def test_heartbeat_end_without_start_is_a_noop_torch():
    mon = HeartbeatMonitor(clock=FakeClock())
    mon.end_step()
    assert mon.durations == []


@pytest.mark.parametrize("threshold,window", [(3.0, 16), (2.0, 4), (1.5, 2)])
def test_heartbeat_flags_equal_the_reference(threshold, window):
    """One duration script through both monitors: the same flagged steps,
    ratios and duration history."""
    durations = np.random.default_rng(41).lognormal(0.0, 0.8, 64).tolist()
    got = []
    for mod in (ref_fault, port_fault):
        clock, ratios = FakeClock(), []
        mon = mod.HeartbeatMonitor(
            threshold=threshold, window=window, clock=clock,
            on_straggler=lambda s, r, out=ratios: out.append((s, r)))
        _run_steps(mon, clock, durations)
        got.append((mon.flagged, ratios, mon.durations))
    assert got[0] == got[1]
    assert got[1][0]  # the script does flag something


# -- ResilientLoop ------------------------------------------------------------


class _Dataset:
    def next_batch(self):
        return None


def _resilient(step_fn, max_failures=3, ckpt_every=2, mod=port_fault):
    saves = []
    restores = []

    def save_fn(step, state):
        saves.append((step, state))

    def restore_fn():
        restores.append(True)
        return (saves[-1][1], saves[-1][0]) if saves else (0, 0)

    loop = mod.ResilientLoop(
        step_fn, save_fn, restore_fn, _Dataset(),
        ckpt_every=ckpt_every, max_failures=max_failures,
    )
    return loop, saves, restores


def test_resilient_loop_restores_and_continues_torch():
    calls = []

    def step_fn(state, batch):
        calls.append(state)
        if state == 3 and calls.count(3) == 1:  # fail once at step 3
            raise RuntimeError("injected")
        return state + 1, {"loss": state}

    loop, saves, restores = _resilient(step_fn)
    state, step, metrics = loop.run(0, 0, 6)
    assert (state, step) == (6, 6)
    assert restores == [True]  # exactly one restore for one failure
    assert saves[0][0] == 2  # checkpointed before the failure
    assert loop.failures == 0  # success reset the consecutive-failure count


def test_resilient_loop_failure_budget_resets_on_success_torch():
    """2 failures, success, 2 failures stays under max_failures=2 because
    the counter is *consecutive*; 3 in a row without progress raises."""
    script = iter([False, True, True, False, True, True, False])

    def step_fn(state, batch):
        if next(script, False):
            raise RuntimeError("flaky")
        return state + 1, None

    loop, _, _ = _resilient(step_fn, max_failures=2, ckpt_every=1)
    state, step, _ = loop.run(0, 0, 3)
    assert (state, step) == (3, 3)

    def always_fail(state, batch):
        raise RuntimeError("dead")

    loop, _, _ = _resilient(always_fail, max_failures=2, ckpt_every=1)
    with pytest.raises(RuntimeError, match="dead"):
        loop.run(0, 0, 1)
    assert loop.failures == 3  # max_failures consecutive, then the raise


def test_resilient_loop_equals_the_reference():
    """A seeded failure script through both loops: the same final state,
    step, saves and restores."""
    fails = np.random.default_rng(43).random(40) < 0.3
    got = []
    for mod in (ref_fault, port_fault):
        script = iter(fails.tolist())

        def step_fn(state, batch, script=script):
            if next(script, False):
                raise RuntimeError("flaky")
            return state + 1, {"s": state}

        loop, saves, restores = _resilient(step_fn, max_failures=3,
                                           ckpt_every=3, mod=mod)
        state, step, metrics = loop.run(0, 0, 20)
        got.append((state, step, metrics, saves, len(restores),
                    loop.failures))
    assert got[0] == got[1]


# -- FaultInjector ------------------------------------------------------------


def test_injector_step_fault_fires_exactly_once_torch():
    with FaultInjector(fail_at=[2]) as inj:
        hooks.fire_step_hook(0)
        hooks.fire_step_hook(1)
        with pytest.raises(InjectedFault):
            hooks.fire_step_hook(2)
        hooks.fire_step_hook(2)  # the retry: armed step already consumed
    assert inj.fired == [("step", 2, "")]


def test_injector_match_tag_scopes_the_fault_torch():
    with FaultInjector(fail_at=[0], match_tag="victim") as inj:
        hooks.fire_step_hook(0, tag="bystander")
        with pytest.raises(InjectedFault):
            hooks.fire_step_hook(0, tag="victim")
    assert inj.fired == [("step", 0, "victim")]


def test_injector_compile_fault_raises_lowering_error_once_torch():
    with FaultInjector(fail_compile=["body"]) as inj:
        hooks.fire_compile_hook("other")  # not armed
        with pytest.raises(LoweringError, match="injected compile failure"):
            hooks.fire_compile_hook("body")
        hooks.fire_compile_hook("body")  # consumed
    assert inj.fired == [("compile", "body")]


def test_injector_restores_previous_hooks_torch():
    seen = []
    prev = hooks.set_step_hook(lambda step, tag="": seen.append(step))
    try:
        with FaultInjector(fail_at=[99]):
            pass
        hooks.fire_step_hook(7)
        assert seen == [7]  # the pre-injector hook is back
    finally:
        hooks.set_step_hook(prev)


def test_injector_slowdown_is_recorded_torch():
    with FaultInjector(slow_at={1: 0.0}) as inj:
        hooks.fire_step_hook(1)
        hooks.fire_step_hook(1)  # consumed: no second record
    assert inj.fired == [("slow", 1, "")]


def test_injector_binds_the_ports_hooks_only():
    """The port's injector arms ``repro_torch.engine.hooks`` and leaves the
    reference's hooks alone (and the other way round)."""
    with FaultInjector(fail_at=[0]):
        ref_hooks.fire_step_hook(0)  # not armed there
        with pytest.raises(InjectedFault):
            hooks.fire_step_hook(0)
    with ref_fault.FaultInjector(fail_at=[0]):
        hooks.fire_step_hook(0)
        with pytest.raises(ref_fault.InjectedFault):
            ref_hooks.fire_step_hook(0)


def test_injector_fires_as_the_reference():
    """One script of step, slow and compile events through both injectors
    (each on its own package's hooks): the same raises and ``fired``."""
    events = [("step", s, t) for s, t in
              [(0, "a"), (1, "b"), (2, "a"), (2, "a"), (3, "b"), (1, "b")]]
    events += [("compile", n) for n in ("x", "body", "body", "y")]
    got = []
    for mod, hk in ((ref_fault, ref_hooks), (port_fault, hooks)):
        raised = []
        with mod.FaultInjector(fail_at=[1, 2], slow_at={3: 0.0},
                               fail_compile=["body", "y"],
                               match_tag=None) as inj:
            for ev in events:
                try:
                    if ev[0] == "step":
                        hk.fire_step_hook(ev[1], tag=ev[2])
                    else:
                        hk.fire_compile_hook(ev[1])
                    raised.append(None)
                except Exception as e:  # noqa: BLE001 - compared below
                    raised.append(type(e).__name__)
        got.append((raised, inj.fired))
    assert got[0] == got[1]


# -- numerical faults vs infrastructure faults --------------------------------


def test_numerical_fault_fails_fast_never_retried_torch():
    """A poisoned solve fails deterministically: re-running it would only
    repoison, so the worker fails the ticket on the first
    ``NumericalFault`` with zero retries — while a transient injected
    fault on the very same service still restores and completes."""
    from repro_torch.engine.health import NumericalFault
    from repro_torch.service import (
        PlanSignature,
        SimulationService,
        SolveRequest,
        StepRequest,
    )

    solve_sig = PlanSignature("btcs_heat", (8, 8, 6))
    step_sig = PlanSignature("heat3d", (8, 8, 6))
    svc = SimulationService(
        workers=1, capacity=64, manifest=[solve_sig, step_sig],
        default_chunk=2, device="cpu",
    )
    svc.start()
    try:
        poison = np.full(solve_sig.shape, np.nan, solve_sig.dtype)
        t = svc.submit(SolveRequest(solve_sig, maxiter=40, init=poison))
        with pytest.raises(NumericalFault) as exc:
            t.result(timeout=300)
        assert exc.value.outcome == "NAN_RESIDUAL"
        assert t.stats.retries == 0  # fail fast: no retry budget burned
        assert t.stats.outcome == "NAN_RESIDUAL"

        req = StepRequest(step_sig, steps=4)
        with FaultInjector(fail_at=[2], match_tag=req.request_id):
            t2 = svc.submit(req)
            t2.result(timeout=300)
        assert t2.stats.retries == 1  # infrastructure faults still retry
    finally:
        svc.stop()
