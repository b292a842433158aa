"""The port's simulation service on the CPU, against the JAX reference.

The counterparts of ``tests/test_service.py`` (all 25, each under its name
with ``_torch``), of ``tests/test_checkpoint.py``'s kill-restore tests
(float32, float64 and sharded) and its signature-mismatch test, and of
``tests/test_ensemble.py``'s service tests, every service built with
``device="cpu"`` (K1 runs as its plain version here).  Tolerances, and
why:

* the port against itself: bitwise.  A chunk launches exactly what an
  uninterrupted run launches (tiled plans snap chunk boundaries to the
  tile), so service results, restored runs, micro-batched members, the
  2×2 mesh and four workers all equal the engine's ``run_program`` of the
  same recorded program;
* the port against the reference service: the same signatures, steps,
  inits and faults through both; each result within 2 ulp of the field's
  magnitude per step (the reference's XLA CPU compiler contracts
  ``a·b + c`` into FMA inside its interpret-mode kernel, the port rounds
  every operation on its own — ``tests/test_torch_engine.py``'s bound);
  a solve's outcome word and iteration count equal and its solution
  within ``3·tol`` plus 4 float32 ulp of the field's magnitude in every
  cell (each lies within ``tol / 0.7`` of the exact one — the BTCS
  operator's smallest eigenvalue is ≥ 0.7 — and a Kelvin-scale float32
  solution cannot be nearer than its rounding);
  ``service_stats()`` equal in every count — the timing fields
  (``mean_queue_wait_s``, ``stragglers``, which a first call's compile
  time moves, and the live ``service`` block) excluded;
* manifests: a manifest saved by either package warms the other — the
  same signature keys, and a request to the warmed signature a plan-cache
  hit.

The one deliberate difference, ``device``, is held too: with no card and
the default device, building a workload raises instead of falling back.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.engine as ref_engine
import repro.runtime.fault as ref_fault
import repro.service as ref_service
import repro_torch.compiler as port_compiler
import repro_torch.engine as port_engine
import repro_torch.service as port_service
from repro_torch.compiler import stats as kstats
from repro_torch.engine import RunOptions, hooks, reset_stats
from repro_torch.engine.stats import stats as estats
from repro_torch.runtime.fault import (FaultInjector, HeartbeatMonitor,
                                       InjectedFault)
from repro_torch.service import (
    DeadlineExceeded,
    PlanSignature,
    RequestFailed,
    ServiceOverloaded,
    SignatureScheduler,
    SimulationService,
    SolveRequest,
    StepRequest,
    Ticket,
    build_workload,
    get_workload,
    service_stats,
)
from repro_torch.service.__main__ import main as smoke_main
from test_ensemble import member_inits

CPU = "cpu"
SIGS = [
    PlanSignature("heat3d", (12, 10, 6)),
    PlanSignature("advdiff", (10, 10, 6)),
    PlanSignature("jacobi3d", (8, 8, 6), time_tile=2),
]
SOLVE_SIG = PlanSignature("btcs_heat", (8, 8, 6))


@pytest.fixture(scope="module")
def warm_service():
    reset_stats()
    svc = SimulationService(
        workers=2, capacity=512, manifest=SIGS + [SOLVE_SIG],
        default_chunk=4, device=CPU,
    )
    svc.start()
    yield svc
    svc.stop()


# -- request model ------------------------------------------------------------


def test_signature_key_and_json_roundtrip_torch():
    sig = PlanSignature("heat3d", (4, 5, 6), dtype="float64", time_tile=3)
    assert sig.key() == "heat3d:4x5x6:float64:k3:pallas"
    assert PlanSignature.from_json(sig.to_json()) == sig


def test_request_validation_torch():
    sig = SIGS[0]
    with pytest.raises(ValueError, match="shape must be"):
        PlanSignature("heat3d", (4, 5))
    with pytest.raises(ValueError, match="steps must be"):
        StepRequest(sig, steps=0)
    with pytest.raises(ValueError, match="requires an explicit ckpt_key"):
        StepRequest(sig, steps=1, resume=True)
    with pytest.raises(ValueError, match="init shape"):
        StepRequest(sig, steps=1, init=np.zeros((3, 3, 3), np.float32))
    with pytest.raises(KeyError, match="unknown workload"):
        get_workload("nope")


def test_ticket_timeout_torch():
    t = Ticket(StepRequest(SIGS[0], steps=1))
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    assert not t.done() and t.error() is None


@pytest.mark.parametrize("sig", [
    PlanSignature("heat3d", (4, 5, 6), dtype="float64", time_tile=3),
    PlanSignature("advdiff", (10, 10, 6), batch=8),
    PlanSignature("btcs_heat", (8, 8, 6), backend="jit"),
])
def test_signature_key_and_json_equal_the_reference(sig):
    """The port's key and JSON are the reference's, character for
    character, and each package reads the other's JSON."""
    ref = ref_service.PlanSignature.from_json(sig.to_json())
    assert ref.key() == sig.key()
    assert json.dumps(ref.to_json()) == json.dumps(sig.to_json())
    assert PlanSignature.from_json(ref.to_json()) == sig


# -- scheduler ----------------------------------------------------------------


def _ticket(sig=None, priority=0, deadline_s=None):
    return Ticket(
        StepRequest(
            sig or SIGS[0], steps=1, priority=priority, deadline_s=deadline_s
        )
    )


def test_scheduler_admission_bound_torch():
    sched = SignatureScheduler(capacity=2)
    sched.submit(_ticket())
    sched.submit(_ticket())
    with pytest.raises(ServiceOverloaded):
        sched.submit(_ticket())


def test_scheduler_priority_then_fifo_torch():
    sched = SignatureScheduler(group_max=1)
    lo1, hi, lo2 = _ticket(priority=0), _ticket(priority=5), _ticket(priority=0)
    for t in (lo1, hi, lo2):
        sched.submit(t)
    order = [sched.get_group(timeout=1)[0] for _ in range(3)]
    assert order == [hi, lo1, lo2]


def test_scheduler_groups_by_signature_torch():
    sched = SignatureScheduler(group_max=8)
    a1, b, a2 = _ticket(SIGS[0]), _ticket(SIGS[1]), _ticket(SIGS[0])
    for t in (a1, b, a2):
        sched.submit(t)
    group = sched.get_group(timeout=1)
    assert group == [a1, a2]  # same signature drained past the interloper
    assert sched.get_group(timeout=1) == [b]


def test_scheduler_group_max_caps_the_drain_torch():
    sched = SignatureScheduler(group_max=2)
    tickets = [_ticket() for _ in range(5)]
    for t in tickets:
        sched.submit(t)
    assert len(sched.get_group(timeout=1)) == 2
    assert len(sched) == 3


def test_scheduler_expires_overdue_requests_at_dispatch_torch():
    sched = SignatureScheduler()
    dead = _ticket(deadline_s=0.0)
    live = _ticket(SIGS[1])
    sched.submit(dead)
    sched.submit(live)
    group = sched.get_group(timeout=1)
    assert group == [live]
    assert sched.expired == [dead]
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=1)


def test_scheduler_close_drains_then_signals_exit_torch():
    sched = SignatureScheduler()
    t = _ticket()
    sched.submit(t)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_ticket())
    assert sched.get_group(timeout=1) == [t]  # queued work still served
    assert sched.get_group(timeout=1) == []  # then the exit signal


def test_scheduler_dispatch_order_equals_the_reference():
    """One seeded stream of priorities and signatures through both
    schedulers: the same groups, in the same order."""
    rng = np.random.default_rng(5)
    script = [(int(rng.integers(0, 3)), int(rng.integers(0, 3)))
              for _ in range(40)]
    orders = []
    for mod in (ref_service, None):
        Sched = mod.SignatureScheduler if mod else SignatureScheduler
        Sig = mod.PlanSignature if mod else PlanSignature
        Req = mod.StepRequest if mod else StepRequest
        Tk = mod.Ticket if mod else Ticket
        sched = Sched(group_max=4)
        for i, (prio, s) in enumerate(script):
            sig = Sig(SIGS[s].workload, SIGS[s].shape,
                      time_tile=SIGS[s].time_tile)
            sched.submit(Tk(Req(sig, steps=1, priority=prio,
                                request_id=f"r{i}")))
        groups = []
        while len(sched):
            groups.append([t.request.request_id
                           for t in sched.get_group(timeout=1)])
        orders.append(groups)
    assert orders[0] == orders[1]


# -- end-to-end serving -------------------------------------------------------


def _reference(sig: PlanSignature, steps: int, init=None) -> np.ndarray:
    """The port engine's own answer for a workload signature (no
    service)."""
    from repro_torch.engine.executor import run_program

    spec = get_workload(sig.workload)
    program, answer = spec.record(sig.shape, np.dtype(sig.dtype), steps)
    env = None
    if init is not None:
        env = {n: f.init_data for n, f in program.fields.items()}
        env[answer] = init
    out = run_program(program, env, options=RunOptions(
        backend=sig.backend, time_tile=sig.time_tile, device=CPU))
    return out[answer]


def test_serves_concurrent_mixed_stream_with_zero_compiles_torch(warm_service):
    svc = warm_service
    built = kstats.kernels_built
    tickets = []
    for i in range(64):
        if i % 8 == 7:
            tickets.append(svc.submit(SolveRequest(SOLVE_SIG, maxiter=40)))
        else:
            tickets.append(
                svc.submit(
                    StepRequest(SIGS[i % 3], steps=8, priority=i % 2)
                )
            )
    results = [t.result(timeout=300) for t in tickets]
    assert all(np.all(np.isfinite(np.asarray(r))) for r in results)
    assert len({t.stats.signature for t in tickets}) == 4
    # the warm-pool contract: no compiles, no plan builds, no retries
    assert kstats.kernels_built == built
    assert all(t.stats.plan_cache_hit for t in tickets)
    assert sum(t.stats.retries for t in tickets) == 0
    assert not any(t.stats.degraded for t in tickets)
    # per-request observability is populated
    st = tickets[0].stats
    assert st.steps == 8 and st.chunks == 2 and st.launches >= 2
    assert st.queue_wait_s >= 0.0 and st.latency_s > 0.0
    assert st.worker in (0, 1)
    # two workers, one answer: every step result bitwise the engine's
    for sig in SIGS:
        want = _reference(sig, 8)
        for t, r in zip(tickets, results):
            if t.request.signature == sig:
                assert (r == want).all(), sig.key()


def test_service_results_match_engine_bitwise_torch(warm_service):
    for sig in SIGS:
        t = warm_service.submit(StepRequest(sig, steps=9))
        out = t.result(timeout=300)
        ref = _reference(sig, 9)
        assert out.dtype == ref.dtype
        assert (out == ref).all(), sig.key()


def test_solve_request_converges_torch(warm_service):
    t = warm_service.submit(SolveRequest(SOLVE_SIG, tol=1e-5, maxiter=80))
    out = t.result(timeout=300)
    assert np.all(np.isfinite(out))
    assert t.stats.iterations >= 1
    assert t.stats.outcome == "CONVERGED"


def test_custom_init_overrides_default_torch(warm_service):
    sig = SIGS[0]
    init = np.full(sig.shape, 7.25, np.float32)
    t = warm_service.submit(StepRequest(sig, steps=1, init=init))
    out = t.result(timeout=300)
    assert not np.allclose(out, _reference(sig, 1))
    assert (out == _reference(sig, 1, init)).all()


def test_submit_requires_started_service_torch():
    svc = SimulationService(workers=1, device=CPU)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(StepRequest(SIGS[0], steps=1))


def test_rejected_submission_counts_torch(warm_service, monkeypatch):
    before = estats.requests_rejected

    def full(ticket):
        raise ServiceOverloaded("queue full (test)")

    monkeypatch.setattr(warm_service.scheduler, "submit", full)
    with pytest.raises(ServiceOverloaded):
        warm_service.submit(StepRequest(SIGS[0], steps=1))
    assert estats.requests_rejected == before + 1


# -- fault tolerance ----------------------------------------------------------


def test_injected_fault_completes_via_restore_torch(warm_service, tmp_path):
    warm_service.ckpt_root = str(tmp_path)
    req = StepRequest(SIGS[0], steps=8, ckpt_every=2)
    with FaultInjector(fail_at=[4], match_tag=req.request_id):
        t = warm_service.submit(req)
        out = t.result(timeout=300)
    assert (out == _reference(SIGS[0], 8)).all()  # still bitwise
    assert t.stats.retries == 1 and t.stats.restores == 1
    assert t.stats.checkpoints == 4


def test_fault_without_checkpoints_restarts_from_scratch_torch(warm_service):
    req = StepRequest(SIGS[1], steps=8)
    with FaultInjector(fail_at=[4], match_tag=req.request_id):
        t = warm_service.submit(req)
        out = t.result(timeout=300)
    assert (out == _reference(SIGS[1], 8)).all()
    assert t.stats.retries == 1 and t.stats.restores == 0


def test_retry_budget_exhaustion_fails_the_ticket_torch(warm_service):
    req = StepRequest(SIGS[0], steps=4)

    def always_fail(step, tag=""):
        if tag == req.request_id:
            raise InjectedFault("permanent injected fault")

    failed_before = estats.requests_failed
    prev = hooks.set_step_hook(always_fail)
    try:
        t = warm_service.submit(req)
        with pytest.raises(RequestFailed, match="after 3 retries"):
            t.result(timeout=300)
    finally:
        hooks.set_step_hook(prev)
    assert t.stats.retries == warm_service.max_retries + 1
    assert estats.requests_failed == failed_before + 1


def test_permanent_errors_do_not_burn_retries_torch(warm_service):
    t = warm_service.submit(
        SolveRequest(SOLVE_SIG, method="not-a-method", maxiter=5)
    )
    with pytest.raises((ValueError, KeyError)):
        t.result(timeout=300)
    assert t.stats.retries == 0


def test_compile_failure_serves_degraded_and_logged_torch(warm_service,
                                                          caplog):
    degraded_sig = PlanSignature("advdiff", (11, 11, 6))  # plan-cache miss
    fb_before = kstats.fallbacks
    with caplog.at_level("WARNING"):
        with FaultInjector(fail_compile=["service_advdiff"]):
            t = warm_service.submit(StepRequest(degraded_sig, steps=4))
            out = t.result(timeout=300)
    assert np.all(np.isfinite(out))
    assert t.stats.degraded
    assert "injected compile failure" in t.stats.degraded_reason
    assert kstats.fallbacks == fb_before + 1
    assert any("DEGRADED" in r.message for r in caplog.records)
    # degraded is a mode, not an error: later requests for the same
    # signature reuse the interpreter plan and are flagged the same way
    t2 = warm_service.submit(StepRequest(degraded_sig, steps=2))
    t2.result(timeout=300)
    assert t2.stats.degraded and t2.stats.plan_cache_hit
    # the interpreter steps plain tensors (no resident layout): the
    # engine's jit answer, bitwise
    want = _reference(PlanSignature("advdiff", (11, 11, 6), backend="jit"), 4)
    assert (out == want).all()
    assert t.stats.repacks == 0


def test_expired_deadline_fails_before_running_torch(warm_service):
    t = warm_service.submit(
        StepRequest(SIGS[2], steps=2, deadline_s=0.0)
    )
    with pytest.raises(DeadlineExceeded):
        t.result(timeout=300)
    assert t.stats.steps == 0  # never dispatched to a chunk


# -- observability + manifest -------------------------------------------------


def test_service_stats_shape_torch(warm_service):
    s = warm_service.service_stats()
    assert s["requests"]["completed"] >= 64
    assert s["plans"]["cache_hits"] >= 64
    assert s["kernels"]["cache_hits"] >= 0
    assert s["faults"]["checkpoints"] >= 1
    assert s["service"]["workers"] == 2
    assert set(s["service"]["plan_cache"]) >= {sig.key() for sig in SIGS}
    # the module-level accessor reads the same counters
    assert service_stats()["requests"] == s["requests"]
    # ... and has the reference's keys, block for block
    want = ref_engine.service_stats()
    got = service_stats()
    assert set(got) == set(want)
    assert all(set(got[k]) == set(want[k]) for k in got
               if isinstance(got[k], dict))


def test_manifest_roundtrip_warms_next_instance_torch(tmp_path):
    path = str(tmp_path / "manifest.json")
    svc = SimulationService(workers=1, manifest=[SIGS[0]], device=CPU)
    svc.start()
    try:
        svc.submit(StepRequest(SIGS[1], steps=1)).result(timeout=300)
        svc.save_manifest(path)
    finally:
        svc.stop()

    svc2 = SimulationService(workers=1, manifest=path, device=CPU)
    assert {s.key() for s in svc2._manifest_sigs} == {
        SIGS[0].key(), SIGS[1].key(),
    }
    svc2.start()
    try:
        t = svc2.submit(StepRequest(SIGS[1], steps=2))
        t.result(timeout=300)
        assert t.stats.plan_cache_hit  # warmed from the manifest file
    finally:
        svc2.stop()


def test_straggler_flagging_reaches_service_stats_torch():
    reset_stats()
    svc = SimulationService(
        workers=1, default_chunk=2, straggler_threshold=5.0, device=CPU
    )
    svc.start()
    try:
        sig = SIGS[0]
        # build a duration history, then slow one chunk 1000x
        svc.submit(StepRequest(sig, steps=8)).result(timeout=300)
        req = StepRequest(sig, steps=4)
        with FaultInjector(
            slow_at={2: 0.5}, match_tag=req.request_id
        ):
            svc.submit(req).result(timeout=300)
    finally:
        svc.stop()
    assert estats.service_stragglers >= 1


def test_worker_threads_exit_on_stop_torch():
    svc = SimulationService(workers=2, device=CPU)
    svc.start()
    threads = list(svc._threads)
    svc.stop()
    assert all(not th.is_alive() for th in threads)
    assert threading.active_count() < 50  # no thread leak across tests


# -- kill, restore, continue (tests/test_checkpoint.py) -----------------------


def _serve_steps(svc, sig, steps, **kw):
    t = svc.submit(StepRequest(sig, steps=steps, **kw))
    return t.result(timeout=300), t.stats


@pytest.mark.parametrize("case", ["fp32", "fp64", "sharded"])
def test_kill_restore_continue_is_bitwise_torch(tmp_path, case):
    """k steps + checkpoint + service death + restore + (n−k) steps equal n
    uninterrupted steps exactly, at float32, at float64 with time_tile=2
    (the granule snaps 3 → 2, so the kill point 6 is a tile boundary) and
    on a 2×2 CPU mesh at float64 (whose stream also equals the
    single-device stream)."""
    from repro_torch.core.mesh import make_mesh

    mesh = None
    if case == "fp32":
        sig, n, k, every = PlanSignature("heat3d", (12, 10, 6)), 11, 4, 2
        kw = dict(default_chunk=3)
    elif case == "fp64":
        sig = PlanSignature("advdiff", (10, 12, 6), dtype="float64",
                            time_tile=2)
        n, k, every, kw = 13, 6, 3, dict(default_chunk=4)
    else:
        mesh = make_mesh((2, 2), ("x", "y"), device=CPU)
        sig = PlanSignature("heat3d", (12, 12, 6), dtype="float64")
        n, k, every, kw = 10, 4, 2, {}
    root = str(tmp_path)

    def service():
        return SimulationService(workers=1, ckpt_root=root, mesh=mesh,
                                 device=CPU, **kw).start()

    svc = service()
    try:
        ref, _ = _serve_steps(svc, sig, n)  # uninterrupted
        # phase 1: run only k steps, checkpointing under a stable key
        _, st = _serve_steps(svc, sig, k, ckpt_every=every, ckpt_key="run")
        assert st.checkpoints == -(-k // (every // sig.time_tile
                                          * sig.time_tile))
    finally:
        svc.stop()  # the "kill": worker pool and plan cache are gone

    svc2 = service()
    try:
        out, st = _serve_steps(svc2, sig, n, ckpt_every=every,
                               ckpt_key="run", resume=True)
        assert st.restores == 1
        assert st.steps == n - k  # only the remainder was re-run
    finally:
        svc2.stop()
    assert out.dtype == ref.dtype == np.dtype(sig.dtype)
    assert (out == ref).all()
    assert (ref == _reference(sig, n)).all()
    if mesh is not None:
        # and the sharded stream equals the single-device stream bitwise
        svc = SimulationService(workers=1, ckpt_root=root, device=CPU).start()
        try:
            single, _ = _serve_steps(svc, sig, n)
        finally:
            svc.stop()
        assert (single == ref).all()


def test_restore_after_odd_steps_rebuilds_env_from_the_snapshot(tmp_path):
    """After an odd number of steps the live buffer is the one allocated
    as the spare: a snapshot at step 3 restores to the same bits an
    uninterrupted run has (the margins are scratch, refreshed before any
    launch reads them)."""
    sig = SIGS[0]
    svc = SimulationService(workers=1, ckpt_root=str(tmp_path),
                            default_chunk=3, device=CPU).start()
    try:
        ref, _ = _serve_steps(svc, sig, 7)
        _serve_steps(svc, sig, 3, ckpt_every=3, ckpt_key="odd")
        out, st = _serve_steps(svc, sig, 7, ckpt_every=3, ckpt_key="odd",
                               resume=True)
    finally:
        svc.stop()
    assert st.restores == 1 and st.steps == 4
    assert (out == ref).all()


def test_restore_rejects_signature_mismatch_torch(tmp_path):
    sig_a = PlanSignature("heat3d", (10, 10, 4))
    sig_b = PlanSignature("advdiff", (10, 10, 4))
    svc = SimulationService(workers=1, ckpt_root=str(tmp_path),
                            device=CPU).start()
    try:
        svc.submit(
            StepRequest(sig_a, steps=2, ckpt_every=2, ckpt_key="shared")
        ).result(timeout=300)
        t = svc.submit(
            StepRequest(
                sig_b, steps=4, ckpt_every=2, ckpt_key="shared", resume=True
            )
        )
        with pytest.raises(ValueError, match="checkpoint belongs to"):
            t.result(timeout=300)
    finally:
        svc.stop()


# -- micro-batching (tests/test_ensemble.py) ----------------------------------


def test_plan_signature_batch_field_and_manifest_compat_torch(tmp_path):
    sig1 = PlanSignature("heat3d", (8, 8, 6))
    sigB = PlanSignature("heat3d", (8, 8, 6), batch=8)
    assert sig1.key() == "heat3d:8x8x6:float32:k1:pallas"  # unchanged
    assert sigB.key().endswith(":b8")
    assert PlanSignature.from_json(sigB.to_json()) == sigB
    # schema-1 manifest entries (no batch key) load as batch=1
    legacy = {"workload": "heat3d", "shape": [8, 8, 6]}
    assert PlanSignature.from_json(legacy).batch == 1
    with pytest.raises(ValueError):
        PlanSignature("heat3d", (8, 8, 6), batch=0)

    svc = SimulationService(workers=1, device=CPU)
    svc._seen[sigB.key()] = sigB
    path = tmp_path / "manifest.json"
    svc.save_manifest(str(path))
    doc = json.loads(path.read_text())
    assert doc["schema"] == 2
    loaded = SimulationService._load_manifest(str(path))
    assert sigB in loaded


def test_service_micro_batch_coalesces_and_matches_torch():
    """Queue three same-signature requests, then drive one worker turn by
    hand so the coalescing path runs deterministically (a live worker could
    legally dequeue the first request alone)."""
    sig = PlanSignature("heat3d", (8, 8, 6))
    inits = [i.astype(np.float32) for i in member_inits(3, shape=(8, 8, 6))]
    svc = SimulationService(workers=1, capacity=16, micro_batch=4,
                            device=CPU)
    svc._started = True  # accept submissions without live worker threads
    tickets = [svc.submit(StepRequest(sig, steps=6, init=T0)) for T0 in inits]
    group = svc.scheduler.get_group(timeout=1.0)
    units = svc._coalesce(group)
    assert [len(u) for u in units] == [3]
    svc._serve_batched(
        units[0], 0,
        lambda s: HeartbeatMonitor(threshold=svc.straggler_threshold),
    )
    outs = [t.result(timeout=1.0) for t in tickets]
    assert [t.stats.batch for t in tickets] == [3, 3, 3]
    with SimulationService(workers=1, capacity=16, device=CPU) as ref_svc:
        refs = [
            ref_svc.submit(StepRequest(sig, steps=6, init=T0)).result(
                timeout=300
            )
            for T0 in inits
        ]
    for out, ref in zip(outs, refs):
        assert (out == ref).all()


def test_service_batched_signature_direct_torch():
    sig = PlanSignature("heat3d", (8, 8, 6), batch=3)
    init = np.stack(
        [i.astype(np.float32) for i in member_inits(3, shape=(8, 8, 6))]
    )
    with SimulationService(workers=1, capacity=8, device=CPU) as svc:
        t = svc.submit(StepRequest(sig, steps=4, init=init))
        out = t.result(timeout=300)
    assert out.shape == (3, 8, 8, 6)
    assert t.stats.batch == 3
    for b in range(3):
        one = _reference(PlanSignature("heat3d", (8, 8, 6)), 4, init[b])
        assert (out[b] == one).all()


# -- parity with the reference service ----------------------------------------


def _drive(mod, injector, steps, inits, tmp):
    """The same stream through one package's service: three step
    signatures from seeded inits, one checkpointed request with a fault
    at step 4, one solve.  Returns results and service_stats()."""
    sigs = [mod.PlanSignature(s.workload, s.shape, time_tile=s.time_tile)
            for s in SIGS]
    solve_sig = mod.PlanSignature(SOLVE_SIG.workload, SOLVE_SIG.shape)
    kw = {} if mod is ref_service else {"device": CPU}
    svc = mod.SimulationService(workers=1, manifest=sigs + [solve_sig],
                                default_chunk=4, ckpt_root=tmp, **kw).start()
    try:
        outs = [svc.submit(mod.StepRequest(s, steps=steps, init=T0))
                .result(timeout=300) for s, T0 in zip(sigs, inits)]
        req = mod.StepRequest(sigs[0], steps=steps, init=inits[0],
                              ckpt_every=2)
        with injector(fail_at=[4], match_tag=req.request_id):
            outs.append(svc.submit(req).result(timeout=300))
        t = svc.submit(mod.SolveRequest(solve_sig, tol=1e-5, maxiter=80))
        x = t.result(timeout=300)
        return outs, (x, t.stats.iterations, t.stats.outcome), \
            svc.service_stats()
    finally:
        svc.stop()


def _counts(s: dict) -> dict:
    """``service_stats()`` without its timing fields."""
    s = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s.items()
         if k != "service"}
    del s["requests"]["mean_queue_wait_s"], s["faults"]["stragglers"]
    return s


def test_service_matches_the_reference_service(tmp_path):
    steps = 9
    rng = np.random.default_rng(11)
    inits = [rng.uniform(300.0, 500.0, SIGS[0].shape).astype(np.float32),
             rng.uniform(0.0, 1.0, SIGS[1].shape).astype(np.float32),
             rng.uniform(0.0, 1.0, SIGS[2].shape).astype(np.float32)]
    got = {}
    for name, mod, inj, eng, comp in (
            ("ref", ref_service, ref_fault.FaultInjector, ref_engine,
             ref_compiler),
            ("port", port_service, FaultInjector, port_engine, port_compiler)):
        eng.reset_stats()
        comp.reset_stats()
        comp.clear_cache()
        got[name] = _drive(mod, inj, steps, inits, str(tmp_path / name))
    (r_outs, r_solve, r_stats), (p_outs, p_solve, p_stats) = (
        got["ref"], got["port"])
    eps = np.finfo(np.float32).eps
    for r, p in zip(r_outs, p_outs):
        assert r.dtype == p.dtype and r.shape == p.shape
        assert np.abs(r - p).max() <= 2 * steps * eps * np.abs(r).max()
    assert (p_outs[3] == p_outs[0]).all()  # restored run: bitwise
    assert r_solve[1:] == p_solve[1:]  # iterations, outcome word
    x_r, x_p = r_solve[0], p_solve[0]
    assert np.abs(x_r - x_p).max() <= 3 * 1e-5 + 4 * eps * np.abs(x_r).max()
    assert _counts(p_stats) == _counts(r_stats)
    assert p_stats["faults"]["restores"] == 1


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_manifest_saved_by_one_package_warms_the_other(tmp_path, saver):
    path = str(tmp_path / "manifest.json")
    sigs = [SIGS[0], PlanSignature("advdiff", (10, 10, 6), batch=2)]
    if saver == "reference":
        src = ref_service.SimulationService(workers=1)
        for s in sigs:
            rs = ref_service.PlanSignature.from_json(s.to_json())
            src._seen[rs.key()] = rs
        src.save_manifest(path)
        svc = SimulationService(workers=1, manifest=path, device=CPU)
    else:
        src = SimulationService(workers=1, manifest=sigs, device=CPU)
        src.save_manifest(path)
        svc = ref_service.SimulationService(workers=1, manifest=path)
    assert {s.key() for s in svc._manifest_sigs} == {s.key() for s in sigs}
    mod = ref_service if saver == "port" else None
    Req = mod.StepRequest if mod else StepRequest
    svc.start()
    try:
        t = svc.submit(Req(svc._manifest_sigs[0], steps=2))
        t.result(timeout=300)
        assert t.stats.plan_cache_hit  # warmed from the other's manifest
    finally:
        svc.stop()


# -- the smoke gate, no fallback, thread safety -------------------------------


def test_smoke_main_passes_on_the_cpu(capsys):
    assert smoke_main(["--smoke", "--device", "cpu", "--requests", "16"]) == 0
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and "[FAIL]" not in out


def test_no_fallback_without_a_card():
    """The default device is the card: with none, building a workload,
    warming a manifest and serving a request all raise — nothing runs on
    the host instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sig = PlanSignature("heat3d", (8, 8, 6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_workload(sig)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_workload(SOLVE_SIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimulationService(workers=1, manifest=[sig]).start()
    with SimulationService(workers=1) as svc:
        t = svc.submit(StepRequest(sig, steps=2))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t.result(timeout=60)
        assert svc._threads[0].is_alive()  # the worker survives a failed build


def _run_threads(fn, n: int) -> None:
    """``fn(i)`` on ``n`` threads at once, the interpreter switching
    threads every 10 µs; each joined within a minute."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)


def test_kernel_cache_builds_once_under_contention(monkeypatch):
    """Eight threads compiling one new body at once: one kernel built, and
    every thread's step on that one kernel (the same bits)."""
    import repro_torch.kernels.fused as fused
    from repro_torch.compiler import clear_cache, codegen, reset_stats as kr

    real = fused.build_fused_call

    def slow_build(*a, **k):
        time.sleep(0.05)  # widen the window between lookup and store
        return real(*a, **k)

    monkeypatch.setattr(fused, "build_fused_call", slow_build)
    clear_cache()
    kr()
    program, _ = get_workload("heat3d").record((12, 10, 6), np.float32, 2)
    ops = program.ops
    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    barrier = threading.Barrier(8)
    steps = [None] * 8

    def compile_one(i):
        barrier.wait()
        steps[i] = codegen.compile_group(ops, shapes, dtypes, device=CPU)

    _run_threads(compile_one, 8)
    assert kstats.kernels_built == 1 and kstats.cache_hits == 7
    assert len(codegen._KERNEL_CACHE) == 1
    env = {"T": torch.tensor(program.fields["T"].init_data)}
    outs = [s(dict(env))["T"] for s in steps]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_library_build_runs_once_under_contention(monkeypatch, tmp_path):
    """Eight threads loading one unbuilt library at once through a
    stand-in nvcc: one build, written under a temporary name and renamed
    into place, and one library object for all."""
    from repro_torch.kernels import build

    popens = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            popens.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)
            with open(self.out, "wb") as f:
                f.write(b"\x7fELF stand-in")
            return "", ""

    loaded = []
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())
    barrier = threading.Barrier(8)
    libs = [None] * 8

    def load(i):
        barrier.wait()
        libs[i] = build.load_library("fused_stencil")

    _run_threads(load, 8)
    assert len(popens) == 1 and len(loaded) == 1
    assert popens[0][popens[0].index("-o") + 1].endswith(".tmp")
    assert all(lib is libs[0] for lib in libs)
    so = build.library_path("fused_stencil")
    assert so.exists() and [p.name for p in tmp_path.iterdir()] == [so.name]


def test_port_service_docstrings_run():
    import doctest
    import importlib

    for name in ("repro_torch.service.service", "repro_torch.engine.stats"):
        res = doctest.testmod(importlib.import_module(name))
        assert res.attempted > 0 and res.failed == 0, (name, res)
