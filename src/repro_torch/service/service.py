"""The simulation service: async request serving over the unified engine.

The port of ``repro/service/service.py``.  It serves on the card unless the
caller asks for the CPU (``device="cpu"``).

``SimulationService`` is the always-on front end the ROADMAP's serving item
describes: a bounded admission queue feeding a pool of worker threads whose
plans (and therefore fused-kernel cache entries) are **pre-warmed** from a
persisted signature manifest, so steady-state requests never pay compile
latency — the serving-tier analogue of the WFA's amortized ``make_WSE``
workflow.

Request lifecycle::

    submit ──admission──▶ queue ──signature group──▶ worker
                                                       │ plan cache (warm)
                                                       ▼
                            chunked resident stepping / Krylov solve
                              │ checkpoint every ckpt_every steps
                              │ fault ⇒ restore last snapshot, retry
                              ▼
                            ticket resolves (result + RequestStats)

Fault tolerance is layered exactly as :mod:`repro_torch.runtime.fault` frames it:
the engine's step hook is where injected (or real) faults surface; the
worker restores the newest resident-state snapshot and continues with
bounded retries and exponential backoff; a :class:`HeartbeatMonitor` per
worker flags straggling chunks; and a body whose pallas compile fails is
served through the *logged* interpreter degraded mode — flagged on every
ticket it serves, never silent.

Numerical faults are the one failure class that is **never retried**: a
:class:`~repro_torch.engine.health.NumericalFault` (failed guarded solve, or a
non-finite field state caught by the per-chunk sentinel) is deterministic
— restore-and-continue would repoison — so the worker fails the ticket
fast with the taxonomy word and :class:`~repro_torch.engine.health.
RecoveryTrace` on ``Ticket.stats``, keeping the retry budget for the
infrastructure faults it can actually fix.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.mesh import NamedSharding
from repro_torch.engine import health as ehealth
from repro_torch.engine.hooks import fire_step_hook
from repro_torch.engine.stats import service_stats as _engine_service_stats
from repro_torch.engine.stats import stats as estats
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.service.requests import (
    DeadlineExceeded,
    PlanSignature,
    RequestFailed,
    SolveRequest,
    StepRequest,
    Ticket,
)
from repro_torch.service.scheduler import SignatureScheduler
from repro_torch.service.workloads import (
    CompiledWorkload,
    build_workload,
    get_workload,
)

log = logging.getLogger("repro_torch.service")


def _block_until_ready(cw: CompiledWorkload) -> None:
    """Wait for the work enqueued so far on the current stream of each
    device ``cw`` runs on (every brick's, on a mesh): a CUDA event recorded
    after it and waited on (the host is in step on the CPU)."""
    devices = set(cw.mesh.devices) if cw.mesh is not None else {cw.device}
    for device in devices:
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            ev.synchronize()

#: exceptions that retrying cannot fix (bad request, unknown workload)
_PERMANENT = (ValueError, KeyError, TypeError)


def _snapshot_pad(cw: CompiledWorkload) -> int:
    """The margin of the buffers a checkpoint of ``cw`` holds: the
    layout's on one device when the segment is resident, else none (a mesh
    snapshots the exited bricks)."""
    return cw.layout.pad if cw.mesh is None and cw.resident else 0


class SimulationService:
    """Async simulation serving over the compile-and-execute engine.

    ``workers`` threads serve signature-grouped requests from a bounded
    queue (``capacity``); ``manifest`` (a path or an iterable of
    :class:`PlanSignature`) pre-compiles the hot signatures at
    :meth:`start`; ``ckpt_root`` hosts per-request resident-state
    snapshots; ``default_chunk`` is the steps-per-launch granule requests
    are chunked into when they don't checkpoint.

    ``micro_batch=N`` (default 1 = off) turns the scheduler's signature
    groups into *ensemble launches*: up to N same-signature step requests
    (equal ``steps``, no checkpointing, no deadline) are coalesced into one
    batched plan — every kernel launch advances all of them at once, and
    each ticket gets its own member of the stacked result (its
    ``stats.batch`` records the coalesced width).  Any failure on the
    batched path falls back to serving the group individually.

    ``device`` (the port's one addition; default the card, which must
    exist) is the torch device every plan and solver is built for
    (``RunOptions(device=)``, ``make_solver(device=)``); with ``mesh`` it
    must name the bricks' device type.  Worker threads enqueue on the
    device's current stream, so chunks of different requests serialize on
    the card.

    >>> svc = SimulationService(workers=1, capacity=8, device="cpu").start()
    >>> sig = PlanSignature("heat3d", (8, 8, 6))
    >>> t = svc.submit(StepRequest(sig, steps=4))
    >>> out = t.result(timeout=120)
    >>> out.shape, t.stats.retries
    ((8, 8, 6), 0)
    >>> svc.stop()
    """

    def __init__(
        self,
        workers: int = 2,
        capacity: int = 256,
        group_max: int = 16,
        manifest: Union[str, Iterable[PlanSignature], None] = None,
        ckpt_root: Optional[str] = None,
        default_chunk: int = 8,
        max_retries: int = 3,
        backoff_base: float = 0.02,
        backoff_cap: float = 1.0,
        straggler_threshold: float = 4.0,
        mesh=None,
        micro_batch: int = 1,
        device="cuda",
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1; got {workers}")
        if default_chunk < 1:
            raise ValueError(f"default_chunk must be >= 1; got {default_chunk}")
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1; got {micro_batch}")
        if micro_batch > 1 and mesh is not None:
            raise ValueError("micro-batching is single-device; drop mesh=")
        self.micro_batch = micro_batch
        self.default_chunk = default_chunk
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.straggler_threshold = straggler_threshold
        self.ckpt_root = ckpt_root
        self.mesh = mesh
        self.device = device
        self.scheduler = SignatureScheduler(capacity=capacity, group_max=group_max)
        self._nworkers = workers
        self._threads: List[threading.Thread] = []
        self._plans: Dict[str, CompiledWorkload] = {}
        self._plans_lock = threading.Lock()
        self._slock = threading.Lock()  # guards the shared engine counters
        self._manifest_sigs = self._load_manifest(manifest)
        self._seen: Dict[str, PlanSignature] = {
            s.key(): s for s in self._manifest_sigs
        }
        self._started = False
        self._t_start: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SimulationService":
        """Warm the manifest signatures, then open the worker pool."""
        if self._started:
            return self
        self.warm(self._manifest_sigs)
        for wid in range(self._nworkers):
            th = threading.Thread(
                target=self._worker_loop, args=(wid,),
                name=f"sim-worker-{wid}", daemon=True,
            )
            th.start()
            self._threads.append(th)
        self._started = True
        self._t_start = time.monotonic()
        return self

    def stop(self, wait: bool = True) -> None:
        """Close admission and (optionally) drain + join the workers."""
        self.scheduler.close()
        if wait:
            for th in self._threads:
                th.join()
        self._threads = []
        self._started = False

    def __enter__(self) -> "SimulationService":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- manifest ------------------------------------------------------------
    @staticmethod
    def _load_manifest(manifest) -> List[PlanSignature]:
        if manifest is None:
            return []
        if isinstance(manifest, (str, os.PathLike)):
            if not os.path.exists(manifest):
                return []
            with open(manifest) as f:
                doc = json.load(f)
            return [PlanSignature.from_json(d) for d in doc["signatures"]]
        return list(manifest)

    def save_manifest(self, path: str) -> None:
        """Persist every signature this service has seen (submitted or
        warmed), so the next instance pre-compiles the same hot set.

        Schema 2 adds the per-signature ``batch`` field; schema-1 manifests
        (no ``schema`` key, no ``batch``) still load — absent batch reads
        as 1, the classic single-scenario signature.
        """
        doc = {"schema": 2, "signatures": [s.to_json() for s in self._seen.values()]}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    # -- plan cache ----------------------------------------------------------
    def warm(self, signatures: Sequence[PlanSignature]) -> None:
        """Pre-compile ``signatures``: build plan + kernels, then run one
        default-chunk advance (or one solve) so every kernel library is
        loaded and every launch path has run before the first request
        lands."""
        for sig in signatures:
            cw = self._get_workload(sig, ticket=None)
            if cw.spec.kind == "step":
                env, spare = cw.initial_env(None)
                cw.advance(env, spare, self.default_chunk)
                _block_until_ready(cw)
            else:
                x0 = cw.spec.default_init(sig.shape, np.dtype(sig.dtype))
                if sig.batch > 1:
                    x0 = np.broadcast_to(x0, (sig.batch,) + x0.shape).copy()
                cw.solver("cg", 1e-6, 200)(x0)
                _block_until_ready(cw)
            log.info("warmed %s in %.3fs", sig.key(), cw.build_s)

    def _get_workload(self, sig: PlanSignature, ticket: Optional[Ticket]):
        with self._plans_lock:
            cw = self._plans.get(sig.key())
            if cw is not None:
                with self._slock:
                    estats.plan_cache_hits += 1
                if ticket is not None:
                    ticket.stats.plan_cache_hit = True
                return cw
            cw = build_workload(sig, mesh=self.mesh, device=self.device)
            self._plans[sig.key()] = cw
        if cw.degraded:
            log.warning(
                "signature %s serves DEGRADED via the interpreter: %s",
                sig.key(), cw.degraded_reason,
            )
        if ticket is not None:
            ticket.stats.compile_s = cw.build_s
        return cw

    # -- submission ----------------------------------------------------------
    def submit(self, request: Union[StepRequest, SolveRequest]) -> Ticket:
        """Admit a request; returns its :class:`Ticket` or raises
        :class:`~repro_torch.service.requests.ServiceOverloaded` when the bounded
        queue is full (admission control — shed load at the door)."""
        get_workload(request.signature.workload)  # unknown name fails here
        if not self._started:
            raise RuntimeError("service not started; call start() first")
        ticket = Ticket(request)
        try:
            self.scheduler.submit(ticket)
        except Exception:
            with self._slock:
                estats.requests_rejected += 1
            raise  # ServiceOverloaded: the bounded queue is full
        with self._slock:
            estats.requests_admitted += 1
        self._seen.setdefault(request.signature.key(), request.signature)
        return ticket

    # -- workers -------------------------------------------------------------
    def _worker_loop(self, wid: int) -> None:
        # one monitor per signature: chunk durations are only comparable
        # within a compiled workload, and the monitor's start/end pairing
        # is single-threaded, so monitors live with the worker
        monitors: Dict[str, HeartbeatMonitor] = {}

        def monitor_for(sig: PlanSignature) -> HeartbeatMonitor:
            key = sig.key()
            if key not in monitors:
                monitors[key] = HeartbeatMonitor(
                    threshold=self.straggler_threshold,
                    on_straggler=lambda step, ratio: self._note_straggler(
                        wid, step, ratio
                    ),
                )
            return monitors[key]

        while True:
            group = self.scheduler.get_group(timeout=0.25)
            if not group:
                if self.scheduler._closed and not len(self.scheduler):
                    return
                self._collect_expired()
                continue
            for batch in self._coalesce(group):
                if len(batch) == 1:
                    self._serve(
                        batch[0], wid, monitor_for(batch[0].request.signature)
                    )
                else:
                    self._serve_batched(batch, wid, monitor_for)
            self._collect_expired()

    def _coalesce(self, group: List[Ticket]) -> List[List[Ticket]]:
        """Split one signature group into serve units: singletons, plus —
        when ``micro_batch > 1`` — ensemble batches of step requests that
        can share a launch (equal ``steps``, no checkpoint/resume, no
        deadline, single-member signature)."""
        if self.micro_batch <= 1 or len(group) < 2:
            return [[t] for t in group]

        def eligible(t: Ticket) -> bool:
            r = t.request
            return (
                isinstance(r, StepRequest)
                and r.ckpt_every == 0
                and not r.resume
                and r.deadline_s is None
                and r.signature.batch == 1
            )

        units: List[List[Ticket]] = []
        buckets: Dict[int, List[Ticket]] = {}
        for t in group:
            if eligible(t):
                buckets.setdefault(t.request.steps, []).append(t)
            else:
                units.append([t])
        for ts in buckets.values():
            while ts:
                unit, ts = ts[: self.micro_batch], ts[self.micro_batch:]
                units.append(unit)
        return units

    def _serve_batched(self, tickets: List[Ticket], wid: int, monitor_for):
        """Serve a coalesced unit as one batched launch sequence.

        The member requests share a plan built for
        ``replace(signature, batch=B)`` — same program, same kernels, one
        leading member axis — and each ticket resolves with its member of
        the stacked result.  Any failure falls back to the individual
        serve path (which has its own retry loop), so coalescing can only
        add throughput, never new failure modes.
        """
        B = len(tickets)
        reqs = [t.request for t in tickets]
        now = time.monotonic()
        for t in tickets:
            t.stats.worker = wid
            t.stats.started_s = now
            t.stats.queue_wait_s = now - t.stats.submitted_s
            t.stats.batch = B
        try:
            bsig = dataclasses.replace(reqs[0].signature, batch=B)
            cw = self._get_workload(bsig, tickets[0])
            for t in tickets[1:]:
                t.stats.plan_cache_hit = tickets[0].stats.plan_cache_hit
            self._seen.setdefault(bsig.key(), bsig)
            monitor = monitor_for(bsig)
            init = np.stack(
                [
                    np.asarray(r.init, dtype=bsig.dtype)
                    if r.init is not None
                    else cw.spec.default_init(bsig.shape, np.dtype(bsig.dtype))
                    for r in reqs
                ]
            )
            env, spare = cw.initial_env(init)
            steps = reqs[0].steps
            chunks = launches = exchanges = 0
            for env, _, m in self._chunks(cw, env, spare, 0, steps,
                                          self.default_chunk, monitor,
                                          reqs[0].request_id):
                chunks += 1
                dl, dx = cw.chunk_accounting(m)
                launches += dl
                exchanges += dx
            out = cw.finalize(env)  # (B, X, Y, Z)
        except Exception as e:
            log.warning(
                "micro-batch of %d %s requests failed (%r); "
                "serving individually",
                B, reqs[0].signature.key(), e,
            )
            for t in tickets:
                t.stats.batch = 1
                self._serve(t, wid, monitor_for(t.request.signature))
            return
        fin = time.monotonic()
        repacks = 2 if cw.resident else 0
        with self._slock:
            estats.queue_wait_s += sum(t.stats.queue_wait_s for t in tickets)
            estats.requests_completed += B
            estats.steps_run += steps * B
            estats.launches += launches
            estats.exchanges += exchanges
            estats.ensemble_runs += 1
            estats.ensemble_members += B
            if repacks:
                estats.repacks += repacks
                estats.resident_runs += 1
            if cw.degraded:
                estats.requests_degraded += B
        for i, t in enumerate(tickets):
            st = t.stats
            st.finished_s = fin
            st.exec_s = fin - st.started_s
            st.steps = steps
            st.chunks = chunks
            st.launches = launches
            st.exchanges = exchanges
            st.repacks = repacks
            if cw.degraded:
                st.degraded = True
                st.degraded_reason = cw.degraded_reason
            t._resolve(np.asarray(out[i]))

    def _collect_expired(self) -> None:
        with self._slock:
            n = len(self.scheduler.expired)
            if n:
                estats.requests_expired += n
                self.scheduler.expired.clear()

    def _note_straggler(self, wid: int, step: int, ratio: float) -> None:
        with self._slock:
            estats.service_stragglers += 1
        log.warning(
            "worker %d straggling at step %d (%.1fx trailing median)",
            wid, step, ratio,
        )

    def _serve(self, ticket: Ticket, wid: int, monitor: HeartbeatMonitor):
        req = ticket.request
        st = ticket.stats
        st.worker = wid
        st.started_s = time.monotonic()
        st.queue_wait_s = st.started_s - st.submitted_s
        with self._slock:
            estats.queue_wait_s += st.queue_wait_s
        if (
            req.deadline_s is not None
            and st.queue_wait_s > req.deadline_s
        ):
            st.finished_s = time.monotonic()
            with self._slock:
                estats.requests_expired += 1
            ticket._fail(
                DeadlineExceeded(
                    f"request {req.request_id} expired after "
                    f"{st.queue_wait_s:.3f}s in queue"
                )
            )
            return
        try:
            cw = self._get_workload(req.signature, ticket)
        except Exception as e:  # a failed build never runs: no retry
            self._finish_fail(ticket, e)
            return
        if cw.degraded:
            st.degraded = True
            st.degraded_reason = cw.degraded_reason
        st.batch = max(st.batch, req.signature.batch)
        attempt = 0
        while True:
            try:
                if isinstance(req, StepRequest):
                    value = self._run_step(cw, req, ticket, monitor)
                else:
                    value = self._run_solve(cw, req, ticket)
                break
            except _PERMANENT as e:
                self._finish_fail(ticket, e)
                return
            except ehealth.NumericalFault as e:
                # deterministic numerical failure: a re-run would repoison,
                # so fail FAST — no retry, no backoff (unlike the injected
                # infrastructure faults below, which restore-and-continue)
                st.outcome = e.outcome or "NAN_RESIDUAL"
                if e.trace is not None:
                    st.recovery = e.trace.summary()
                with self._slock:
                    estats.numerical_faults += 1
                self._finish_fail(ticket, e)
                return
            except Exception as e:  # transient: restore-and-continue
                attempt += 1
                st.retries += 1
                with self._slock:
                    estats.request_retries += 1
                if attempt > self.max_retries:
                    self._finish_fail(
                        ticket,
                        RequestFailed(
                            f"request {req.request_id} failed after "
                            f"{self.max_retries} retries: {e!r}"
                        ),
                    )
                    return
                backoff = min(
                    self.backoff_cap, self.backoff_base * (2 ** (attempt - 1))
                )
                log.warning(
                    "request %s attempt %d failed (%r); retrying in %.3fs",
                    req.request_id, attempt, e, backoff,
                )
                time.sleep(backoff)
        st.finished_s = time.monotonic()
        st.exec_s = st.finished_s - st.started_s
        with self._slock:
            estats.requests_completed += 1
            if st.degraded:
                estats.requests_degraded += 1
        ticket._resolve(value)

    def _finish_fail(self, ticket: Ticket, error: BaseException) -> None:
        ticket.stats.finished_s = time.monotonic()
        with self._slock:
            estats.requests_failed += 1
        log.error("request %s failed: %s", ticket.request.request_id, error)
        ticket._fail(error)

    # -- step requests -------------------------------------------------------
    def _ckpt_manager(self, req: StepRequest) -> Optional[CheckpointManager]:
        if req.ckpt_every <= 0:
            return None
        root = self.ckpt_root or os.path.join(".", "service_ckpt")
        return CheckpointManager(
            os.path.join(root, req.ckpt_key or req.request_id), keep=2
        )

    def _restore_env(self, cw: CompiledWorkload, mgr: CheckpointManager):
        """Rebuild the chunk-loop state from the newest snapshot: the
        standing padded buffers (one device) or each field's bricks
        (mesh), fresh spares beside them, and the step counter they were
        taken at.  The snapshot holds the env as the chunk left it — after
        an odd number of steps its buffers are the ones allocated as
        spares — so the env is rebuilt from the snapshot alone."""
        sig = cw.signature
        pad = _snapshot_pad(cw)
        dtype = getattr(torch, sig.dtype)
        # restore places each leaf on its target leaf's device in its
        # dtype; the shapes are checked below
        devices = cw.mesh.devices if cw.mesh is not None else None
        target = {
            n: ([torch.empty(0, dtype=dtype, device=d) for d in devices]
                if devices is not None
                else torch.empty(0, dtype=dtype, device=cw.device))
            for n in cw.program.fields
        }
        env, step, extra = mgr.restore(target)
        if extra.get("signature") != sig.key():
            raise ValueError(
                f"checkpoint belongs to {extra.get('signature')!r}, "
                f"not {sig.key()!r}"
            )
        for n, f in cw.program.fields.items():
            nx, ny, nz = f.shape
            want = (nx + 2 * pad, ny + 2 * pad, nz)
            got = env[n]
            if devices is not None:
                want = NamedSharding(cw.mesh).brick_shape(want)
                got = got[0]
            if tuple(got.shape) != want:
                raise ValueError(
                    f"checkpoint field {n!r} is {tuple(got.shape)}; "
                    f"signature {sig.key()!r} steps {want}"
                )
        return env, cw.new_spares(env), int(extra["step"])

    @staticmethod
    def _chunks(cw, env, spare, step, steps, chunk, monitor, tag):
        """Advance ``env`` (stepping against ``spare``) from ``step`` to
        ``steps`` in chunks of ``chunk`` steps, yielding ``(env, step, m)``
        after each chunk of ``m`` steps has finished on the card.

        Temporal blocking is tile-boundary sensitive (a k-step fused
        launch differs from k untiled launches by ~1 ulp), so chunk
        boundaries — and therefore checkpoints — are snapped to multiples
        of the tile factor; the launch sequence then matches an
        uninterrupted run exactly and resume stays bitwise.
        """
        seg = cw.segment
        k = seg.time_tile if seg.kind == "fused" else 1
        if k > 1:
            chunk = max(k, (chunk // k) * k)
        while step < steps:
            m = min(chunk, steps - step)
            # the injectable failure boundary: after the previous chunk's
            # checkpoint, before this chunk advances any state — inside the
            # heartbeat window so injected slowdowns read as slow chunks
            monitor.start_step(step)
            fire_step_hook(step, tag=tag)
            env = cw.advance(env, spare, m)
            _block_until_ready(cw)
            monitor.end_step()
            step += m
            yield env, step, m

    def _run_step(
        self,
        cw: CompiledWorkload,
        req: StepRequest,
        ticket: Ticket,
        monitor: HeartbeatMonitor,
    ) -> np.ndarray:
        st = ticket.stats
        mgr = self._ckpt_manager(req)
        step = 0
        env = None
        if mgr is not None and (req.resume or st.retries > 0):
            if mgr.latest_step() is not None:
                env, spare, step = self._restore_env(cw, mgr)
                st.restores += 1
                with self._slock:
                    estats.service_restores += 1
                log.info(
                    "request %s restored at step %d", req.request_id, step
                )
        if env is None:
            env, spare = cw.initial_env(req.init)
        chunk = req.ckpt_every if req.ckpt_every > 0 else self.default_chunk
        # the explicit-path sentinel at the service's natural chunk
        # granule: one isfinite reduction per field per chunk into buffers
        # the request holds, and one host read (the chunk steps its buffers
        # in place, so the recovery state is the newest checkpoint, not a
        # held env)
        probe = ehealth.HeldProbe(env)
        for env, step, m in self._chunks(cw, env, spare, step, req.steps,
                                         chunk, monitor, req.request_id):
            ok = probe(env)
            with self._slock:
                estats.health_probes += 1
            if not ok:
                raise ehealth.NumericalFault(
                    f"request {req.request_id}: non-finite field state "
                    f"at step {step}",
                    outcome="NAN_RESIDUAL",
                    step=step,
                )
            st.chunks += 1
            st.steps += m
            launches, exchanges = cw.chunk_accounting(m)
            st.launches += launches
            st.exchanges += exchanges
            if cw.mesh is not None and cw.resident:
                st.repacks += 2  # enter/exit per chunk, brick by brick
            with self._slock:
                estats.steps_run += m
                estats.launches += launches
                estats.exchanges += exchanges
            if mgr is not None:
                mgr.save(
                    step,
                    env,
                    extra={
                        "signature": cw.signature.key(),
                        "step": step,
                        "pad": _snapshot_pad(cw),
                    },
                )
                st.checkpoints += 1
                with self._slock:
                    estats.service_checkpoints += 1
        if cw.mesh is None and cw.resident:
            st.repacks += 2  # one enter + one exit per resident request
            with self._slock:
                estats.repacks += 2
                estats.resident_runs += 1
        return cw.finalize(env)

    # -- solve requests ------------------------------------------------------
    def _run_solve(
        self, cw: CompiledWorkload, req: SolveRequest, ticket: Ticket
    ) -> np.ndarray:
        """One guarded Krylov solve, classified and (boundedly) recovered.

        The solver's health word drives the service's in-queue ladder: a
        failed cg/pipecg solve escalates once to BiCGSTAB (warm kernels,
        no recompile — the service skips the fp64 rung the offline path
        runs, keeping worker latency bounded); a still-failed solve raises
        :class:`~repro_torch.engine.health.NumericalFault` with the full
        :class:`~repro_torch.engine.health.RecoveryTrace`, which ``_serve``
        fails fast and never retries.
        """
        from repro_torch.solver import health as shealth

        fire_step_hook(0, tag=req.request_id)
        x0 = (
            np.asarray(req.init, dtype=req.signature.dtype)
            if req.init is not None
            else cw.spec.default_init(
                req.signature.shape, np.dtype(req.signature.dtype)
            )
        )
        B = req.signature.batch
        if B > 1 and x0.ndim == 3:
            x0 = np.broadcast_to(x0, (B,) + x0.shape).copy()

        trace = ehealth.RecoveryTrace()

        def attempt(method, reason):
            x, (iters, res, outcomes) = cw.solver(
                method, req.tol, req.maxiter
            )(x0)
            _block_until_ready(cw)
            iters = int(np.sum(np.asarray(iters)))
            outs = np.asarray(outcomes)
            trace.record(
                method,
                req.signature.dtype,
                shealth.outcome_name(shealth.worst(outs)),
                iters,
                float(np.max(np.asarray(res))),
                reason,
            )
            return x, iters, outs

        x, iters, outs = attempt(req.method, "initial")
        if shealth.any_failure(outs) and req.method in ("cg", "pipecg"):
            worst = shealth.outcome_name(shealth.worst(outs))
            log.warning(
                "request %s: %s solve %s; escalating to bicgstab",
                req.request_id, req.method, worst,
            )
            with self._slock:
                estats.recovery_attempts += 1
            x, iters, outs = attempt("bicgstab", f"escalate after {worst}")
        ticket.stats.outcome = shealth.outcome_name(shealth.worst(outs))
        ticket.stats.recovery = trace.summary()
        ticket.stats.iterations = iters
        ticket.stats.steps = 1
        if shealth.any_failure(outs):
            raise ehealth.NumericalFault(
                f"request {req.request_id}: solve failed "
                f"({ticket.stats.outcome}) after {len(trace.attempts)} "
                "attempt(s)",
                outcome=ticket.stats.outcome,
                trace=trace,
            )
        return x.cpu().numpy()

    # -- observability -------------------------------------------------------
    def service_stats(self) -> dict:
        """The service-level summary (see
        :func:`repro_torch.engine.stats.service_stats`) plus this instance's live
        state: worker count, queue depth, plan-cache size, uptime."""
        out = _engine_service_stats()
        out["service"] = {
            "workers": self._nworkers,
            "queue_depth": len(self.scheduler),
            "plan_cache": sorted(self._plans),
            "uptime_s": (
                time.monotonic() - self._t_start if self._t_start else 0.0
            ),
        }
        return out
