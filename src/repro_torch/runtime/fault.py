"""Fault tolerance: checkpoint/restart loop + straggler detection.

The port of ``repro/runtime/fault.py``: framework-free Python, bound to the
port's hooks (:mod:`repro_torch.engine.hooks`) and its
:class:`repro_torch.compiler.LoweringError`.

``ResilientLoop`` is the production loop contract: run steps; on any
device/runtime failure, restore the last checkpoint (params, optimizer,
data-stream position) and continue; give up after ``max_failures``
consecutive failures.  On a real cluster the failure signal is a runtime error
from a dead host or card; here it is any exception from the step callable
(tests inject them).

``HeartbeatMonitor`` watches wall-clock step durations on a background
thread and calls ``on_straggler`` when a step exceeds
``threshold × trailing-median`` — at 1000-node scale this is the hook that
triggers hot-spare swap / re-slicing.  The monitor only observes; policy
lives with the caller.

``FaultInjector`` arms the engine's instrumentation hooks
(:mod:`repro_torch.engine.hooks`) so tests, the service smoke run and chaos
drills can trigger the *real* failure paths: a raised exception at step N
(fires the service's restore-and-continue), an injected slowdown (fires
the straggler monitor), and a forced ``LoweringError`` during kernel
compilation (fires the logged interpreter degraded mode).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence


class HeartbeatMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 16,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.clock = clock  # injectable for deterministic tests
        self.durations: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._t0 = self.clock()
        self._step = step

    def end_step(self) -> None:
        if self._t0 is None:
            return
        dt = self.clock() - self._t0
        hist = self.durations[-self.window:]
        if hist:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                self.flagged.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, dt / med)
        self.durations.append(dt)
        self._t0 = None


class ResilientLoop:
    """Checkpoint/restart training loop.

    ``step_fn(state, batch) -> (state, metrics)`` must be functional;
    ``save_fn(step, state)`` / ``restore_fn() -> (state, step)`` bind the
    CheckpointManager; ``dataset`` must be seekable (``state()/restore()``).
    """

    def __init__(self, step_fn, save_fn, restore_fn, dataset, *,
                 ckpt_every: int = 100, max_failures: int = 3,
                 monitor: Optional[HeartbeatMonitor] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.dataset = dataset
        self.ckpt_every = ckpt_every
        self.max_failures = max_failures
        self.monitor = monitor or HeartbeatMonitor()
        self.failures = 0

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        metrics = None
        while step < start_step + num_steps:
            try:
                self.monitor.start_step(step)
                batch = self.dataset.next_batch()
                state, metrics = self.step_fn(state, batch)
                self.monitor.end_step()
                step += 1
                self.failures = 0
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except Exception:
                self.failures += 1
                if self.failures > self.max_failures:
                    raise
                state, step = self.restore_fn()
        return state, step, metrics


class InjectedFault(RuntimeError):
    """The exception :class:`FaultInjector` raises at an armed step."""


class FaultInjector:
    """Arm the engine's hooks with deterministic faults (a chaos drill).

    * ``fail_at`` — step numbers at which the step hook raises
      ``exc_type`` (each armed step fires **once**, so the service's
      restore-and-continue makes progress on retry — the semantics of a
      node dying and being replaced);
    * ``slow_at`` — ``{step: seconds}`` sleeps injected at the step hook
      (feeds the :class:`HeartbeatMonitor` straggler path);
    * ``fail_compile`` — loop names (or ``"*"`` for any) whose pallas
      compile attempt raises :class:`repro_torch.compiler.LoweringError`, which
      ``try_compile`` turns into the counted, logged interpreter fallback
      — the degraded serving mode;
    * ``match_tag`` — restrict step faults to one hook tag (the service
      tags chunks with the request id), ``None`` hits any caller.

    Use as a context manager; hooks are installed on ``__enter__`` and the
    previous hooks restored on ``__exit__``.  All mutation is lock-guarded:
    service workers fire the hooks concurrently.
    """

    def __init__(self, fail_at: Sequence[int] = (),
                 exc_type=InjectedFault,
                 slow_at: Optional[Dict[int, float]] = None,
                 fail_compile: Sequence[str] = (),
                 match_tag: Optional[str] = None):
        self.exc_type = exc_type
        self.match_tag = match_tag
        self._fail_at = set(int(s) for s in fail_at)
        self._slow_at = dict(slow_at or {})
        self._fail_compile = set(fail_compile)
        self.fired: List[tuple] = []  # ("step"|"slow"|"compile", detail)
        self._lock = threading.Lock()
        self._prev_step = None
        self._prev_compile = None

    # -- hook bodies --------------------------------------------------------
    def on_step(self, step: int, tag: str = "") -> None:
        if self.match_tag is not None and tag != self.match_tag:
            return
        with self._lock:
            slow = self._slow_at.pop(step, None)
            fail = step in self._fail_at
            if fail:
                self._fail_at.remove(step)
            if slow is not None:
                self.fired.append(("slow", step, tag))
            if fail:
                self.fired.append(("step", step, tag))
        if slow is not None:
            time.sleep(slow)
        if fail:
            raise self.exc_type(f"injected fault at step {step} ({tag!r})")

    def on_compile(self, loop_name: Optional[str]) -> None:
        from repro_torch.compiler import LoweringError

        with self._lock:
            hit = "*" in self._fail_compile or loop_name in self._fail_compile
            if hit:
                self._fail_compile.discard(loop_name)
                self._fail_compile.discard("*")
                self.fired.append(("compile", loop_name))
        if hit:
            raise LoweringError(
                f"injected compile failure for loop {loop_name!r}")

    # -- installation -------------------------------------------------------
    def install(self) -> "FaultInjector":
        from repro_torch.engine import hooks

        self._prev_step = hooks.set_step_hook(self.on_step)
        self._prev_compile = hooks.set_compile_hook(self.on_compile)
        return self

    def uninstall(self) -> None:
        from repro_torch.engine import hooks

        hooks.set_step_hook(self._prev_step)
        hooks.set_compile_hook(self._prev_compile)
        self._prev_step = self._prev_compile = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
