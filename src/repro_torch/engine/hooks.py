"""Executor + planner instrumentation hooks (fault injection, tracing).

Two optional callbacks the engine consults at its natural failure
boundaries:

* the **step hook** fires before the engine advances state — once per
  :func:`repro_torch.engine.execute` call — with a monotonically increasing
  logical step counter.  Raising makes the run fail where a dead device
  would; sleeping models a straggler;
* the **compile hook** fires inside the compile attempt of
  :func:`repro_torch.engine.plan.compile_body`'s pallas branch.  Raising
  :class:`repro_torch.compiler.LoweringError` routes the body through
  ``try_compile``'s catch — counted, logged, interpreter fallback.

Hooks are process-global (matching the engine's global stats).
"""

from __future__ import annotations

from typing import Callable, Optional

_step_hook: Optional[Callable[[int, str], None]] = None
_compile_hook: Optional[Callable[[Optional[str]], None]] = None


def set_step_hook(fn: Optional[Callable[[int, str], None]]):
    """Install ``fn(step, tag)`` as the pre-step hook; returns the previous
    hook so installers can restore it."""
    global _step_hook
    prev, _step_hook = _step_hook, fn
    return prev


def set_compile_hook(fn: Optional[Callable[[Optional[str]], None]]):
    """Install ``fn(loop_name)`` inside the pallas compile attempt; returns
    the previous hook."""
    global _compile_hook
    prev, _compile_hook = _compile_hook, fn
    return prev


def fire_step_hook(step: int, tag: str = "") -> None:
    """Called by the executor before advancing state; exceptions propagate."""
    if _step_hook is not None:
        _step_hook(step, tag)


def fire_compile_hook(loop_name: Optional[str]) -> None:
    """Called inside the pallas compile attempt; a raised ``LoweringError``
    becomes a counted, logged interpreter fallback."""
    if _compile_hook is not None:
        _compile_hook(loop_name)
