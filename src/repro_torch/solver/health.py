"""Numerical-health taxonomy and guarded-iteration helpers.

Every iterative method in :mod:`repro_torch.solver.krylov` carries a small
*health word* through its loop so failures are classified — and stopped —
instead of silently mislabelled: a NaN residual makes ``rr > tol*tol``
False, so an unguarded loop would exit on its first poisoned iteration and
report the garbage iterate as converged.  The guard costs **zero extra
reductions**: it inspects only scalars the iteration already computed
(``rr``, the BiCGSTAB recurrence coefficients).

The reference keeps the guard in the ``while_loop`` carry as int32 words on
the device.  The port's loops are Python loops that read the iteration's
residual scalar back once per iteration for the stop test, so the guard
runs on the host over those Python floats: the same rules, the same words.

Outcome taxonomy:

=============  =============================================================
``CONVERGED``  residual is finite and ``‖r‖ ≤ tol`` — the only success word
``MAXITER``    iteration budget exhausted with a finite residual
``NAN_RESIDUAL``  the residual norm became NaN/Inf (poisoned state or rhs)
``BREAKDOWN``  a Krylov recurrence denominator collapsed (BiCGSTAB ρ/ω)
``STAGNATED``  no new best residual for ``stagnation_window`` iterations
``DIVERGED``   residual grew ≥ ``divergence_factor`` × its best-so-far
=============  =============================================================

:class:`RecoveryPolicy`, :class:`RecoveryTrace` and
:class:`RecoveryAttempt` are the data of the reference's escalation ladder;
the ladder itself comes with the port's health slice
(``RunOptions(recovery=...)`` raises until then).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

# -- outcome codes ----------------------------------------------------------

RUNNING = -1  # internal: loop still iterating (never escapes classify())
CONVERGED = 0
MAXITER = 1
NAN_RESIDUAL = 2
BREAKDOWN = 3
STAGNATED = 4
DIVERGED = 5

OUTCOME_NAMES = (
    "CONVERGED",
    "MAXITER",
    "NAN_RESIDUAL",
    "BREAKDOWN",
    "STAGNATED",
    "DIVERGED",
)

#: hard numerical failures — anything here means the iterate is not to be
#: trusted; MAXITER is "ran out of budget"
FAILURES = (NAN_RESIDUAL, BREAKDOWN, STAGNATED, DIVERGED)

#: below this magnitude a BiCGSTAB recurrence scalar (ρ, (r0, v)) counts as
#: a serious breakdown
BREAKDOWN_TINY = 1e-25


def outcome_name(code) -> str:
    """Python-side name for one outcome word."""
    code = int(code)
    if code == RUNNING:
        return "RUNNING"
    return OUTCOME_NAMES[code]


def outcome_names(codes) -> np.ndarray:
    """Vectorized :func:`outcome_name` — (steps,) arrays."""
    arr = np.asarray(codes)
    return np.vectorize(outcome_name, otypes=["U12"])(arr)


def is_failure(code, *, on_maxiter: bool = False) -> bool:
    """True when this outcome word needs recovery (scalar)."""
    code = int(code)
    return code in FAILURES or (on_maxiter and code == MAXITER)


def any_failure(codes, *, on_maxiter: bool = False) -> bool:
    """True when any outcome in an array needs recovery."""
    return any(
        is_failure(c, on_maxiter=on_maxiter) for c in np.asarray(codes).ravel()
    )


def worst(codes) -> int:
    """Most severe outcome in an array (severity = taxonomy order)."""
    severity = (MAXITER, STAGNATED, DIVERGED, BREAKDOWN, NAN_RESIDUAL)
    flat = [int(c) for c in np.asarray(codes).ravel()]
    for code in reversed(severity):
        if code in flat:
            return code
    return CONVERGED


# -- in-loop guard ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Thresholds for the in-loop divergence/stagnation windows.

    Defaults are deliberately loose — a legitimate Krylov solve riding an
    fp32 rounding floor must never trip them; they exist to stop *hopeless*
    iterations from burning the full ``maxiter`` budget.
    """

    divergence_factor: float = 1e4  # rr > factor × best-so-far ⇒ DIVERGED
    stagnation_window: int = 200  # iterations without a new best ⇒ STAGNATED


DEFAULT_GUARD = GuardConfig()

#: the guard carry: (status word, best residual so far, iterations since)
Guard = Tuple[int, float, int]


def guard_init(rr: float) -> Guard:
    """Initial guard for a loop observing the residual scalar ``rr``.

    A non-finite *entry* residual is classified at exit (the loop never
    runs); best starts at +inf then so the comparisons stay meaningful.
    """
    return (RUNNING, rr if math.isfinite(rr) else math.inf, 0)


def running(g: Guard) -> bool:
    """Loop-condition term: True while the guard has not tripped."""
    return g[0] == RUNNING


def guard_update(g: Guard, rr_new: float, *, breakdown: bool = False,
                 config: Optional[GuardConfig] = None) -> Guard:
    """Advance the guard with this iteration's residual scalar.

    ``breakdown`` is a predicate the iteration already computed.  First
    failure wins: a tripped status never changes.
    """
    config = config or DEFAULT_GUARD
    status, best, since = g
    finite = math.isfinite(rr_new)
    improved = finite and rr_new < best
    since_new = 0 if improved else since + 1
    diverged = finite and rr_new > config.divergence_factor * best
    stagnated = (config.stagnation_window > 0
                 and since_new >= config.stagnation_window)
    # BREAKDOWN outranks the NaN it typically causes in the same iteration
    # (the collapsed denominator is the diagnosis, the NaN the symptom)
    if breakdown:
        cand = BREAKDOWN
    elif not finite:
        cand = NAN_RESIDUAL
    elif diverged:
        cand = DIVERGED
    elif stagnated:
        cand = STAGNATED
    else:
        cand = RUNNING
    status_new = cand if status == RUNNING else status
    return (status_new, rr_new if improved else best, since_new)


def classify(g: Guard, rr: float, tol2: float) -> int:
    """Final outcome word at loop exit.

    Ordering is the safety contract: CONVERGED requires a *finite* residual
    at or below tolerance — no path can label a non-finite answer CONVERGED
    — then a tripped in-loop status, then NAN_RESIDUAL for an unclassified
    non-finite exit (e.g. poisoned entry state, where the loop never ran),
    then MAXITER.
    """
    finite = math.isfinite(rr)
    if finite and rr <= tol2:
        return CONVERGED
    if g[0] != RUNNING:
        return g[0]
    return NAN_RESIDUAL if not finite else MAXITER


def classify_fixed(rr: float, tol2: float) -> int:
    """Outcome word for a fixed-iteration method's end-of-run residual."""
    if not math.isfinite(rr):
        return NAN_RESIDUAL
    return CONVERGED if rr <= tol2 else MAXITER


# -- recovery policies (data only in this slice) ----------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounded escalation ladder for failed solves (the reference's rungs:
    restart, method escalation, fp64 safe mode)."""

    max_restarts: int = 1  # same-method restart from the last iterate
    escalate: bool = True  # cg/pipecg → bicgstab (handles asymmetry)
    safe_mode_fp64: bool = True  # one fp64 re-solve as the last rung
    detile_explicit: bool = True  # explicit plans: retry k=1, overlap off
    on_maxiter: bool = False  # also escalate plain MAXITER exits


@dataclasses.dataclass
class RecoveryAttempt:
    """One rung of the ladder: what ran and how it ended."""

    method: str
    dtype: str
    outcome: str
    iterations: int
    residual: float
    reason: str  # why this attempt ran ("initial", "restart after …", …)


@dataclasses.dataclass
class RecoveryTrace:
    """Ordered log of every attempt a recovering solve made."""

    attempts: List[RecoveryAttempt] = dataclasses.field(default_factory=list)

    def record(self, method, dtype, outcome, iterations, residual, reason):
        self.attempts.append(
            RecoveryAttempt(
                method=str(method),
                dtype=str(dtype),
                outcome=str(outcome),
                iterations=int(iterations),
                residual=float(residual),
                reason=str(reason),
            )
        )

    @property
    def succeeded(self) -> bool:
        return bool(self.attempts) and self.attempts[-1].outcome == "CONVERGED"

    def summary(self) -> tuple:
        """Compact per-attempt strings for stats/ticket surfaces."""
        return tuple(
            f"{a.reason}: {a.method}/{a.dtype} -> {a.outcome} "
            f"({a.iterations} it, r={a.residual:.3e})"
            for a in self.attempts
        )


class NumericalFault(RuntimeError):
    """A solve or explicit run produced numerically untrustworthy state.

    Attributes: ``outcome`` (taxonomy name), ``step`` (time-step index for
    explicit sentinels, else None), ``trace`` (:class:`RecoveryTrace` or
    None), ``last_good`` (the last finite state, explicit path only).
    """

    def __init__(
        self,
        message: str,
        *,
        outcome: Optional[str] = None,
        step: Optional[int] = None,
        trace: Optional[RecoveryTrace] = None,
        last_good=None,
    ):
        super().__init__(message)
        self.outcome = outcome
        self.step = step
        self.trace = trace
        self.last_good = last_good
