"""Matrix-free Krylov and relaxation iterations, generic over ``(A, dot)``.

The port of ``repro/solver/krylov.py`` for one device.  The operator ``A``
is a plain function (a compiled fused kernel K1 or the roll interpreter),
``dot(a, b)`` returns a 0-d tensor, and ``dot2(a, b, c, d)`` returns the
pair ``(a·b, c·d)`` from one reduction (the fused kernel K2 on the card).

Methods and their per-iteration reduction count (the paper's Eq. 16/17
latency term):

* :func:`cg`         — classic CG, 2 reductions (SPD operators), or PCG with
  a preconditioner ``M`` whose two M-side reductions go through ``dot2``;
* :func:`pipecg`     — Ghysels–Vanroose pipelined CG, 1 fused reduction;
* :func:`bicgstab`   — van der Vorst BiCGSTAB, 4 reductions, 2 operator
  applications, optional right preconditioner;
* :func:`chebyshev`  — reduction-free Chebyshev iteration (eigenvalue
  bounds of ``A``);
* :func:`jacobi`     — reduction-free Jacobi relaxation (the diagonal);
* :func:`stationary` — fixed-point iteration with a relative residual stop,
  the outer loop of ``method="mg"`` (one step = one V/W-cycle).

Every method returns ``(x, iterations, ‖r‖, outcome)``: ``x`` and ``‖r‖``
are tensors on the operands' device, ``iterations`` a Python int and
``outcome`` a :mod:`repro_torch.solver.health` word.

Each ``lax.while_loop`` of the reference is a Python loop here whose stop
test reads the same carry: the guard word, ``rr > tol²`` and ``i <
maxiter``, tested on every iteration.  The vectors and the recurrence
scalars stay on the device in the dots' accumulation dtype
(``promote(dtype, float32)``), as in the reference; the stop test copies
the iteration's residual scalar (BiCGSTAB: with its three breakdown
scalars, in one transfer) to the host, which is one synchronisation per
iteration — the reference's loop never leaves the device.  The fixed-count
methods (Chebyshev, Jacobi) never synchronise inside the loop.

The ``*_batched`` variants solve B independent systems stacked on a
leading axis in one masked loop (the reference's ensembles): ``A`` applies
the operator to the whole ``(B, X, Y, Z)`` stack, ``dot`` reduces per
member to a ``(B,)`` vector, and every scalar recurrence runs elementwise
over the members.  The loop runs until the slowest member stops; a member
that stops early is **frozen bitwise** — all of its carried state is held
with ``torch.where(active, new, old)``, never an arithmetic no-op — and its
iteration count stops there.  Each iteration copies one ``(B,)`` residual
vector to the host (BiCGSTAB: ``(4, B)``, with its breakdown scalars), in
one transfer, where each member's guard runs; they return per-member
iteration counts, residuals and outcome words.  The fixed-count methods
(Chebyshev, Jacobi) take stacks as they are and classify each member's
end-of-run residual.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.solver import health

_TINY = 1e-30


def _nonzero(d):
    """Clamp a denominator away from zero, keeping its sign (fp32 guard)."""
    tiny = torch.full_like(d, _TINY)
    return torch.where(d.abs() < _TINY, torch.where(d < 0, -tiny, tiny), d)


def _read(*vals: torch.Tensor) -> List[float]:
    """Host copies of 0-d tensors in ONE device-to-host transfer — the
    per-iteration synchronisation of the stop test."""
    if len(vals) == 1:
        return [vals[0].item()]
    return torch.stack(vals).tolist()


def _fixed_outcome(rr: torch.Tensor, tol2: float):
    """:func:`health.classify_fixed` of a 0-d residual, or a list of one
    word per member of a ``(B,)`` one (one transfer either way)."""
    vals = rr.tolist()
    if isinstance(vals, list):
        return [health.classify_fixed(v, tol2) for v in vals]
    return health.classify_fixed(vals, tol2)


def _as(v: float, like: torch.Tensor) -> float:
    """``v`` rounded to ``like``'s dtype, as a Python float: the threshold a
    comparison in that dtype sees (the reference's weakly typed
    ``tol * tol``)."""
    return torch.tensor(v, dtype=like.dtype).item()


def cg(
    A: Callable,
    dot: Callable,
    b,
    x0,
    *,
    tol: float = 1e-6,
    maxiter: int = 500,
    M: Callable = None,
    dot2: Callable = None,
    guard: health.GuardConfig = None,
):
    """Classic CG.  Two reductions per iteration: (p, Ap) and (r, r).

    With a preconditioner ``M`` (symmetric positive definite, e.g. one
    multigrid cycle from a zero guess) this is standard PCG, stopping still
    on the *true* residual norm so iteration counts stay comparable to the
    plain method.  The two M-side reductions (r, z) and (r, r) are fused
    through ``dot2(a, b, c, d) -> (a·b, c·d)`` when the caller provides it,
    falling back to two ``dot`` calls otherwise.
    """
    guard = guard or health.DEFAULT_GUARD
    if M is None:
        r = b - A(x0)
        p = r
        rr = dot(r, r)
        tol2 = _as(tol * tol, rr)
        (rr_h,) = _read(rr)
        g = health.guard_init(rr_h)
        x, i = x0, 0
        while health.running(g) and rr_h > tol2 and i < maxiter:
            Ap = A(p)
            pAp = dot(p, Ap)  # reduction 1
            alpha = rr / pAp
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = dot(r, r)  # reduction 2
            beta = rr_new / rr
            p = r + beta * p
            (rr_h,) = _read(rr_new)
            g = health.guard_update(g, rr_h, config=guard)
            rr, i = rr_new, i + 1
        return x, i, torch.sqrt(rr), health.classify(g, rr_h, tol2)

    if dot2 is None:
        dot2 = lambda a, b_, c, d: (dot(a, b_), dot(c, d))  # noqa: E731
    r = b - A(x0)
    z = M(r)
    p = z
    rz, rr = dot2(r, z, r, r)
    tol2 = _as(tol * tol, rr)
    (rr_h,) = _read(rr)
    g = health.guard_init(rr_h)
    x, i = x0, 0
    while health.running(g) and rr_h > tol2 and i < maxiter:
        Ap = A(p)
        alpha = rz / _nonzero(dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr_new = dot2(r, z, r, r)  # ONE fused reduction
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        (rr_h,) = _read(rr_new)
        g = health.guard_update(g, rr_h, config=guard)
        rz, rr, i = rz_new, rr_new, i + 1
    return x, i, torch.sqrt(rr), health.classify(g, rr_h, tol2)


def pipecg(
    A: Callable,
    dot2: Callable,
    b,
    x0,
    *,
    tol: float = 1e-6,
    maxiter: int = 500,
    guard: health.GuardConfig = None,
):
    """Ghysels–Vanroose pipelined CG: ONE fused reduction per iteration.

    ``dot2(a, b, c, d)`` returns (a·b, c·d) in a single reduction.  Every
    25 iterations the recurred r/w are replaced by the true residual (two
    extra SpMVs, amortised 2/25), which restores attainable accuracy at
    warm starts.
    """
    guard = guard or health.DEFAULT_GUARD
    r = b - A(x0)
    w_ = A(r)
    zero = torch.zeros_like(b)
    rr0 = dot2(r, r, r, r)[0]  # true entry residual (warm-start guard)
    replace_every = 25  # periodic residual replacement (fp32 drift)
    tol2 = _as(tol * tol, rr0)
    one = torch.ones((), dtype=rr0.dtype, device=rr0.device)

    x, z, p, sv = x0, zero, zero, zero
    gamma_prev, alpha_prev = rr0, one
    i, fresh = 0, True
    (gamma_prev_h,) = _read(rr0)
    g = health.guard_init(gamma_prev_h)
    # gamma_prev is ‖r‖² of the previous iterate (the true rr0 at entry)
    while health.running(g) and gamma_prev_h > tol2 and i < maxiter:
        gamma, delta = dot2(r, r, w_, r)  # fused reduction
        n = A(w_)
        beta = torch.zeros_like(gamma) if fresh else gamma / gamma_prev
        denom = delta - beta * gamma / (one if fresh else alpha_prev)
        # fp32 pipelined recurrences can hit a vanishing denominator near
        # convergence; clamp to keep the iterate finite (the loop exits next)
        denom = _nonzero(denom)
        alpha = gamma / denom
        z = n + beta * z
        p = r + beta * p
        sv = w_ + beta * sv
        x = x + alpha * p
        r = r - alpha * sv
        w_ = w_ - alpha * z
        fresh = (i + 1) % replace_every == 0
        if fresh:
            r = b - A(x)
            w_ = A(r)
        (gamma_prev_h,) = _read(gamma)
        g = health.guard_update(g, gamma_prev_h, config=guard)
        gamma_prev, alpha_prev, i = gamma, alpha, i + 1
    # one extra reduction per *solve* (not per iteration): classify on the
    # norm of the final residual, not the lagged gamma
    rr = dot2(r, r, r, r)[0]
    (rr_h,) = _read(rr)
    return x, i, torch.sqrt(rr), health.classify(g, rr_h, tol2)


def bicgstab(
    A: Callable,
    dot: Callable,
    b,
    x0,
    *,
    tol: float = 1e-6,
    maxiter: int = 500,
    M: Callable = None,
    guard: health.GuardConfig = None,
):
    """van der Vorst BiCGSTAB — matrix-free, no transpose applications.

    Two operator applications and four reductions per iteration.  An
    optional ``M`` preconditions from the *right* (``A M y = b``, ``x = M
    y``), so the residual — and the stopping test — stay those of the
    original system.  ``|ρ| ≤ tiny`` or ``|(r0, v)| ≤ tiny`` or a zero ω
    with an unconverged residual trips ``BREAKDOWN``.
    """
    guard = guard or health.DEFAULT_GUARD
    if M is None:
        M = lambda v: v  # noqa: E731
    r = b - A(x0)
    r0 = r
    zero_v = torch.zeros_like(b)
    rr = dot(r, r)
    tol2 = _as(tol * tol, rr)
    # scalar recurrences carry the dot's accumulation dtype
    one = torch.ones((), dtype=rr.dtype, device=rr.device)
    x, p, v = x0, zero_v, zero_v
    rho, alpha, omega = one, one, one
    (rr_h,) = _read(rr)
    g = health.guard_init(rr_h)
    i = 0
    while health.running(g) and rr_h > tol2 and i < maxiter:
        rho_new = dot(r0, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = A(ph)
        r0v = dot(r0, v)
        alpha = rho_new / _nonzero(r0v)
        sv = r - alpha * v
        sh = M(sv)
        t = A(sh)
        tt = dot(t, t)
        # t == 0 means sv == 0 (converged mid-iteration): take omega = 0 so
        # the update degenerates to the stable half-step
        omega = torch.where(tt > 0.0, dot(t, sv) / _nonzero(tt),
                            torch.zeros_like(tt))
        x = x + alpha * ph + omega * sh
        r = sv - omega * t
        rr_new = dot(r, r)
        rr_h, rho_h, r0v_h, omega_h = _read(rr_new, rho_new, r0v, omega)
        breakdown = (abs(rho_h) <= health.BREAKDOWN_TINY
                     or abs(r0v_h) <= health.BREAKDOWN_TINY
                     or (omega_h == 0.0 and rr_h > tol2))
        g = health.guard_update(g, rr_h, breakdown=breakdown, config=guard)
        rho, rr, i = rho_new, rr_new, i + 1
    return x, i, torch.sqrt(rr), health.classify(g, rr_h, tol2)


def stationary(
    step: Callable,
    rnorm2: Callable,
    x0,
    *,
    tol: float = 1e-6,
    maxiter: int = 100,
    ref2=None,
    guard: health.GuardConfig = None,
):
    """Fixed-point iteration ``x ← step(x)`` with a residual-norm stop.

    The outer loop of ``method="mg"``: ``step`` is one V/W-cycle and
    ``rnorm2(x)`` the squared fine-level residual norm.  The stop is
    *relative* — ``‖r‖ ≤ tol·√ref2`` with ``ref2`` the squared norm of the
    right-hand side (falling back to the entry residual when absent or
    zero) — because ``rnorm2`` is the true residual recomputed each cycle.
    """
    guard = guard or health.DEFAULT_GUARD
    rr = rnorm2(x0)
    ref2 = rr if ref2 is None else torch.where(ref2 > 0.0, ref2, rr)
    thr = tol * tol * ref2
    rr_h, thr_h = _read(rr, thr)
    g = health.guard_init(rr_h)
    x, i = x0, 0
    while health.running(g) and rr_h > thr_h and i < maxiter:
        x = step(x)
        rr = rnorm2(x)
        (rr_h,) = _read(rr)
        g = health.guard_update(g, rr_h, config=guard)
        i += 1
    return x, i, torch.sqrt(rr), health.classify(g, rr_h, thr_h)


def chebyshev(
    A: Callable,
    b,
    x0,
    lmin: float,
    lmax: float,
    *,
    iters: int = 500,
    dot: Callable = None,
    tol: float = 0.0,
):
    """Reduction-free Chebyshev iteration — no synchronisation per
    iteration.

    ``lmin``/``lmax`` must bracket the spectrum of ``A``.  The optional
    ``dot`` is used ONLY for the final residual report (one reduction per
    solve), which also classifies the outcome against ``tol`` (with the
    default ``tol=0.0`` a finite completion reports MAXITER).
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    r = b - A(x0)
    d = r / theta
    x = x0 + d
    rho = 1.0 / sigma1
    for _ in range(iters):
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    if dot is None:
        rr = torch.sum(r * r, dtype=torch.promote_types(r.dtype, torch.float32))
    else:
        rr = dot(r, r)
    return x, iters, torch.sqrt(rr), _fixed_outcome(rr, _as(tol * tol, rr))


def jacobi(
    step: Callable,
    x0,
    *,
    iters: int = 500,
    rnorm2: Callable = None,
    tol: float = 0.0,
):
    """Reduction-free Jacobi relaxation: ``x ← step(x)`` for ``iters`` steps.

    ``step`` is the damped update ``x + D⁻¹(b − A x)`` (with the Moat pinned
    to ``b`` by the caller).  With ``rnorm2`` the end-of-run residual is
    reported and classified (one extra operator application per solve);
    without it the residual is 0 and the outcome is a finiteness check on
    the iterate, so a poisoned run still cannot read CONVERGED.
    """
    x = x0
    for _ in range(iters):
        x = step(x)
    if rnorm2 is not None:
        rr = rnorm2(x)
        return x, iters, torch.sqrt(rr), _fixed_outcome(rr, _as(tol * tol, rr))
    finite = bool(torch.isfinite(x).all())
    outcome = health.MAXITER if finite else health.NAN_RESIDUAL
    return x, iters, torch.zeros((), device=x.device), outcome


# ---------------------------------------------------------------------------
# batched ensembles: per-member convergence masking
# ---------------------------------------------------------------------------


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(B,)`` per-member scalar shaped to broadcast over ``like``."""
    return s.view(s.shape + (1,) * (like.ndim - 1))


class _Members:
    """The host side of a batched loop: each member's guard, iteration
    count and last residual, and the device mask of members still running
    (re-sent only when a guard trips)."""

    def __init__(self, rr: torch.Tensor, tol2: float, guard):
        self.rr = rr.tolist()
        self.tol2 = tol2
        self.guard = guard or health.DEFAULT_GUARD
        self.g = [health.guard_init(v) for v in self.rr]
        self.its = [0] * len(self.rr)
        self.running = torch.ones(len(self.rr), dtype=torch.bool,
                                  device=rr.device)

    def active(self) -> List[bool]:
        return [health.running(g) and v > self.tol2
                for g, v in zip(self.g, self.rr)]

    def mask(self, rr: torch.Tensor) -> torch.Tensor:
        """The device twin of :meth:`active` for the carried ``rr``."""
        return (rr > self.tol2) & self.running

    def update(self, active: List[bool], rr_new, breakdown=None) -> None:
        """Advance each active member's guard with its new residual."""
        tripped = False
        for m, a in enumerate(active):
            if not a:
                continue
            self.g[m] = health.guard_update(
                self.g[m], rr_new[m],
                breakdown=bool(breakdown and breakdown[m]), config=self.guard)
            self.rr[m] = rr_new[m]
            self.its[m] += 1
            tripped = tripped or not health.running(self.g[m])
        if tripped:
            self.running = torch.tensor([health.running(g) for g in self.g],
                                        device=self.running.device)

    def outcomes(self, rr_final) -> List[int]:
        return [health.classify(g, v, self.tol2)
                for g, v in zip(self.g, rr_final)]


def cg_batched(A, dot, b, x0, *, tol: float = 1e-6, maxiter: int = 500,
               guard: health.GuardConfig = None):
    """Classic CG over a ``(B, …)`` stack; ``dot`` must reduce to ``(B,)``.

    Returns ``(x, iterations, ‖r‖, outcomes)`` with per-member iteration
    counts, residual norms and outcome words.  A poisoned member (NaN
    residual) freezes at once and reports ``NAN_RESIDUAL`` while the others
    run on unperturbed (dots reduce per member and the operator does not
    couple members).  No preconditioner: multigrid is not batch-aware.
    """
    r = b - A(x0)
    p = r
    rr = dot(r, r)
    mem = _Members(rr, _as(tol * tol, rr), guard)
    x, i = x0, 0
    while i < maxiter and any(act := mem.active()):
        active = mem.mask(rr)
        a4 = _bc(active, x)
        Ap = A(p)
        alpha = rr / _nonzero(dot(p, Ap))
        x = torch.where(a4, x + _bc(alpha, x) * p, x)
        r_new = r - _bc(alpha, r) * Ap
        rr_new = dot(r_new, r_new)
        beta = rr_new / _nonzero(rr)
        p = torch.where(a4, r_new + _bc(beta, p) * p, p)
        r = torch.where(a4, r_new, r)
        rr = torch.where(active, rr_new, rr)
        mem.update(act, rr_new.tolist())
        i += 1
    return x, mem.its, torch.sqrt(rr), mem.outcomes(mem.rr)


def pipecg_batched(A, dot2, b, x0, *, tol: float = 1e-6, maxiter: int = 500,
                   guard: health.GuardConfig = None):
    """Pipelined CG over a ``(B, …)`` stack; ``dot2`` reduces to two
    ``(B,)`` vectors.

    The Ghysels–Vanroose recurrences of :func:`pipecg` run elementwise over
    the members, with the periodic residual replacement on the shared
    iteration clock, masked so that frozen members keep their state
    bitwise.  The stop test reads ‖r‖² before the update (``gamma``), the
    one-iteration lag of :func:`pipecg`.
    """
    r = b - A(x0)
    w_ = A(r)
    zero = torch.zeros_like(b)
    rr = dot2(r, r, r, r)[0]  # (B,) true entry residuals
    replace_every = 25
    mem = _Members(rr, _as(tol * tol, rr), guard)
    alpha_prev = torch.ones_like(rr)
    x, z, p, sv = x0, zero, zero, zero
    i, fresh = 0, True
    while i < maxiter and any(act := mem.active()):
        active = mem.mask(rr)
        a4 = _bc(active, x)
        gamma, delta = dot2(r, r, w_, r)
        n = A(w_)
        if fresh:
            beta = torch.zeros_like(gamma)
            denom = _nonzero(delta - beta * gamma / 1.0)
        else:
            beta = gamma / _nonzero(rr)
            denom = _nonzero(delta - beta * gamma / alpha_prev)
        alpha = gamma / denom
        z_new = n + _bc(beta, z) * z
        p_new = r + _bc(beta, p) * p
        sv_new = w_ + _bc(beta, sv) * sv
        x = torch.where(a4, x + _bc(alpha, x) * p_new, x)
        r_new = r - _bc(alpha, r) * sv_new
        w_new = w_ - _bc(alpha, w_) * z_new
        fresh = (i + 1) % replace_every == 0
        if fresh:
            r_new = b - A(x)
            w_new = A(r_new)
        r = torch.where(a4, r_new, r)
        w_ = torch.where(a4, w_new, w_)
        z = torch.where(a4, z_new, z)
        p = torch.where(a4, p_new, p)
        sv = torch.where(a4, sv_new, sv)
        rr = torch.where(active, gamma, rr)
        alpha_prev = torch.where(active, alpha, alpha_prev)
        mem.update(act, gamma.tolist())
        i += 1
    rr = dot2(r, r, r, r)[0]
    return x, mem.its, torch.sqrt(rr), mem.outcomes(rr.tolist())


def bicgstab_batched(A, dot, b, x0, *, tol: float = 1e-6, maxiter: int = 500,
                     guard: health.GuardConfig = None):
    """BiCGSTAB over a ``(B, …)`` stack; ``dot`` must reduce to ``(B,)``.

    The ensemble workhorse: members may carry different coefficients (the
    operator reads per-member coefficient stacks), so each converges at its
    own rate and freezes on its own, with per-member ρ/ω breakdown flags.
    """
    r = b - A(x0)
    r0 = r
    rr = dot(r, r)
    mem = _Members(rr, _as(tol * tol, rr), guard)
    one = torch.ones_like(rr)
    zero_v = torch.zeros_like(b)
    x, p, v = x0, zero_v, zero_v
    rho, alpha, omega = one, one, one
    i = 0
    while i < maxiter and any(act := mem.active()):
        active = mem.mask(rr)
        a4 = _bc(active, x)
        rho_new = dot(r0, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p_new = r + _bc(beta, p) * (p - _bc(omega, v) * v)
        v_new = A(p_new)
        r0v = dot(r0, v_new)
        alpha_new = rho_new / _nonzero(r0v)
        sv = r - _bc(alpha_new, r) * v_new
        t = A(sv)
        tt = dot(t, t)
        omega_new = torch.where(tt > 0.0, dot(t, sv) / _nonzero(tt),
                                torch.zeros_like(tt))
        x = torch.where(a4, x + _bc(alpha_new, x) * p_new
                        + _bc(omega_new, x) * sv, x)
        r_new = sv - _bc(omega_new, sv) * t
        rr_new = dot(r_new, r_new)
        r = torch.where(a4, r_new, r)
        p = torch.where(a4, p_new, p)
        v = torch.where(a4, v_new, v)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha_new, alpha)
        omega = torch.where(active, omega_new, omega)
        rr = torch.where(active, rr_new, rr)
        rr_h, rho_h, r0v_h, omega_h = torch.stack(
            (rr_new, rho_new, r0v, omega_new)).tolist()
        breakdown = [abs(rh) <= health.BREAKDOWN_TINY
                     or abs(rv) <= health.BREAKDOWN_TINY
                     or (om == 0.0 and rn > mem.tol2)
                     for rn, rh, rv, om in zip(rr_h, rho_h, r0v_h, omega_h)]
        mem.update(act, rr_h, breakdown)
        i += 1
    return x, mem.its, torch.sqrt(rr), mem.outcomes(mem.rr)
