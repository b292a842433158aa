"""``wfa.solve`` — matrix-free implicit solves through the program compiler.

The port of ``repro/solver/api.py`` for one device.  The operator body
recorded inside ``with Operator():`` (see :mod:`repro_torch.solver.frontend`)
compiles through the engine's single backend dispatch
(:func:`repro_torch.engine.compile_body`) into one launch of the fused
stencil kernel K1 per operator application on ``backend="pallas"`` —
kernel cache, stats counters and logged interpreter fallback included — and
the matrix-free iterations of :mod:`repro_torch.solver.krylov` run on top
of the compiled application.  ``method="mg"`` / ``precondition="mg"`` add
geometric multigrid (:mod:`repro_torch.solver.multigrid`, transfers K3/K4).
On ``backend="pallas"`` the fused dot pair of PCG and pipelined CG is the
kernel K2 (:func:`repro_torch.kernels.ops.dual_dot`).

Entry points:

* :func:`solve` — run a recorded system to convergence (also reachable as
  ``WFAInterface.solve``);
* :func:`make_solver` — build a reusable solver ``step_fn(x0)``;
* :func:`operator_fns` — just the compiled ``(A, rhs)`` applications.

Every entry point runs on the card unless the caller asks for the host
(``RunOptions(device="cpu")``, or ``device="cpu"`` for ``make_solver`` and
``operator_fns``).  ``RunOptions(batch=B)`` solves a B-member ensemble in
one masked Krylov loop (:mod:`repro_torch.solver.krylov`'s ``*_batched``
variants), the operator one K1 launch for all members.
``RunOptions(mesh=…)`` solves on the bricks of a mesh
(:func:`make_sharded_solver`): the same Krylov loops on
:class:`~repro_torch.core.mesh.BrickArray` vectors.
``RunOptions(recovery=RecoveryPolicy(…))`` drives the bounded escalation
ladder on a failed single-device solve (:func:`_recover_solve`: restart,
cg/pipecg → bicgstab, one float64 re-solve), and
``RunOptions(differentiable=True)`` / ``make_solver(differentiable=True)``
route through the implicit-function-theorem adjoint
(:mod:`repro_torch.solver.adjoint`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compiler import LoweringError, Tap, lower_group
from repro_torch.core.program import Program, _group_ops, release_program
from repro_torch.solver import health, krylov

log = logging.getLogger("repro_torch.solver")

METHODS = ("cg", "pipecg", "bicgstab", "chebyshev", "jacobi", "mg")

#: methods that never touch a dot product — no reduction (and no host
#: synchronisation) per iteration
REDUCTION_FREE = ("chebyshev", "jacobi")

#: methods that accept ``precondition="mg"`` (CG needs an SPD M; BiCGSTAB
#: preconditions from the right, so any fixed linear M works)
PRECONDITIONABLE = ("cg", "bicgstab")


@dataclasses.dataclass
class SolveInfo:
    """Per-call convergence record returned by ``solve(..., return_info=True)``.

    ``outcomes`` holds the :mod:`repro_torch.solver.health` taxonomy name
    per time step (``CONVERGED`` / ``MAXITER`` / ``NAN_RESIDUAL`` /
    ``BREAKDOWN`` / ``STAGNATED`` / ``DIVERGED``); ``recovery`` is the
    :class:`~repro_torch.solver.health.RecoveryTrace` of a solve the
    recovery ladder rescued (None otherwise).  On a batched solve (``batch=B >
    1``) ``iterations``, ``residual`` and ``outcomes`` carry a trailing
    member axis, shape ``(steps, B)``, with each member's own count."""

    method: str
    backend: str
    iterations: np.ndarray  # (steps,) or (steps, B) inner iterations
    residual: np.ndarray  # (steps,) or (steps, B) final ‖r‖
    outcomes: Optional[np.ndarray] = None  # (steps,) or (steps, B) names
    recovery: Optional["health.RecoveryTrace"] = None


# ---------------------------------------------------------------------------
# program splitting + validation
# ---------------------------------------------------------------------------


def _answer_name(program: Program, answer) -> str:
    name = getattr(answer, "name", answer)
    if name not in program.fields:
        raise ValueError(f"answer field {name!r} is not registered in this program")
    return name


def _split(program: Program, answer: str):
    """-> ((op_loop, op_ops), (rhs_loop, rhs_ops) | None), validated."""
    op_groups, rhs_groups = [], []
    for loop, ops in _group_ops(program):
        role = getattr(loop, "role", None)
        if role == "operator":
            op_groups.append((loop, ops))
        elif role == "rhs":
            rhs_groups.append((loop, ops))
        else:
            raise ValueError(
                "wfa.solve programs may only contain Operator()/Rhs() "
                f"groups; found updates under {getattr(loop, 'name', loop)!r}"
            )
    if len(op_groups) != 1:
        raise ValueError(
            f"expected exactly one Operator() group, found {len(op_groups)}"
        )
    if len(rhs_groups) > 1:
        raise ValueError(f"expected at most one Rhs() group, found {len(rhs_groups)}")
    for _, ops in op_groups + rhs_groups:
        written = {op.field_name for op in ops}
        if written != {answer}:
            raise ValueError(
                "Operator()/Rhs() bodies must update only the unknown field "
                f"{answer!r}; they write {sorted(written)}"
            )
    return op_groups[0], (rhs_groups[0] if rhs_groups else None)


def _lower_operator(op_ops: Sequence, answer: str):
    """Lower the operator body for validation / bounds / diagonal extraction.

    Returns the :class:`LoweredGroup`, or ``None`` when the body is not
    affine-lowerable (the application then runs on the interpreter fallback
    and linearity cannot be checked statically).  Raises ``ValueError`` for
    bodies that lower but are *not linear* in the unknown.
    """
    try:
        group = lower_group(op_ops)
    except LoweringError:
        return None
    for u in group.updates:
        if u.const != 0.0:
            raise ValueError(
                f"operator body has a constant term ({u.const}); A(x) must "
                "be linear in the unknown — move constants into the Rhs()"
            )
        for coeff, taps in u.terms:
            n_unknown = sum(t.field == answer for t in taps)
            if n_unknown == 0:
                raise ValueError(
                    "operator term reads only coefficient fields — an "
                    "affine shift; move it into the Rhs()"
                )
            if n_unknown > 1:
                raise ValueError(
                    "operator body is nonlinear in the unknown "
                    f"({n_unknown} taps of {answer!r} multiplied); Krylov "
                    "methods need a linear operator"
                )
    return group


def gershgorin_bounds(group, answer: str) -> Optional[Tuple[float, float]]:
    """Eigenvalue bounds of the lowered operator via Gershgorin circles.

    Only for constant-coefficient single-update bodies (every term one tap
    of the unknown): centre = diagonal coefficient, radius = Σ|off-diagonal|.
    The identity Moat rows contribute eigenvalue 1, so the bracket is widened
    to include it.  Returns ``None`` when bounds cannot be derived (variable
    coefficients) or the operator is indefinite — pass ``lambda_bounds=``.
    """
    if group is None or len(group.updates) != 1:
        return None
    diag = 0.0
    radius = 0.0
    for coeff, taps in group.updates[0].terms:
        if len(taps) != 1 or taps[0].field != answer:
            return None
        t = taps[0]
        if (t.dz, t.dx, t.dy) == (0, 0, 0):
            diag += coeff
        else:
            radius += abs(coeff)
    lmin = min(diag - radius, 1.0)
    lmax = max(diag + radius, 1.0)
    if lmin <= 0.0:
        return None
    return lmin, lmax


def _resolve_bounds(method, lambda_bounds, group, answer):
    if method != "chebyshev":
        return None
    bounds = lambda_bounds or gershgorin_bounds(group, answer)
    if bounds is None:
        raise ValueError(
            "chebyshev needs eigenvalue bounds: the operator does not admit "
            "automatic Gershgorin bounds — pass lambda_bounds=(lmin, lmax)"
        )
    return float(bounds[0]), float(bounds[1])


def _check_jacobi(method, group):
    if method == "jacobi" and (group is None or len(group.updates) != 1):
        raise ValueError(
            "jacobi needs a lowerable single-update affine operator (the "
            "diagonal is read off the tap form); use bicgstab instead"
        )


def _check_precondition(method, precondition):
    if precondition not in (None, "mg"):
        raise ValueError(
            f"unknown preconditioner {precondition!r}; expected None or 'mg'"
        )
    if precondition is not None and method not in PRECONDITIONABLE:
        hint = " (method='mg' is already multigrid)" if method == "mg" else ""
        raise ValueError(
            f"precondition='mg' supports methods {PRECONDITIONABLE}; "
            f"got method={method!r}{hint}"
        )


def _build_mg(method, precondition, group, name, shape, dtype, backend, mg_opts,
              device):
    """Build the multigrid hierarchy when ``method``/``precondition`` asks.

    ``method="mg"`` turns an illegal system (grid not coarsenable,
    non-affine / variable-coefficient / asymmetric operator) into a clear
    ``ValueError``; ``precondition="mg"`` degrades gracefully — a logged
    warning and a fallback to the unpreconditioned method.
    """
    if method != "mg" and precondition != "mg":
        return None
    from repro_torch.solver.multigrid import build_multigrid

    try:
        return build_multigrid(group, name, shape, dtype, backend, mg_opts,
                               device)
    except LoweringError as e:
        if method == "mg":
            raise ValueError(f"method='mg' cannot be built: {e}") from e
        log.warning(
            "precondition='mg' unavailable (%s) — falling back to "
            "unpreconditioned %s",
            e,
            method,
        )
        return None


def _jacobi_diag(group, answer: str, env):
    """Diagonal of the operator: a scalar, or a tensor for variable
    coefficients (center-tap products only)."""
    diag = None
    for coeff, taps in group.updates[0].terms:
        mine = [t for t in taps if t.field == answer]
        if mine != [Tap(answer, 0, 0, 0)]:
            continue  # off-diagonal term
        term = coeff
        for t in taps:
            if t.field == answer:
                continue
            if (t.dz, t.dx, t.dy) != (0, 0, 0):
                raise ValueError(
                    "jacobi: coefficient tap with nonzero offset is not "
                    "supported; use bicgstab"
                )
            term = term * env[t.field]
        diag = term if diag is None else diag + term
    if diag is None:
        raise ValueError("jacobi: operator has no diagonal (center) tap")
    return diag


def _z_window(group, nz: int) -> np.ndarray:
    """(1, 1, Z) bool mask of the z planes the operator body writes."""
    z = np.zeros((1, 1, nz), dtype=bool)
    for u in group.updates:
        z[..., u.z0 : u.z0 + u.zlen] = True
    return z


def _written_mask(group, shape) -> np.ndarray:
    """(X, Y, Z) bool mask of cells the operator body writes (the rest are
    identity rows)."""
    nx, ny, nz = shape
    m = np.zeros((nx, ny, 1), dtype=bool)
    m[1:-1, 1:-1] = True
    return m & _z_window(group, nz)


# ---------------------------------------------------------------------------
# step construction
# ---------------------------------------------------------------------------


def _method_runner(
    *,
    method: str,
    name: str,
    dot: Callable,
    dot2: Callable,
    tol: float,
    maxiter: int,
    bounds,
    group,
    jacobi_mask: Optional[torch.Tensor],
    mg=None,
    M: Optional[Callable] = None,
    batch: int = 1,
):
    """``run_method(A, b, x0, envc) -> (x, iterations, ‖r‖, outcome)``: one
    solve of ``A x = b`` warm-started at ``x0`` with ``method`` (``envc``,
    the coefficient env, serves Jacobi's diagonal).  Shared by the forward
    solves of :func:`_make_runner` and the adjoint solves of
    :mod:`repro_torch.solver.adjoint`."""

    def run_method(A, b, x0, envc):
        if method == "mg":
            return krylov.stationary(
                lambda x: mg.cycle(x, b),
                lambda x: mg.residual_norm2(x, b, dot),
                x0,
                tol=tol,
                maxiter=maxiter,
                ref2=dot(b, b),
            )
        if method == "cg":
            if batch > 1:
                return krylov.cg_batched(A, dot, b, x0, tol=tol,
                                         maxiter=maxiter)
            return krylov.cg(
                A, dot, b, x0, tol=tol, maxiter=maxiter, M=M, dot2=dot2
            )
        if method == "pipecg":
            if batch > 1:
                return krylov.pipecg_batched(A, dot2, b, x0, tol=tol,
                                             maxiter=maxiter)
            return krylov.pipecg(A, dot2, b, x0, tol=tol, maxiter=maxiter)
        if method == "bicgstab":
            if batch > 1:
                return krylov.bicgstab_batched(A, dot, b, x0, tol=tol,
                                               maxiter=maxiter)
            return krylov.bicgstab(A, dot, b, x0, tol=tol, maxiter=maxiter, M=M)
        if method == "chebyshev":
            return krylov.chebyshev(
                A, b, x0, bounds[0], bounds[1], iters=maxiter, dot=dot, tol=tol
            )
        D = _jacobi_diag(group, name, envc)
        jstep = lambda x: torch.where(jacobi_mask, x + (b - A(x)) / D, b)  # noqa: E731
        # one extra operator application per solve reports + classifies the
        # true end-of-run residual (jacobi is otherwise reduction-free)
        return krylov.jacobi(
            jstep,
            x0,
            iters=maxiter,
            rnorm2=lambda x: dot(b - A(x), b - A(x)),
            tol=tol,
        )

    return run_method


def _make_runner(
    *,
    method: str,
    name: str,
    coef_names,
    op_step: Callable,
    rhs_step: Optional[Callable],
    dot: Callable,
    dot2: Callable,
    tol: float,
    maxiter: int,
    steps: int,
    bounds,
    group,
    jacobi_mask: Optional[torch.Tensor],
    mg=None,
    M: Optional[Callable] = None,
    batch: int = 1,
):
    """Solve loop: ``run(x0, *coefs) -> (x, (iters, res, outcomes))``.

    Per time step the ``Rhs()`` body produces ``b`` from the state (the
    identity when none was recorded) and the method solves ``A x = b``
    warm-started at the state; the reference's ``lax.scan`` over steps is a
    Python loop.  ``mg`` carries the compiled
    :class:`~repro_torch.solver.multigrid.Multigrid` for ``method="mg"``;
    ``M`` is the preconditioner action for CG/BiCGSTAB; ``jacobi_mask``
    marks the cells the operator writes (``method="jacobi"`` only).  ``iters`` and
    ``outcomes`` are int32 arrays of shape ``(steps,)``, ``res`` the final
    ``‖r‖`` per step in the dots' accumulation dtype.

    ``batch=B > 1`` routes the Krylov methods to their masked batched
    variants (``dot``/``dot2`` then reduce to ``(B,)`` vectors) and gives
    the fixed-count methods' shared iteration count to every member, so
    all three arrays are ``(steps, B)``.
    """
    run_method = _method_runner(
        method=method, name=name, dot=dot, dot2=dot2, tol=tol,
        maxiter=maxiter, bounds=bounds, group=group, jacobi_mask=jacobi_mask,
        mg=mg, M=M, batch=batch)

    def run(x0, *coef_args):
        envc = dict(zip(coef_names, coef_args))

        def A(v):
            env = dict(envc)
            env[name] = v
            return op_step(env)[name]

        x = x0
        iters, res, outcomes = [], [], []
        for _ in range(steps):
            if rhs_step is not None:
                env = dict(envc)
                env[name] = x
                b = rhs_step(env)[name]
            else:
                b = x
            x, i, r, outcome = run_method(A, b, x, envc)
            if batch > 1:
                # a fixed-count method reports one shared count; make every
                # method's (iters, res, outcome) per member
                i = np.broadcast_to(np.asarray(i, np.int32), (batch,))
                r = torch.broadcast_to(r, (batch,))
                outcome = np.broadcast_to(np.asarray(outcome, np.int32),
                                          (batch,))
            iters.append(i)
            res.append(r)
            outcomes.append(outcome)
        res = torch.stack(res).cpu().numpy()
        return x, (np.asarray(iters, np.int32), res,
                   np.asarray(outcomes, np.int32))

    return run


def _build_step(ops, loop, program: Program, backend: str, device,
                batch: int = 1) -> Callable:
    """One body application ``env -> env`` through the engine's single
    dispatch point (:func:`repro_torch.engine.compile_body`): the fused
    kernel K1 when ``backend="pallas"`` (interpreter fallback on
    LoweringError, counted in ``repro_torch.compiler.stats``), the shared
    roll interpreter otherwise; over ``(B, X, Y, Z)`` member stacks at
    ``batch=B > 1``."""
    from repro_torch.engine import compile_body

    if backend not in ("jit", "pallas"):
        raise ValueError(f"unknown solver backend {backend!r}")
    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    step, _ = compile_body(ops, loop, shapes, dtypes, backend, device=device,
                           batch=batch)
    return step


def _dots(backend: str, batch: int = 1):
    """``(dot, dot2)`` of a single-device solve.

    Dots accumulate in ``promote(dtype, float32)``, as the reference's do:
    a float32 field keeps float32 sums, a float64 one float64 sums; a
    batched solve reduces each member over its (X, Y, Z) axes.  ``dot2``
    is the fused dual-dot kernel K2 on the card with ``backend="pallas"``
    (its plain version on the host; unlike the reference, no interpret-mode
    switch decides) and two ``dot``s otherwise."""
    dims = (1, 2, 3) if batch > 1 else None

    def dot(a, b):
        acc = torch.promote_types(a.dtype, torch.float32)
        if dims is None:
            return torch.sum(a * b, dtype=acc)
        return torch.sum(a * b, dim=dims, dtype=acc)

    def dot2(a, b, c, d):
        from repro_torch.kernels import ops as kops

        if backend == "pallas" and batch == 1:
            part = kops.dual_dot(a, b, c, d)  # one fused operand sweep
            return part[0], part[1]
        return dot(a, b), dot(c, d)

    return dot, dot2


def operator_fns(program: Program, answer, backend: str = "jit", device="cuda"):
    """Compiled single-device ``(A, rhs)`` applications for a recorded system.

    ``A(v)`` applies the operator body with the unknown bound to ``v``
    (coefficient fields are closed over from their init data, on
    ``device``); ``rhs(T)`` produces ``b`` from the state — the identity
    when no ``Rhs()`` group was recorded.
    """
    from repro_torch.engine import resolve_device

    device = resolve_device(device)
    name = _answer_name(program, answer)
    release_program(program)
    (op_loop, op_ops), rhs_group = _split(program, name)
    _lower_operator(op_ops, name)
    op_step = _build_step(op_ops, op_loop, program, backend, device)
    consts = {
        n: torch.tensor(f.init_data, device=device)
        for n, f in program.fields.items()
        if n != name
    }

    def A(v):
        env = dict(consts)
        env[name] = v
        return op_step(env)[name]

    if rhs_group is None:
        return A, (lambda T: T)
    rhs_step = _build_step(rhs_group[1], rhs_group[0], program, backend, device)

    def rhs(T):
        env = dict(consts)
        env[name] = T
        return rhs_step(env)[name]

    return A, rhs


# ---------------------------------------------------------------------------
# single-device solver
# ---------------------------------------------------------------------------


def make_solver(
    program: Program,
    answer,
    *,
    method: str = "cg",
    backend: str = "pallas",
    tol: float = 1e-6,
    maxiter: int = 500,
    steps: int = 1,
    lambda_bounds: Optional[Tuple[float, float]] = None,
    precondition: Optional[str] = None,
    mg_opts=None,
    batch: int = 1,
    member_env=None,
    differentiable: bool = False,
    device="cuda",
) -> Callable:
    """Build a reusable solver ``step_fn(x0) -> (x, (iters, res, outcomes))``.

    Each call advances ``steps`` implicit time steps: per step the ``Rhs()``
    body produces ``b`` from the state (identity if none was recorded) and
    the iteration solves ``A x = b`` warm-started at the state.
    ``method="mg"`` iterates geometric V/W-cycles; ``precondition="mg"``
    wraps one cycle from a zero guess around CG/BiCGSTAB (tune with
    ``mg_opts=MGOptions(...)``).

    ``x0`` is a NumPy array or a tensor; ``step_fn`` copies it to
    ``device`` (a clone, where the reference donates its buffer), so the
    caller's array is never touched.  ``x`` comes back as a tensor on
    ``device``, ``iters``/``res``/``outcomes`` as host arrays of shape
    ``(steps,)``.  ``member_env`` overrides coefficient fields' init data.

    ``batch=B > 1`` builds an ensemble solver: ``step_fn`` takes and
    returns a ``(B, X, Y, Z)`` stack, the operator is one K1 launch for all
    members, dots reduce per member, and the Krylov loops freeze converged
    members while running to the slowest (see
    :mod:`repro_torch.solver.krylov`); the three arrays are ``(steps, B)``.
    ``member_env`` then holds ``(B, X, Y, Z)`` stacks for coefficient fields
    (the others broadcast from their init data).  Multigrid is not
    batch-aware: ``method="mg"`` and ``precondition=`` raise ``ValueError``
    with ``batch > 1``.

    ``differentiable=True`` returns a solver that is reverse-mode
    differentiable via the implicit-function-theorem adjoint
    (:mod:`repro_torch.solver.adjoint`): the same ``step_fn(x0) -> (x,
    (iters, res, outcomes))`` contract, with ``x`` carrying an autograd
    graph back to ``x0`` and the coefficient fields.  Requires ``batch=1``
    and a Krylov/mg method; non-affine operator bodies raise instead of
    falling back to the interpreter.
    """
    from repro_torch.engine import resolve_device

    if differentiable:
        if batch > 1:
            raise ValueError(
                "differentiable solves need batch=1 (vmap the returned "
                "solver for ensembles of gradients)"
            )
        from repro_torch.solver.adjoint import make_differentiable_solver

        member_env = member_env or {}
        solve_fn = make_differentiable_solver(
            program,
            answer,
            method=method,
            backend="pallas" if backend is None else backend,
            tol=tol,
            maxiter=maxiter,
            steps=steps,
            precondition=precondition,
            mg_opts=mg_opts,
            return_info=True,
            device=device,
        )

        def diff_step_fn(x0):
            coef = {n: member_env[n] for n in solve_fn.coef_names
                    if n in member_env}
            return solve_fn(x0, coef)

        diff_step_fn.symmetric_adjoint = solve_fn.symmetric_adjoint
        return diff_step_fn
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    _check_precondition(method, precondition)
    if batch > 1 and (method == "mg" or precondition is not None):
        raise ValueError(
            "batched solves support the pointwise/Krylov methods only; "
            "method='mg' and precondition= need batch=1 (the multigrid "
            "hierarchy is not batch-aware)"
        )
    name = _answer_name(program, answer)
    release_program(program)
    (op_loop, op_ops), rhs_group = _split(program, name)
    group = _lower_operator(op_ops, name)
    bounds = _resolve_bounds(method, lambda_bounds, group, name)
    _check_jacobi(method, group)
    device = resolve_device(device)
    field = program.fields[name]
    mg = _build_mg(
        method,
        precondition,
        group,
        name,
        field.shape,
        field.dtype,
        backend,
        mg_opts,
        device,
    )
    op_step = _build_step(op_ops, op_loop, program, backend, device, batch)
    rhs_step = (
        _build_step(rhs_group[1], rhs_group[0], program, backend, device,
                    batch)
        if rhs_group is not None
        else None
    )
    member_env = member_env or {}
    coef_names = [n for n in program.fields if n != name]

    def _coef(n):
        v = np.asarray(member_env.get(n, program.fields[n].init_data))
        if batch > 1 and v.ndim == 3:
            v = np.broadcast_to(v, (batch,) + v.shape).copy()
        return torch.tensor(v, device=device)

    coefs = [_coef(n) for n in coef_names]
    shape = program.fields[name].shape
    mask = (torch.tensor(_written_mask(group, shape), device=device)
            if method == "jacobi" else None)

    dot, dot2 = _dots(backend, batch)
    run = _make_runner(
        method=method,
        name=name,
        coef_names=coef_names,
        op_step=op_step,
        rhs_step=rhs_step,
        dot=dot,
        dot2=dot2,
        tol=tol,
        maxiter=maxiter,
        steps=steps,
        bounds=bounds,
        group=group,
        jacobi_mask=mask,
        mg=mg,
        M=mg.apply if (mg is not None and precondition == "mg") else None,
        batch=batch,
    )

    def step_fn(x0):
        if isinstance(x0, torch.Tensor):
            x0 = x0.to(device=device, copy=True)
        else:
            x0 = torch.tensor(np.asarray(x0), device=device)
        return run(x0, *coefs)

    return step_fn


def make_sharded_solver(
    program: Program,
    answer,
    mesh,
    *,
    method: str = "cg",
    backend: str = "pallas",
    tol: float = 1e-6,
    maxiter: int = 500,
    steps: int = 1,
    lambda_bounds: Optional[Tuple[float, float]] = None,
    precondition: Optional[str] = None,
    mg_opts=None,
    member_env=None,
):
    """Brick-sharded solver over ``mesh`` (a
    :class:`repro_torch.core.mesh.Mesh`); returns ``(step_fn, sharding)``.

    ``step_fn(x0) -> (x, (iters, res, outcomes))`` takes the global guess
    (a NumPy array, a tensor or a :class:`~repro_torch.core.mesh.BrickArray`
    of ``sharding``) and returns ``x`` as a BrickArray.  The Krylov loops of
    :mod:`repro_torch.solver.krylov` run unchanged on BrickArray vectors:
    operator and ``Rhs()`` applications go through the engine's dispatch on
    the mesh (:func:`repro_torch.engine.compile_body`: K1 per brick on
    halo-padded bricks, or the roll interpreter); ``dot`` is a local sum
    per brick in ``promote(dtype, float32)`` and one ``psum``, ``dot2`` K2
    per brick on ``backend="pallas"`` (its plain version elsewhere) and
    one ``psum`` of the pairs; the Jacobi mask is each brick's Moat mask
    and the written z window.

    Multigrid runs gathered, as the reference's does (coarsening stops
    dividing the mesh): ``precondition="mg"`` gathers ``r`` to the mesh's
    home device, applies one cycle there (once, since one process holds
    every brick) and cuts the result back into bricks; ``method="mg"``
    runs the single-device iteration (:func:`make_solver`) on the gathered
    field and coefficients.  ``member_env`` overrides coefficient fields'
    init data with global arrays.
    """
    from repro_torch.core.halo import local_moat_mask
    from repro_torch.core.mesh import BrickArray, Mesh, NamedSharding, psum
    from repro_torch.engine import compile_body
    from repro_torch.kernels import ops as kops

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.core.mesh.Mesh; got "
                        f"{type(mesh).__name__}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    if backend not in ("jit", "pallas"):
        raise ValueError(f"unknown solver backend {backend!r}")
    _check_precondition(method, precondition)
    name = _answer_name(program, answer)
    release_program(program)
    (op_loop, op_ops), rhs_group = _split(program, name)
    group = _lower_operator(op_ops, name)
    bounds = _resolve_bounds(method, lambda_bounds, group, name)
    _check_jacobi(method, group)

    mx, my = mesh.dims
    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    for n, (nx, ny, _) in shapes.items():
        if nx % mx or ny % my:
            raise ValueError(
                f"field {n} shape ({nx},{ny}) not divisible by mesh ({mx},{my})"
            )
    nx, ny, nz = shapes[name]
    bx, by = nx // mx, ny // my
    sharding = NamedSharding(mesh)
    member_env = member_env or {}

    def _bricks(x0) -> BrickArray:
        if isinstance(x0, BrickArray):
            return x0.map(torch.clone)
        return sharding.shard(x0)

    if method == "mg":
        single = make_solver(program, name, method="mg", backend=backend,
                             tol=tol, maxiter=maxiter, steps=steps,
                             mg_opts=mg_opts, member_env=member_env,
                             device=mesh.home)

        def mg_step(x0):
            if isinstance(x0, BrickArray):
                x0 = x0.gather()
            x, aux = single(x0)
            return sharding.shard(x), aux

        return mg_step, sharding

    field = program.fields[name]
    mg = _build_mg(method, precondition, group, name, field.shape, field.dtype,
                   backend, mg_opts, mesh.home)

    def _brick_step(ops, loop):
        step, _ = compile_body(ops, loop, shapes, dtypes, backend, mesh=mesh)

        def run(env):
            out = step({n: list(v.bricks) for n, v in env.items()})
            return {n: BrickArray(v, sharding) for n, v in out.items()}

        return run

    op_step = _brick_step(op_ops, op_loop)
    rhs_step = (_brick_step(rhs_group[1], rhs_group[0])
                if rhs_group is not None else None)
    coef_names = [n for n in program.fields if n != name]
    coefs = [sharding.shard(np.asarray(member_env.get(
        n, program.fields[n].init_data))) for n in coef_names]
    mask = None
    if method == "jacobi":
        zwin = torch.from_numpy(_z_window(group, nz))
        mask = BrickArray([local_moat_mask(bx, by, mesh.coords(b), mx, my, dev)
                           & zwin.to(dev)
                           for b, dev in enumerate(mesh.devices)], sharding)

    def dot(a, b):
        # BrickArray.__torch_function__: a local sum per brick, one psum
        return torch.sum(a * b, dtype=torch.promote_types(a.dtype,
                                                          torch.float32))

    def dot2(a, b, c, d):
        acc = torch.promote_types(a.dtype, torch.float32)
        if backend == "pallas":
            parts = [kops.dual_dot(*v) for v in zip(a.bricks, b.bricks,
                                                     c.bricks, d.bricks)]
        else:
            parts = [torch.stack([torch.sum(p * q, dtype=acc),
                                  torch.sum(r * t, dtype=acc)])
                     for p, q, r, t in zip(a.bricks, b.bricks, c.bricks,
                                           d.bricks)]
        part = psum(parts, mesh)  # ONE reduction of the pairs
        return part[0], part[1]

    M = None
    if mg is not None and precondition == "mg":
        M = lambda r: sharding.shard(mg.apply(r.gather()))  # noqa: E731

    run = _make_runner(
        method=method,
        name=name,
        coef_names=coef_names,
        op_step=op_step,
        rhs_step=rhs_step,
        dot=dot,
        dot2=dot2,
        tol=tol,
        maxiter=maxiter,
        steps=steps,
        bounds=bounds,
        group=group,
        jacobi_mask=mask,
        mg=None,
        M=M,
    )

    def step_fn(x0):
        return run(_bricks(x0), *coefs)

    return step_fn, sharding


# ---------------------------------------------------------------------------
# recovery ladder (bounded, logged escalation on failed solves)
# ---------------------------------------------------------------------------


def _cast_program(program: Program, dtype) -> Program:
    """Shallow dtype-cast view of a recorded program (fp64 safe mode).

    Ops reference fields by name, so sharing the op list with replica
    ``Field`` objects (same names/shapes, cast dtype + init data) is enough
    to rebuild every solver at the new precision.
    """
    import copy

    clone = Program.__new__(Program)
    clone.fields = {}
    clone.ops = program.ops
    clone._loop_stack = []
    for n, f in program.fields.items():
        f2 = copy.copy(f)
        f2.init_data = np.asarray(f.init_data, dtype)
        f2.dtype = f2.init_data.dtype
        clone.fields[n] = f2
    return clone


def _fetch4(step_fn, x0, mesh=None):
    """Run one solver attempt and land its 4 outputs on the host (the
    solution gathered from the bricks on a mesh)."""
    x, (iters, res, outs) = step_fn(x0)
    x = x.gather("cpu") if mesh is not None else x
    return (x.detach().cpu().numpy(), np.asarray(iters), np.asarray(res),
            np.asarray(outs))


def _record_attempt(trace, method, dtype, outs, iters, res, reason):
    trace.record(
        method,
        np.dtype(dtype).name,
        health.outcome_name(health.worst(outs)),
        int(np.sum(iters)),
        float(np.asarray(res).ravel()[-1]),
        reason,
    )


def _recover_solve(program, name, first, x0, policy, kwargs):
    """Drive the escalation ladder after a failed first attempt.

    Rungs (each at most once, every attempt logged): same-method restart
    from the current iterate on BREAKDOWN (a fresh BiCGSTAB shadow residual
    is the textbook cure), cg/pipecg → bicgstab escalation, one fp64
    safe-mode re-solve.  Every rung runs on the first attempt's device
    (``kwargs["device"]``).  Torch has no global x64 switch: the fp64 rung
    casts the program and ``member_env`` to float64 and builds a new
    solver, whose dots then accumulate in float64 (K2 included).  Returns
    ``((x, iters, res, outs), trace)`` on success; raises
    :class:`~repro_torch.solver.health.NumericalFault` carrying the
    populated trace when the ladder is exhausted.
    """
    from repro_torch.engine.stats import stats as engine_stats

    method = kwargs["method"]
    member_env = kwargs["member_env"]
    dtype = program.fields[name].dtype
    trace = health.RecoveryTrace()
    x, iters, res, outs = first
    _record_attempt(trace, method, dtype, outs, iters, res, "initial")

    def failed(o):
        return health.any_failure(o, on_maxiter=policy.on_maxiter)

    def _attempt(kw, prog, start, reason, cast=None):
        nonlocal x, iters, res, outs
        engine_stats.recovery_attempts += 1
        solver = make_solver(prog, name, **kw)
        x, iters, res, outs = _fetch4(solver, start)
        if cast is not None:
            x = x.astype(cast)
        _record_attempt(
            trace, kw["method"], prog.fields[name].dtype, outs, iters, res, reason
        )
        log.warning("solve recovery: %s", trace.summary()[-1])
        return not failed(outs)

    # rung 1: restart from the current iterate (BREAKDOWN only)
    restarts = 0
    while (
        failed(outs)
        and health.worst(outs) == health.BREAKDOWN
        and restarts < policy.max_restarts
    ):
        restarts += 1
        if _attempt(kwargs, program, x, f"restart {restarts} after BREAKDOWN"):
            return (x, iters, res, outs), trace

    # rung 2: method escalation (symmetric methods → bicgstab)
    if failed(outs) and policy.escalate and method in ("cg", "pipecg"):
        why = health.outcome_name(health.worst(outs))
        kw2 = dict(kwargs, method="bicgstab", precondition=None)
        if _attempt(kw2, program, x0, f"escalate {method}->bicgstab after {why}"):
            return (x, iters, res, outs), trace

    # rung 3: one fp64 safe-mode re-solve of the original system
    if failed(outs) and policy.safe_mode_fp64 and dtype != np.float64:
        why = health.outcome_name(health.worst(outs))
        p64 = _cast_program(program, np.float64)
        kw64 = dict(kwargs, member_env={
            k: np.asarray(v, np.float64) for k, v in member_env.items()})
        if _attempt(kw64, p64, np.asarray(x0, np.float64),
                    f"fp64 safe mode after {why}", cast=dtype):
            return (x, iters, res, outs), trace

    engine_stats.numerical_faults += 1
    worst_name = health.outcome_name(health.worst(outs))
    # the taxonomy lands on stats even when the ladder is exhausted — a
    # fault must leave the same forensic trail a success does
    engine_stats.solve_outcomes = tuple(
        str(v) for v in np.unique(health.outcome_names(outs))
    )
    raise health.NumericalFault(
        f"solve({method}) failed with {worst_name} after "
        f"{len(trace.attempts)} attempt(s): {'; '.join(trace.summary())}",
        outcome=worst_name,
        trace=trace,
    )


# ---------------------------------------------------------------------------
# one-shot entry point (WFAInterface.solve lands here)
# ---------------------------------------------------------------------------


def solve(
    program: Program,
    answer,
    *,
    method: str = "cg",
    backend: Optional[str] = None,
    mesh=None,
    steps: int = 1,
    tol: float = 1e-6,
    maxiter: int = 500,
    lambda_bounds: Optional[Tuple[float, float]] = None,
    precondition: Optional[str] = None,
    mg_opts=None,
    return_info: bool = False,
    options=None,
    member_env=None,
):
    """Solve the recorded implicit system for ``answer``; returns the
    solution as a NumPy array (and a :class:`SolveInfo` when
    ``return_info=True``).

    Execution policy travels as ``options=RunOptions(...)`` — the legacy
    ``backend=`` / ``mesh=`` keywords are deprecation shims that warn once
    and forward (backend defaults to ``"pallas"``).  ``options.device``
    names the torch device (``"cuda"`` by default, which raises without a
    card; ``"cpu"`` runs on the host, every kernel as its plain version).
    ``options.batch=B`` solves a B-member ensemble in one masked Krylov
    loop: ``member_env`` supplies per-member ``(B, X, Y, Z)`` stacks for the
    initial guess and/or coefficient fields (the rest broadcast), the
    solution is the ``(B, X, Y, Z)`` stack, and the per-member iteration
    counts land in :class:`SolveInfo` (shape ``(steps, B)``) and in
    ``repro_torch.engine.stats.member_iterations``.  ``options.mesh`` (or
    the legacy ``mesh=``) solves on the bricks of a
    :class:`~repro_torch.core.mesh.Mesh` (:func:`make_sharded_solver`);
    a mesh with ``batch > 1`` or ``differentiable=True`` raises
    ``ValueError``.

    ``options.recovery=RecoveryPolicy(…)`` drives the escalation ladder
    (:func:`_recover_solve`) when a single-device, unbatched solve ends in
    a failure word; ``info.recovery`` then holds its trace.  Sharded,
    batched and differentiable solves get no ladder and raise
    :class:`~repro_torch.solver.health.NumericalFault` with a one-attempt
    trace.  ``options.differentiable=True`` routes through the
    implicit-function-theorem adjoint (:mod:`repro_torch.solver.adjoint`):
    the eager result is numerically the same, and the underlying solver
    (``make_solver(..., differentiable=True)``) is reverse-mode
    differentiable.

    The initial guess is the unknown field's init data (its Moat must carry
    the boundary values, as in the explicit path).  ``tol`` bounds the
    absolute residual ``‖r‖`` for the Krylov methods and is relative,
    ``‖r‖ ≤ tol·‖b‖``, for ``method="mg"`` (whose stop reads the true
    residual of every cycle).  ``method="mg"`` iterates geometric multigrid
    V/W-cycles; ``precondition="mg"`` accelerates CG/BiCGSTAB with one
    cycle per iteration.

    Example — the paper's BTCS heat system, multigrid-preconditioned, on
    the host::

        >>> import numpy as np
        >>> from repro_torch.engine import RunOptions
        >>> from repro_torch.solver import record_btcs
        >>> T0 = np.full((17, 17, 9), 500.0, np.float32)
        >>> T0[1:-1, 1:-1, 0] = 300.0
        >>> wse, T = record_btcs(T0, 0.1)
        >>> x, info = wse.solve(T, method="cg", precondition="mg", tol=1e-6,
        ...                     options=RunOptions(backend="jit", device="cpu"),
        ...                     return_info=True)
        >>> x.shape, bool(info.iterations[0] < 10), str(info.outcomes[0])
        ((17, 17, 9), True, 'CONVERGED')
    """
    from repro_torch.engine.options import UNSET, resolve_options
    from repro_torch.engine.stats import stats as engine_stats

    options = resolve_options(
        options,
        "wfa.solve",
        backend=UNSET if backend is None else backend,
        mesh=UNSET if mesh is None else mesh,
    )
    backend = options.resolved_backend("pallas")
    batch = options.batch
    mesh = options.mesh
    if mesh is not None and batch > 1:
        raise ValueError(
            "batched solves are single-device; drop mesh= or set batch=1"
        )
    if options.differentiable and mesh is not None:
        raise ValueError(
            "differentiable solves are single-device; drop mesh= (shard the "
            "forward solve only, or take gradients with mesh=None)"
        )
    name = _answer_name(program, answer)
    member_env = member_env or {}
    kwargs = dict(
        method=method,
        backend=backend,
        tol=tol,
        maxiter=maxiter,
        steps=steps,
        lambda_bounds=lambda_bounds,
        precondition=precondition,
        mg_opts=mg_opts,
        member_env=member_env,
    )
    if mesh is not None:
        from repro_torch.engine.plan import _mesh_device

        _mesh_device(mesh, options.device)
        step_fn, _ = make_sharded_solver(program, name, mesh, **kwargs)
    else:
        kwargs["device"] = options.device
        step_fn = make_solver(program, name, batch=batch,
                              differentiable=options.differentiable, **kwargs)
    x0 = np.asarray(member_env.get(name, program.fields[name].init_data))
    if batch > 1 and x0.ndim == 3:
        x0 = np.broadcast_to(x0, (batch,) + x0.shape).copy()
    x, iters, res, outs = _fetch4(step_fn, x0, mesh)
    trace = None
    recovery = options.recovery
    if recovery is not None and health.any_failure(
        outs, on_maxiter=recovery.on_maxiter
    ):
        if mesh is not None or batch > 1 or options.differentiable:
            # no escalation ladder off the plain path — still fail loud
            engine_stats.numerical_faults += 1
            trace = health.RecoveryTrace()
            _record_attempt(
                trace, method, program.fields[name].dtype, outs, iters, res,
                "initial",
            )
            worst_name = health.outcome_name(health.worst(outs))
            engine_stats.solve_outcomes = tuple(
                str(v) for v in np.unique(health.outcome_names(outs))
            )
            raise health.NumericalFault(
                f"solve({method}) failed with {worst_name} (no recovery "
                "ladder for sharded/batched/differentiable solves)",
                outcome=worst_name,
                trace=trace,
            )
        (x, iters, res, outs), trace = _recover_solve(
            program, name, (x, iters, res, outs), x0, recovery, kwargs
        )
    engine_stats.solve_outcomes = tuple(
        str(v) for v in np.unique(health.outcome_names(outs))
    )
    if batch > 1:
        engine_stats.ensemble_runs += 1
        engine_stats.ensemble_members += batch
        engine_stats.member_iterations = tuple(int(v) for v in iters.sum(axis=0))
    if return_info:
        info = SolveInfo(
            method=method,
            backend=backend,
            iterations=iters,
            residual=res,
            outcomes=health.outcome_names(outs),
            recovery=trace,
        )
        return x, info
    return x
