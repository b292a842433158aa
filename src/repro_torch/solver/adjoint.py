"""Adjoint solves: reverse-mode AD through ``wfa.solve``.

The port of ``repro/solver/adjoint.py``.  The implicit-function theorem
gives the VJP of a linear solve without differentiating through the
Krylov iteration (whose iterates are noise as far as the converged
solution is concerned): for ``x = A⁻¹ b``,

    b̄ = A⁻ᵀ x̄          (one *adjoint solve* with the transposed operator)
    θ̄ = −⟨λ, (∂A/∂θ) x⟩  with λ = A⁻ᵀ x̄   (coefficient-field gradients)

so the backward pass is one more Krylov solve with the **same compiled
machinery** as the forward, inside a ``torch.autograd.Function``
(:class:`_SolveCore`):

* symmetric operators (CG / PipeCG / mg-pcg) — the transposed tap set
  re-canonicalizes to a ``LoweredGroup`` *equal* to the forward one
  (:func:`repro_torch.compiler.ir.transpose_taps`), so the adjoint
  application hits the forward's kernel-cache entry (the same K1 build);
  no kernel is built for the backward;
* non-symmetric operators (BiCGSTAB, e.g. variable-coefficient row-scaled
  stencils) — the transposed group lowers through the same IR → codegen
  path into one more K1 instantiation.

Moat / boundary handling.  The compiled operator is the *masked* map
``A = M·S + (I − M)`` — stencil rows on the written region ``M``
(X/Y-interior × z-window), identity rows elsewhere — so its true transpose
is ``Aᵀ = Sᵀ·M + (I − M)``, which couples boundary *columns* to interior
rows.  The adjoint solve splits this exactly: the interior part
``λᵢ = M·λ`` solves the maskable system ``Ã λᵢ = M x̄`` with
``Ã = M·S̃ + (I − M)`` (``S̃`` = the transposed tap set — a plain
``wfa``-shaped operator the Krylov drivers run unmodified, whose iterates
stay interior-supported), and the identity rows get the closed-form
correction ``λ_Moat = x̄_Moat − (S̃ λᵢ)_Moat`` applied outside the loop by
a plain full-domain roll application.  That makes the VJP exact for
cotangents and perturbations with *boundary* support too — gradients with
respect to Dirichlet boundary values flow correctly.

The ``Rhs()`` body runs forward as the same compiled step as
:func:`repro_torch.solver.api.make_solver`'s (K1 on ``backend="pallas"``),
its reverse pass the roll interpreter's VJP, so a differentiable solve
gives the bits of the plain one.  Dots are :func:`make_solver`'s: the
field dtype (promoted to at least float32), the fused pair K2 on the
card.

Bodies that do not lower to the canonical affine form (interpreter
fallbacks) raise a clear ``ValueError`` here instead of producing a
silently wrong gradient.

    >>> import torch
    >>> from repro_torch.solver import make_differentiable_solver
    >>> from repro_torch.solver.presets import btcs_program
    >>> solve = make_differentiable_solver(btcs_program((8, 8, 5), 0.2), "T",
    ...                                    device="cpu")
    >>> solve.symmetric_adjoint
    True
    >>> x0 = torch.ones((8, 8, 5), requires_grad=True)
    >>> torch.autograd.grad((solve(x0) ** 2).sum(), x0)[0].shape
    torch.Size([8, 8, 5])
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.compiler import LoweringError, transpose_taps
from repro_torch.compiler.codegen import compile_group
from repro_torch.core.program import Program, _interp_step, release_program
from repro_torch.solver.api import (
    _answer_name,
    _build_mg,
    _check_precondition,
    _dots,
    _lower_operator,
    _method_runner,
    _split,
    _written_mask,
)

#: methods with an implicit-function-theorem adjoint: the symmetric Krylov
#: drivers (+ multigrid) reuse the forward kernel; bicgstab compiles the
#: transposed tap set.  chebyshev/jacobi are excluded — their fixed
#: iteration counts make "converged solution" (the IFT premise) a fiction.
ADJOINT_METHODS = ("cg", "pipecg", "bicgstab", "mg")


def _read(v, dz: int, dx: int, dy: int):
    """Value of ``v`` at cell ``(x+dx, y+dy, z+dz)``: periodic in X/Y (the
    roll semantics every backend implements), zero-extended in Z (the
    transpose of the in-bounds z-slice reads — correct wherever the
    interior-supported adjoint factor multiplies it)."""
    a = v
    if dx:
        a = torch.roll(a, -dx, dims=0)
    if dy:
        a = torch.roll(a, -dy, dims=1)
    if dz:
        nz = a.shape[2]
        src0, src1 = max(dz, 0), nz + min(dz, 0)
        out = torch.zeros_like(a)
        out[:, :, src0 - dz:src1 - dz] = a[:, :, src0:src1]
        a = out
    return a


def _apply_update_full(update, env):
    """Unmasked full-domain roll application of one lowered update.

    Used once per backward solve for the Moat-row correction
    ``(S̃ λᵢ)_Moat`` — a handful of rolls, negligible next to the Krylov
    loop."""
    out = None
    for coeff, taps in update.terms:
        term = None
        for t in taps:
            r = _read(env[t.field], t.dz, t.dx, t.dy)
            term = r if term is None else term * r
        term = coeff * term
        out = term if out is None else out + term
    return out


def _masked_group_step(group, name):
    """Interpreter application of a :class:`LoweredGroup`: written rows get
    the tap polynomial, every other row passes through (identity Moat).
    The ``backend="jit"`` adjoint-operator step — the transposed analogue
    of :func:`repro_torch.core.program._interp_step`."""

    def step(env):
        env = dict(env)
        v = env[name]
        nx, ny, _ = v.shape
        interior = torch.zeros((nx, ny, 1), dtype=torch.bool, device=v.device)
        interior[1:-1, 1:-1, :] = True
        for u in group.updates:
            val = _apply_update_full(u, env)
            v = v.clone()
            win = slice(u.z0, u.z0 + u.zlen)
            v[:, :, win] = torch.where(interior, val, v)[:, :, win]
            env[name] = v
        return env

    return step


def _validate_z(group, nz: int, what: str) -> None:
    for u in group.updates:
        for t in u.taps():
            if u.z0 + t.dz < 0 or u.z0 + u.zlen + t.dz > nz:
                raise ValueError(
                    f"{what}: tap {t} reads z "
                    f"[{u.z0 + t.dz}, {u.z0 + u.zlen + t.dz}) outside the "
                    f"field's {nz} planes — this operator's adjoint cannot "
                    "be expressed with the same z-window machinery"
                )


class _SolveCore(torch.autograd.Function):
    """``x = A(θ)⁻¹ b`` with the implicit-function-theorem VJP.

    ``forward(solver, aux, b, x0, *coefs)`` runs the forward Krylov solve
    (``aux`` receives its ``(iterations, ‖r‖, outcome)``); ``backward``
    runs one adjoint solve (:meth:`_Adjoint.backward`) and returns the
    gradients of ``b`` and of the coefficient fields; the warm start
    ``x0`` gets none (a converged solution does not depend on it)."""

    @staticmethod
    def forward(ctx, solver, aux, b, x0, *coefs):
        x, it, res, outcome = solver.forward(b, x0, coefs)
        aux.append((it, res, outcome))
        ctx.solver = solver
        ctx.save_for_backward(x, *coefs)
        return x

    @staticmethod
    def backward(ctx, ct):
        x, *coefs = ctx.saved_tensors
        b_bar, coef_bars = ctx.solver.backward(ct, x, coefs)
        return (None, None, b_bar, None, *coef_bars)


class _Adjoint:
    """The forward and adjoint solves of one differentiable system."""

    def __init__(self, name, coef_names, run_method, op_step, opT_step,
                 update, t_update, mask, dtypes):
        self.name, self.coef_names = name, coef_names
        self.run_method = run_method
        self.op_step, self.opT_step = op_step, opT_step
        self.update, self.t_update = update, t_update
        self.mask, self.dtypes = mask, dtypes

    def _apply(self, step, v, envc):
        env = dict(envc)
        env[self.name] = v
        return step(env)[self.name]

    def forward(self, b, x0, coefs):
        envc = dict(zip(self.coef_names, coefs))
        return self.run_method(lambda v: self._apply(self.op_step, v, envc),
                               b, x0, envc)

    def backward(self, ct, x, coefs):
        name, m = self.name, self.mask
        envc = dict(zip(self.coef_names, coefs))
        bt = torch.where(m, ct, torch.zeros_like(ct))
        lam, _, _, _ = self.run_method(
            lambda v: self._apply(self.opT_step, v, envc), bt, bt, envc)
        lam = torch.where(m, lam, torch.zeros_like(lam))  # interior support
        # identity (Moat) rows of A⁻ᵀ: λ_Moat = x̄_Moat − (S̃ λᵢ)_Moat
        full = _apply_update_full(self.t_update, {**envc, name: lam})
        b_bar = lam + torch.where(m, torch.zeros_like(ct), ct - full)
        coef_bars = []
        for n, c in zip(self.coef_names, coefs):
            g = None
            for coeff, taps in self.update.terms:
                ctap = [t for t in taps if t.field == n]
                if not ctap:
                    continue
                (tc,) = ctap
                (tx,) = [t for t in taps if t.field == name]
                piece = (coeff
                         * _read(lam, -tc.dz, -tc.dx, -tc.dy)
                         * _read(x, tx.dz - tc.dz, tx.dx - tc.dx,
                                 tx.dy - tc.dy))
                g = piece if g is None else g + piece
            coef_bars.append(torch.zeros_like(c) if g is None
                             else (-g).to(c.dtype))
        return b_bar, coef_bars


def make_differentiable_solver(
    program: Program,
    answer,
    *,
    method: str = "cg",
    backend: str = "pallas",
    tol: float = 1e-10,
    maxiter: int = 1000,
    steps: int = 1,
    precondition: Optional[str] = None,
    mg_opts=None,
    return_info: bool = False,
    device="cuda",
):
    """Build a reverse-differentiable solver for a recorded system.

    Returns ``solve_fn(x0, coef_env=None) -> x`` (or ``(x, (iters, res,
    outcomes))`` with ``return_info=True``, host arrays of shape
    ``(steps,)``): ``x0`` is the unknown's initial state (its Moat carries
    the boundary values; a tensor or an array, moved to ``device``) and
    ``coef_env`` maps coefficient field names to tensors overriding their
    init data — both may require grad, and ``torch.autograd`` through
    ``solve_fn`` is exact via the implicit-function-theorem VJP (see the
    module docstring).  Each of the ``steps`` implicit time steps runs the
    ``Rhs()`` body (forward on the compiled step, reverse through the
    roll interpreter's VJP) and one Krylov solve on the compiled operator
    kernel K1.  ``device`` is the card by default, which must exist.

    Raises ``ValueError`` for non-affine operator bodies (an interpreter
    fallback has no tap set to transpose — failing loudly beats a silently
    wrong gradient), for nonlinear operators, and for the fixed-iteration
    methods outside :data:`ADJOINT_METHODS`.
    """
    from repro_torch.engine import compile_body, resolve_device
    from repro_torch.engine.executor import _diff_launch

    if method not in ADJOINT_METHODS:
        raise ValueError(
            f"reverse-mode AD supports methods {ADJOINT_METHODS}; got "
            f"{method!r} (chebyshev/jacobi run a fixed iteration count, "
            "not a converged solve — the IFT adjoint does not apply)"
        )
    if backend not in ("jit", "pallas"):
        raise ValueError(f"unknown solver backend {backend!r}")
    _check_precondition(method, precondition)
    name = _answer_name(program, answer)
    release_program(program)
    (op_loop, op_ops), rhs_group = _split(program, name)
    group = _lower_operator(op_ops, name)
    if group is None:
        raise ValueError(
            "cannot differentiate through this solve: the operator body "
            "does not lower to the canonical affine tap form (it would run "
            "on the interpreter fallback), so there is no tap set to "
            "transpose for the adjoint system — rewrite the Operator() "
            "body as an affine stencil or drop differentiable=True"
        )
    if len(group.updates) != 1:
        raise ValueError(
            "differentiable solves support single-update Operator() bodies "
            f"(got {len(group.updates)} updates: sequentially composed "
            "updates transpose in reverse order with per-update masks, "
            "which this adjoint does not implement)"
        )
    try:
        tgroup = transpose_taps(group, name)
    except LoweringError as e:
        raise ValueError(f"cannot differentiate through this solve: {e}") from e
    device = resolve_device(device)
    field = program.fields[name]
    shape, dtype = field.shape, field.dtype
    _validate_z(group, shape[2], "operator")
    _validate_z(tgroup, shape[2], "adjoint operator")
    symmetric = tgroup == group

    mg = _build_mg(method, precondition, group, name, shape, dtype, backend,
                   mg_opts, device)
    if method == "mg" or (mg is not None and precondition == "mg"):
        # build_multigrid validated symmetry; the cycle/preconditioner is
        # therefore its own adjoint and is reused verbatim below
        assert symmetric, "multigrid passed an asymmetric operator through"

    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    if backend == "pallas":
        try:
            op_step = compile_group(op_ops, shapes, dtypes, device=device,
                                    group=group)
            opT_step = compile_group(op_ops, shapes, dtypes, device=device,
                                     group=tgroup)
        except LoweringError as e:
            raise ValueError(
                f"cannot differentiate through this solve: {e} (no silent "
                "interpreter fallback under grad)"
            ) from e
    else:
        op_step = _interp_step(op_ops)
        opT_step = _masked_group_step(tgroup, name)
    rhs_step = None
    if rhs_group is not None:
        rhs_fwd, _ = compile_body(rhs_group[1], rhs_group[0], shapes, dtypes,
                                  backend, device=device)
        rhs_step = _diff_launch(rhs_fwd, _interp_step(rhs_group[1]))

    dot, dot2 = _dots(backend)
    run_method = _method_runner(
        method=method, name=name, dot=dot, dot2=dot2, tol=tol,
        maxiter=maxiter, bounds=None, group=group, jacobi_mask=None, mg=mg,
        M=mg.apply if (mg is not None and precondition == "mg") else None)
    coef_names = [n for n in program.fields if n != name]
    mask = torch.tensor(_written_mask(group, shape), device=device)
    solver = _Adjoint(name, coef_names, run_method, op_step, opT_step,
                      group.updates[0], tgroup.updates[0], mask, dtypes)

    def run(x0, coefs):
        envc = dict(zip(coef_names, coefs))
        x = x0
        iters, res, outcomes = [], [], []
        for _ in range(steps):
            b = (rhs_step({**envc, name: x})[name] if rhs_step is not None
                 else x)
            aux = []
            x = _SolveCore.apply(solver, aux, b, x, *coefs)
            (i, r, o), = aux
            iters.append(i)
            res.append(r)
            outcomes.append(o)
        return x, (np.asarray(iters, np.int32),
                   torch.stack(res).detach().cpu().numpy(),
                   np.asarray(outcomes, np.int32))

    def _on_device(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.tensor(np.asarray(v), device=device)

    def solve_fn(x0, coef_env=None):
        coef_env = coef_env or {}
        coefs = [_on_device(coef_env.get(n, program.fields[n].init_data))
                 for n in coef_names]
        x, aux = run(_on_device(x0), coefs)
        return (x, aux) if return_info else x

    solve_fn.symmetric_adjoint = symmetric
    solve_fn.coef_names = tuple(coef_names)
    return solve_fn
