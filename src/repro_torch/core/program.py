"""Program capture — the analogue of the WFA's RPC bytecode.

The WFA compiles the user's Python into a bytecode sequence that a Control
Tile broadcasts as RPCs to Worker/Moat tiles.  This module records the
analogous artifact: fields and update ops captured into a :class:`Program`.
Execution is owned by the engine (:mod:`repro_torch.engine`) — ``make``
hands the recording to ``engine.plan`` / ``engine.execute``, which schedule
every ``ForLoop`` body onto one of the interchangeable backends:

* ``numpy``  — the WFA "validation capability" (runs the ops eagerly in NumPy)
* ``jit``    — the torch roll interpreter on the plan's device
* ``pallas`` — the program *compiler* (:mod:`repro_torch.compiler`): every
  ForLoop body lowers to one fused stencil kernel launch per step (or per
  ``time_tile`` steps), with an interpreter fallback for bodies that cannot
  be lowered.  The backend keeps the reference's name so one options value
  drives both packages; on a CUDA device it runs the hand-written Hopper
  kernel, on the CPU that kernel's plain PyTorch version.

This module keeps only the recording machinery plus the roll-based
interpreter step (:func:`_interp_step`) that the engine shares as the
semantic reference for every backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import stencil as st
from repro_torch.core.boundary import interior_mask

_STATE = threading.local()


def current_program() -> Optional["Program"]:
    return getattr(_STATE, "program", None)


def release_program(program: "Program") -> None:
    """Deactivate ``program`` if it is the thread-local active recording.

    Every consumer of a finished recording (``make``, ``solve``,
    ``WFAInterface.__exit__``) funnels through here; the program object
    itself stays usable.
    """
    if current_program() is program:
        _STATE.program = None


@contextlib.contextmanager
def scoped_program():
    """Activate a fresh :class:`Program`, restoring any active one on exit."""
    prev = current_program()
    p = Program()
    _STATE.program = p
    try:
        yield p
    finally:
        _STATE.program = prev


@dataclasses.dataclass
class UpdateOp:
    """One recorded field update: ``field[target_z, 0, 0] = expr``."""

    field_name: str
    target_z: slice
    expr: st.StencilExpr
    loop: Optional["ForLoop"]


class ForLoop:
    """``with ForLoop('time_loop', n):`` — the WFA's ``WSE_For_Loop``."""

    def __init__(self, name: str, n: int):
        self.name = name
        self.n = int(n)

    def __enter__(self):
        p = current_program()
        if p is None:
            raise RuntimeError("ForLoop must be used inside a WFAInterface")
        p._loop_stack.append(self)
        return self

    def __exit__(self, *exc):
        current_program()._loop_stack.pop()
        return False


class Program:
    def __init__(self):
        self.fields: Dict[str, "Field"] = {}
        self.ops: List[UpdateOp] = []
        self._loop_stack: List[ForLoop] = []

    def register_field(self, field) -> None:
        if field.name in self.fields:
            raise ValueError(f"duplicate field name {field.name!r}")
        self.fields[field.name] = field

    def record_update(self, field, target_z: slice, expr: st.StencilExpr):
        # Normalize every z slice (target and terms) to concrete non-negative
        # (start, stop) via slice.indices, so negative-start spellings like
        # T[-9:-1, 0, 0] validate and evaluate identically to their
        # non-negative equivalents, and the compiler can compute z deltas by
        # plain subtraction of starts.
        n = field.shape[2]
        t0, t1, _ = target_z.indices(n)
        target_z = slice(t0, t1)
        nz_of = {name: f.shape[2] for name, f in self.fields.items()}
        for t in expr.terms():
            if t.field_name not in nz_of:
                raise ValueError(
                    f"term references field {t.field_name!r} that is not "
                    "registered in this program")
        expr = st.normalize_zslices(expr, nz_of)
        tlen = t1 - t0
        for t in expr.terms():
            zlen = t.zslice[1] - t.zslice[0]
            if zlen != tlen:
                raise ValueError(
                    f"term {t.field_name}[{t.zslice}] length {zlen} != "
                    f"target length {tlen}"
                )
        loop = self._loop_stack[-1] if self._loop_stack else None
        self.ops.append(UpdateOp(field.name, target_z, expr, loop))


class WFAInterface:
    """The user-facing entry point (the WFA's ``WSE_Interface``).

    ``with WFAInterface() as wse:`` activates a program; Fields created and
    updated inside the context are recorded; ``wse.make(answer=...)``
    compiles and runs, returning the final value of ``answer``.  It can also
    be used without the context-manager form: instantiation activates the
    program and ``make`` deactivates it.
    """

    def __init__(self):
        if current_program() is not None:
            raise RuntimeError("another WFAInterface program is active")
        self.program = Program()
        _STATE.program = self.program

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        release_program(self.program)
        return False

    # -- execution ---------------------------------------------------------
    def make(self, answer, backend=None, mesh=None, time_tile=None,
             resident=None, *, options=None, env=None):
        """Compile and run the recorded program; returns ``answer``'s data
        as a host NumPy array (the WFA's ``make_WSE``).

        Policy travels as one frozen ``options=RunOptions(...)`` bundle (a
        bare string is accepted as the backend).  ``RunOptions.device``
        names the torch device the run uses — ``"cuda"`` by default, which
        raises when no card is present; pass ``device="cpu"`` to run on the
        host.  The legacy ``backend=`` / ``mesh=`` / ``time_tile=`` /
        ``resident=`` keywords warn once and forward into the bundle.

        Example — three steps of pure decay on the interior (the Moat ring
        and the unwritten z planes keep their boundary values):

        >>> import numpy as np
        >>> from repro_torch.core import Field, ForLoop, WFAInterface
        >>> from repro_torch.engine import RunOptions
        >>> wse = WFAInterface()
        >>> T = Field("T", init_data=np.ones((6, 6, 4), np.float32))
        >>> with ForLoop("time_loop", 3):
        ...     T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
        >>> out = wse.make(answer=T, options=RunOptions(backend="jit",
        ...                                             device="cpu"))
        >>> float(out[2, 2, 1]), float(out[0, 2, 1])
        (0.125, 1.0)
        """
        from repro_torch.engine.options import UNSET, resolve_options

        try:
            options = resolve_options(
                options, "make",
                backend=UNSET if backend is None else backend,
                mesh=UNSET if mesh is None else mesh,
                time_tile=UNSET if time_tile is None else time_tile,
                resident=UNSET if resident is None else resident,
            )
            if any(getattr(op.loop, "role", None) is not None
                   for op in self.program.ops):
                # the program object stays usable for wse.solve(...)
                raise ValueError(
                    "this program records an implicit system "
                    "(Operator()/Rhs() groups); run wse.solve(answer, ...) "
                    "instead of make")
            from repro_torch.engine import run_program
            out = run_program(self.program, env=env, options=options)
        finally:
            release_program(self.program)
        return np.asarray(out[answer.name])

    def solve(self, answer, method: str = "cg", backend=None, mesh=None,
              **kwargs):
        """Solve the recorded implicit system ``A(x) = b`` for ``answer``.

        The operator body (recorded inside ``with Operator():``) compiles
        through the same IR → fused-kernel pipeline as explicit programs;
        matrix-free iterations run on top of the compiled application —
        Krylov methods, or geometric multigrid via ``method="mg"`` /
        ``precondition="mg"``.  Policy travels as ``options=RunOptions(...)``
        (backend defaults to ``"pallas"``, device to ``"cuda"``).  See
        :func:`repro_torch.solver.solve` for the full keyword surface
        (``steps``, ``tol``, ``maxiter``, ``lambda_bounds``,
        ``precondition``, ``mg_opts``, ``return_info``, ``member_env``).
        """
        from repro_torch.solver.api import solve as _solve
        try:
            return _solve(self.program, answer, method=method,
                          backend=backend, mesh=mesh, **kwargs)
        finally:
            release_program(self.program)

    # paper-compatible alias
    make_WSE = make


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

def _group_ops(program: Program):
    """Group consecutive ops that share a loop: [(loop_or_None, [ops])]."""
    groups = []
    for op in program.ops:
        if groups and groups[-1][0] is op.loop:
            groups[-1][1].append(op)
        else:
            groups.append((op.loop, [op]))
    return groups


def _apply_op(op: UpdateOp, env, xp, roll):
    """Apply one update to ``env`` (NumPy arrays or torch tensors, (X, Y, Z)
    or a (B, X, Y, Z) member stack); returns the field's new value, a fresh
    array (the input is left untouched)."""
    val = st.evaluate(op.expr, env, op.target_z, xp, roll)
    field = env[op.field_name]
    nx, ny, _ = field.shape[-3:]
    # (X, Y, 1): Moat cells stay fixed; it broadcasts over the members
    if xp is np:
        mask = interior_mask((nx, ny), np)
        new = field.copy()
        new[..., op.target_z] = np.where(mask, val, field[..., op.target_z])
        return new
    mask = interior_mask((nx, ny), torch, field.device)
    # index assignment on a clone: the functional update the reference
    # spells with dynamic_update_slice
    new = field.clone()
    new[..., op.target_z] = torch.where(mask, val, field[..., op.target_z])
    return new


def _interp_step(ops):
    """Interpreter step for one op group: one roll per stencil term.

    Shared by the ``jit`` backend and the ``pallas`` backend's fallback path
    (both via :func:`repro_torch.engine.compile_body`) so their semantics
    cannot diverge — this is the semantic reference every backend is tested
    against.
    """
    roll = lambda a, s, ax: torch.roll(a, s, dims=ax)  # noqa: E731

    def f(e):
        e = dict(e)
        for op in ops:
            e[op.field_name] = _apply_op(op, e, torch, roll)
        return e
    return f
