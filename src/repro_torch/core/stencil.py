"""Stencil expression tracing — the WFA's NumPy-like frontend, in PyTorch.

The paper's ``WSE_Array`` indexing convention (Fig. 3):

    T[zslice, dx, dy]

* axis 0 is a *local* slice along the Z column owned by a tile,
* axes 1..2 are **relative tile offsets** in X / Y: -1 (W/S), 0 (C), +1 (E/N).

Indexing a :class:`~repro_torch.core.field.Field` builds a lazy
:class:`StencilExpr` tree; assigning an expression to a field slice records an
update in the active :class:`~repro_torch.core.program.Program`.  Expressions
are evaluated either with NumPy (the WFA's validation mode) or with torch
tensors on the plan's device (the ``jit`` roll interpreter).

Arrays are stored globally as ``(X, Y, Z)``; a term's value at cell
``(x, y, z)`` is ``field[x + dx, y + dy, z + dz]``.  Shifts are implemented
with ``roll`` — wrap-around only ever lands in domain-boundary cells, which
the boundary mask pins to their Dirichlet values, so roll is exact (see
core/boundary.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np

Scalar = Union[int, float]


def zslice_delta(zslice: slice, target: slice) -> int:
    """Relative Z offset of a term slice w.r.t. the update target slice.

    The WFA convention writes the target as ``T[1:-1, 0, 0]`` and neighbours
    as ``T[2:, 0, 0]`` (z+1) / ``T[:-2, 0, 0]`` (z-1).  Both slices must have
    equal length and be *normalized* — concrete, non-negative start/stop as
    produced by ``slice.indices`` in :meth:`Program.record_update`.
    """
    if (zslice.start is None or target.start is None
            or zslice.start < 0 or target.start < 0):
        raise ValueError("zslice_delta requires normalized slices "
                         "(record the update through a Program first)")
    return zslice.start - target.start


@dataclasses.dataclass(frozen=True)
class StencilExpr:
    """Base class for lazy stencil expression nodes."""

    def __add__(self, other):
        return BinOp("add", self, _lift(other))

    def __radd__(self, other):
        return BinOp("add", _lift(other), self)

    def __sub__(self, other):
        return BinOp("sub", self, _lift(other))

    def __rsub__(self, other):
        return BinOp("sub", _lift(other), self)

    def __mul__(self, other):
        return BinOp("mul", self, _lift(other))

    def __rmul__(self, other):
        return BinOp("mul", _lift(other), self)

    def __truediv__(self, other):
        return BinOp("div", self, _lift(other))

    def __neg__(self):
        return BinOp("mul", Const(-1.0), self)

    # -- analysis ---------------------------------------------------------
    def terms(self) -> Tuple["Term", ...]:
        out = []
        _collect_terms(self, out)
        return tuple(out)

    def max_offset(self) -> int:
        offs = [max(abs(t.dx), abs(t.dy)) for t in self.terms()]
        return max(offs) if offs else 0


@dataclasses.dataclass(frozen=True)
class Const(StencilExpr):
    value: float


@dataclasses.dataclass(frozen=True)
class Term(StencilExpr):
    """A field reference ``field[zslice, dx, dy]``."""

    field_name: str
    zslice: Tuple[Any, Any, Any]  # (start, stop, step) of the z slice
    dx: int
    dy: int

    def zslice_obj(self) -> slice:
        return slice(*self.zslice)


@dataclasses.dataclass(frozen=True)
class BinOp(StencilExpr):
    op: str
    lhs: StencilExpr
    rhs: StencilExpr


def _lift(v) -> StencilExpr:
    if isinstance(v, StencilExpr):
        return v
    if isinstance(v, (int, float, np.floating, np.integer)):
        return Const(float(v))
    raise TypeError(f"cannot use {type(v)} in a stencil expression")


def normalize_zslices(e: StencilExpr, nz_of: Dict[str, int]) -> StencilExpr:
    """Rewrite every :class:`Term` with a concrete ``(start, stop)`` z slice.

    ``nz_of`` maps field names to their Z extent.  Negative or open-ended
    slice spellings (``T[-9:-1]``, ``T[2:]``) are resolved via
    ``slice.indices`` so downstream passes can do plain integer arithmetic on
    starts.
    """
    if isinstance(e, Term):
        start, stop, _ = e.zslice_obj().indices(nz_of[e.field_name])
        return dataclasses.replace(e, zslice=(start, stop, None))
    if isinstance(e, BinOp):
        return dataclasses.replace(
            e,
            lhs=normalize_zslices(e.lhs, nz_of),
            rhs=normalize_zslices(e.rhs, nz_of),
        )
    return e


def _collect_terms(e: StencilExpr, out) -> None:
    if isinstance(e, Term):
        out.append(e)
    elif isinstance(e, BinOp):
        _collect_terms(e.lhs, out)
        _collect_terms(e.rhs, out)


_BINOPS: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}


def evaluate(
    expr: StencilExpr,
    env: Dict[str, Any],
    target_z: slice,
    xp,
    roll: Callable[[Any, int, int], Any],
) -> Any:
    """Evaluate ``expr`` over the target z-slice.

    ``env`` maps field names to (..., X, Y, Z) arrays: leading (member)
    axes pass through.  ``xp`` is the array module (numpy or torch);
    ``roll(a, shift, axis)`` shifts along X/Y (axes -3/-2).  The value of
    term ``(dx, dy)`` at cell x is ``a[x + dx]`` = ``roll(a, -dx)``.
    """
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, Term):
        a = env[expr.field_name]
        if expr.dx:
            a = roll(a, -expr.dx, -3)
        if expr.dy:
            a = roll(a, -expr.dy, -2)
        # shift in z is expressed through the slice itself; the slice is
        # validated (equal length to target) when the update is recorded.
        return a[..., expr.zslice_obj()]
    if isinstance(expr, BinOp):
        lhs = evaluate(expr.lhs, env, target_z, xp, roll)
        rhs = evaluate(expr.rhs, env, target_z, xp, roll)
        return _BINOPS[expr.op](lhs, rhs)
    raise TypeError(f"unknown expr node {type(expr)}")


def neighbor_sum(a, xp, roll):
    """Sum of the six Cartesian neighbours — the paper's ``N(C)`` operator.

    z neighbours are edge-replicated; x/y neighbours wrap, and the wrapped
    cells are masked by the caller's boundary mask.  ``xp`` is numpy or
    torch (both spell the join ``concatenate(..., axis=)``).
    """
    s = roll(a, 1, 0) + roll(a, -1, 0) + roll(a, 1, 1) + roll(a, -1, 1)
    zp = xp.concatenate([a[:, :, 1:], a[:, :, -1:]], axis=2)
    zm = xp.concatenate([a[:, :, :1], a[:, :, :-1]], axis=2)
    return s + zp + zm
