"""IR + normalization pass: ``StencilExpr`` trees → canonical affine taps.

The WFA compiles the user's Python into bytecode whose fused RPCs are what
make the WSE fast; the analogous artifact here is a *canonical tap form* that
the codegen pass (:mod:`repro_torch.compiler.codegen`) turns into one fused
stencil kernel per loop body.  An update lowers to

    field[z0:z0+zlen] = const + Σ_k  c_k · Π_j  tap_{k,j}

where every :class:`Tap` is ``field[dz, dx, dy]`` relative to the target
slice.  Products of up to :data:`MAX_TAPS` taps are allowed — one tap acts as
a *variable coefficient* array — anything of higher degree, or division by a
field, is non-affine and raises :class:`LoweringError`, which the backend
turns into a logged interpreter fallback.

Normalization performed here: constant folding, like-term combination, and
distribution of products over sums, so e.g. the Fig. 3 heat update always
canonicalizes to the same seven taps regardless of how the Python spelled it.

This is the single-device subset of the reference IR: the overlap region
split, the multigrid transfer ops and the adjoint tap transpose come with
their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.core import stencil as st

#: Maximum number of field taps multiplied together in one product term.
#: 1 = plain affine; 2 = variable-coefficient (one tap is the coefficient
#: array).  Anything above is non-affine → interpreter fallback.
MAX_TAPS = 2


class LoweringError(Exception):
    """The expression cannot be lowered to the canonical affine form."""


@dataclasses.dataclass(frozen=True, order=True)
class Tap:
    """One field read ``field[z+dz, x+dx, y+dy]`` relative to the target."""

    field: str
    dz: int
    dx: int
    dy: int


@dataclasses.dataclass(frozen=True)
class AffineUpdate:
    """One lowered ``UpdateOp`` in canonical tap form."""

    field: str               # written field
    z0: int                  # normalized target z start
    zlen: int                # target z length
    const: float             # folded constant addend
    #: ((coeff, (tap, ...)), ...) — taps sorted, like terms combined
    terms: Tuple[Tuple[float, Tuple[Tap, ...]], ...]

    def taps(self) -> Iterable[Tap]:
        for _, taps in self.terms:
            yield from taps


@dataclasses.dataclass(frozen=True)
class LoweredGroup:
    """All ops of one ``ForLoop`` body (or one unlooped op run)."""

    updates: Tuple[AffineUpdate, ...]
    halo: int                # max |dx|, |dy| over all taps

    def fields_read(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for u in self.updates:
            for t in u.taps():
                if t.field not in seen:
                    seen.append(t.field)
        return tuple(seen)

    def fields_written(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for u in self.updates:
            if u.field not in seen:
                seen.append(u.field)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class TiledGroup:
    """Temporal composition of a loop body: ``k`` sub-steps per kernel launch.

    One padded window of halo depth ``k·h`` feeds ``k`` in-kernel
    applications of the body's tap form, the valid region shrinking by ``h``
    per sub-step (trapezoid blocking).  Moat masking is applied *per
    sub-step* from global coordinates, so composition stays exact at the
    Dirichlet boundary.  One wrap pad per tile instead of one per step.
    """

    base: LoweredGroup
    k: int

    @property
    def halo(self) -> int:
        """Padding depth of the tiled window (``k·h``)."""
        return self.k * self.base.halo

    @property
    def updates(self) -> Tuple[AffineUpdate, ...]:
        return self.base.updates


def tile_group(group: LoweredGroup, k: int,
               brick_xy: Tuple[int, int] = None,
               n_steps: int = None) -> TiledGroup:
    """Validate and build the ``k``-step composition of ``group``.

    Bounds: the tiled halo ``k·h`` must fit inside the brick and ``k``
    cannot exceed the loop trip count.  Violations raise
    :class:`LoweringError`; the planner falls back to ``k = 1`` with a
    logged reason.
    """
    if not isinstance(k, int) or k < 1:
        raise LoweringError(f"time tile factor must be a positive int, got {k!r}")
    if n_steps is not None and k > n_steps:
        raise LoweringError(
            f"time tile k={k} exceeds the loop trip count {n_steps}")
    if brick_xy is not None and group.halo > 0:
        if k * group.halo > min(brick_xy):
            raise LoweringError(
                f"time tile k={k} needs halo depth {k * group.halo} > brick "
                f"extent {min(brick_xy)}; neighbour exchange only reaches one "
                "brick")
    return TiledGroup(base=group, k=k)


def auto_tile(group: LoweredGroup, brick_xy: Tuple[int, int],
              n_steps: int, max_k: int = 8) -> int:
    """Pick a time-tile factor by the static rule.

    The largest power of two ``k ≤ max_k`` that divides the trip count
    (auto-tiled runs never need a remainder kernel) and whose tiled halo
    stays small next to the brick (``4·k·h ≤ min(bx, by)``).  Halo-free
    bodies tile purely for launch amortization.  The measured cost model of
    the reference comes with the overlap slice.
    """
    cand = max_k
    while cand >= 2:
        if (cand <= n_steps and n_steps % cand == 0
                and (group.halo == 0
                     or 4 * cand * group.halo <= min(brick_xy))):
            return cand
        cand //= 2
    return 1


# ---------------------------------------------------------------------------
# expression → polynomial-in-taps
# ---------------------------------------------------------------------------

_Poly = Dict[Tuple[Tap, ...], float]   # () key holds the constant addend


def _poly_add(a: _Poly, b: _Poly, sign: float = 1.0) -> _Poly:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + sign * v
    return out


def _poly_mul(a: _Poly, b: _Poly) -> _Poly:
    out: _Poly = {}
    for ka, va in a.items():
        for kb, vb in b.items():
            k = tuple(sorted(ka + kb))
            if len(k) > MAX_TAPS:
                raise LoweringError(
                    f"product of {len(k)} field taps is non-affine "
                    f"(degree > {MAX_TAPS}): {k}")
            out[k] = out.get(k, 0.0) + va * vb
    return out


def _to_poly(e: st.StencilExpr, target_z: slice) -> _Poly:
    if isinstance(e, st.Const):
        return {(): e.value}
    if isinstance(e, st.Term):
        dz = st.zslice_delta(e.zslice_obj(), target_z)
        return {(Tap(e.field_name, dz, e.dx, e.dy),): 1.0}
    if isinstance(e, st.BinOp):
        lhs = _to_poly(e.lhs, target_z)
        rhs = _to_poly(e.rhs, target_z)
        if e.op == "add":
            return _poly_add(lhs, rhs)
        if e.op == "sub":
            return _poly_add(lhs, rhs, sign=-1.0)
        if e.op == "mul":
            return _poly_mul(lhs, rhs)
        if e.op == "div":
            if set(rhs) - {()}:
                raise LoweringError("division by a field expression is "
                                    "non-affine")
            d = rhs.get((), 0.0)
            if d == 0.0:
                raise LoweringError("division by constant zero")
            return {k: v / d for k, v in lhs.items()}
        raise LoweringError(f"unknown binop {e.op!r}")
    raise LoweringError(f"cannot lower expression node {type(e).__name__}")


def lower_update(op) -> AffineUpdate:
    """Lower one recorded ``UpdateOp`` (normalized slices) to tap form."""
    target = op.target_z
    poly = _to_poly(op.expr, target)
    const = poly.pop((), 0.0)
    terms = tuple(sorted(
        (coeff, taps) for taps, coeff in poly.items() if coeff != 0.0))
    z0, z1 = target.start, target.stop
    if z0 is None or z0 < 0:
        raise LoweringError("target z slice is not normalized")
    return AffineUpdate(field=op.field_name, z0=z0, zlen=z1 - z0,
                        const=const, terms=terms)


def lower_group(ops: Sequence) -> LoweredGroup:
    """Lower a loop body's ops; reject cross-tile reads of updated fields.

    Within one fused kernel a block only sees its *own* updated values, so an
    op that reads a field written by an *earlier* op of the same loop body
    through a nonzero (dx, dy) offset cannot be fused — neighbouring blocks'
    updates are not visible until the next kernel launch.  (dz offsets are
    fine: the Z column is block-local, the paper's 1×1×Z decomposition.)
    """
    updates = []
    written: List[str] = []
    for op in ops:
        u = lower_update(op)
        for t in u.taps():
            if t.field in written and (t.dx or t.dy):
                raise LoweringError(
                    f"op writing {u.field!r} reads {t.field!r} at offset "
                    f"(dx={t.dx}, dy={t.dy}) after it was updated earlier in "
                    "the same loop body; cross-tile read-after-write cannot "
                    "be fused")
        updates.append(u)
        if u.field not in written:
            written.append(u.field)
    halo = 0
    for u in updates:
        for t in u.taps():
            halo = max(halo, abs(t.dx), abs(t.dy))
    return LoweredGroup(updates=tuple(updates), halo=halo)
