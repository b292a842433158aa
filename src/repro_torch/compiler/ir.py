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

This is the single-device subset of the reference IR plus its multigrid
part (level operators, re-discretization, transfer ops) and the
interior/boundary region split of the exchange/compute overlap
(:func:`split_regions`) and the adjoint's tap transpose
(:func:`transpose_taps`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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
              n_steps: int, max_k: int = 8, *, cost=None, nz: int = None
              ) -> int:
    """Pick a time-tile factor.

    Without a cost model this is the static rule: the largest power of two
    ``k ≤ max_k`` that divides the trip count (auto-tiled runs never need a
    remainder kernel) and whose tiled halo stays small next to the brick
    (``4·k·h ≤ min(bx, by)``).  Halo-free bodies tile purely for launch
    amortization.

    With ``cost=`` (a calibrated
    :class:`repro_torch.core.perfmodel.MeasuredCost` for this body's
    signature) and ``nz``, the choice is the argmin of the *measured* model
    over every legal power-of-two candidate — each scored as the better of
    its fused and overlap-split schedules
    (:func:`repro_torch.core.perfmodel.predict_step_us`).  ``k = 1`` is
    always a candidate, so a model-driven pick can never lose to untiled
    stepping by construction.
    """
    if cost is not None and nz is not None and n_steps > 1:
        from repro_torch.core.perfmodel import predict_step_us

        best_k, best_t = 1, predict_step_us(cost, brick_xy, nz,
                                            group.halo, 1)
        cand = 2
        while cand <= min(max_k, n_steps):
            legal = (n_steps % cand == 0
                     and (group.halo == 0
                          or cand * group.halo <= min(brick_xy)))
            if legal:
                t = predict_step_us(cost, brick_xy, nz, group.halo, cand)
                ts = predict_step_us(cost, brick_xy, nz, group.halo, cand,
                                     split=True)
                t = min(t, ts)
                if t < best_t:
                    best_k, best_t = cand, t
            cand *= 2
        return best_k
    cand = max_k
    while cand >= 2:
        if (cand <= n_steps and n_steps % cand == 0
                and (group.halo == 0
                     or 4 * cand * group.halo <= min(brick_xy))):
            return cand
        cand //= 2
    return 1


# ---------------------------------------------------------------------------
# interior/boundary region split (exchange/compute overlap)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One rectangular (X, Y) sub-region of a brick's output plane.

    ``(x0, y0)`` is the region origin in brick coordinates, ``(rx, ry)``
    its extent.  K1 windows a margin-mode launch to the region
    (:func:`repro_torch.kernels.fused.build_fused_call` with ``region=``),
    so one loop body can be decomposed into several launches whose outputs
    tile the brick exactly.
    """

    x0: int
    y0: int
    rx: int
    ry: int


@dataclasses.dataclass(frozen=True)
class SplitRegions:
    """Interior/boundary decomposition of one tiled launch.

    ``interior`` is the deep region at distance ``≥ m = k·h`` from every
    brick edge: its depth-``m`` input window lies inside the brick, so its
    launch needs no incoming halo data and can run while the margin
    exchange is in flight.  ``shells`` are the four boundary rectangles
    covering the rest of the brick (two full-height X slabs and two
    X-interior Y strips); their windows reach into the margins, so they
    launch once the exchanged slabs have landed.  The five output regions
    partition the brick: no cell is written twice.
    """

    interior: RegionSpec
    shells: Tuple[RegionSpec, ...]


def split_regions(group: LoweredGroup, k: int, brick_xy: Tuple[int, int]
                  ) -> Optional[SplitRegions]:
    """Interior/boundary split of a ``k``-tiled launch, or ``None``.

    ``None`` when there is nothing to overlap: halo-free bodies (no
    exchange to hide) and bricks too small to keep a nonempty interior at
    depth ``m = k·h`` (``bx ≤ 2m`` or ``by ≤ 2m``).
    """
    m = k * group.halo
    if m == 0:
        return None
    bx, by = brick_xy
    if bx <= 2 * m or by <= 2 * m:
        return None
    interior = RegionSpec(m, m, bx - 2 * m, by - 2 * m)
    shells = (
        RegionSpec(0, 0, m, by),                 # low-X slab (full Y)
        RegionSpec(bx - m, 0, m, by),            # high-X slab
        RegionSpec(m, 0, bx - 2 * m, m),         # low-Y strip
        RegionSpec(m, by - m, bx - 2 * m, m),    # high-Y strip
    )
    return SplitRegions(interior=interior, shells=shells)


# ---------------------------------------------------------------------------
# multigrid: level-indexed operators + inter-grid transfer ops
# ---------------------------------------------------------------------------

#: Smallest grid extent that still admits one coarsening step: the coarse
#: grid ``n//2 + 1`` must keep at least one interior cell (n_c >= 3).
MG_MIN_DIM = 5


@dataclasses.dataclass(frozen=True)
class TransferStencil:
    """One inter-grid transfer op in canonical form.

    The multigrid analogue of :class:`AffineUpdate`: instead of taps on one
    grid, a transfer reads one level and writes the next.  ``kind`` selects
    the fixed weight stencil — ``"restrict"`` is 27-point full weighting
    (tensor product of (1/4, 1/2, 1/4) per axis, weights summing to 1) and
    ``"prolong"`` is trilinear interpolation (its transpose up to the factor
    8).  Vertex alignment is *even*: coarse cell ``I`` sits on fine cell
    ``2I``, so the coarse Moat plane coincides with the fine domain boundary
    on the low side exactly.  Codegen lowers each transfer to one hand-written
    kernel (:mod:`repro_torch.kernels.transfer`), cached per (kind, shapes,
    dtype, device).
    """

    kind: str                         # "restrict" | "prolong"
    fine_shape: Tuple[int, int, int]
    coarse_shape: Tuple[int, int, int]

    def __post_init__(self):
        if self.kind not in ("restrict", "prolong"):
            raise LoweringError(f"unknown transfer kind {self.kind!r}")
        if coarsen_shape(self.fine_shape) != tuple(self.coarse_shape):
            raise LoweringError(
                f"transfer shapes disagree: coarsening {self.fine_shape} "
                f"gives {coarsen_shape(self.fine_shape)}, not "
                f"{tuple(self.coarse_shape)}")


@dataclasses.dataclass(frozen=True)
class MGOperator:
    """Constant-coefficient operator stencil of one multigrid level.

    The level-indexed program form: ``A x = Σ c_d · x[cell + d]`` over the
    full (X, Y, Z) interior, identity on the Moat.  ``taps`` maps integer
    offsets ``(dz, dx, dy)`` to coefficients; the hierarchy is produced by
    :func:`coarsen_operator` and each level is unparsed back into a recorded
    program (smoother / residual bodies) that lowers through the ordinary
    IR → codegen path — one kernel cache entry per level.
    """

    shape: Tuple[int, int, int]       # (nx, ny, nz) of this level's grid
    taps: Tuple[Tuple[Tuple[int, int, int], float], ...]  # sorted offset->c

    @property
    def diag(self) -> float:
        for off, c in self.taps:
            if off == (0, 0, 0):
                return c
        raise LoweringError("mg operator has no diagonal (center) tap")


def coarsen_shape(shape) -> Tuple[int, ...]:
    """Shape of the next-coarser grid: coarse cell I on fine cell 2I, so
    ``n_c = n//2 + 1`` (Moat planes included) for every extent."""
    return tuple(int(n) // 2 + 1 for n in shape)


def coarsenable(shape) -> bool:
    """True when every extent admits one more coarsening (>= MG_MIN_DIM)."""
    return all(int(n) >= MG_MIN_DIM for n in shape)


def mg_fine_operator(group: LoweredGroup, answer: str,
                     shape: Tuple[int, int, int]) -> MGOperator:
    """Validate a lowered operator body for geometric multigrid.

    Re-discretization only makes sense for operators whose off-diagonal
    part scales like a second-order term (h⁻²), which the tap form can
    guarantee only for *symmetric constant-coefficient* stencils updating
    the full interior; anything else raises :class:`LoweringError` with the
    reason (the solver turns that into a clear error or a logged fallback).
    """
    if group is None:
        raise LoweringError(
            "mg needs an affine-lowerable operator body (this one runs on "
            "the interpreter fallback)")
    if len(group.updates) != 1:
        raise LoweringError(
            f"mg needs a single-update operator body, got "
            f"{len(group.updates)} updates")
    u = group.updates[0]
    nz = shape[2]
    if (u.z0, u.zlen) != (1, nz - 2):
        raise LoweringError(
            f"mg needs the operator to update the full interior z window "
            f"[1, {nz - 1}); it updates [{u.z0}, {u.z0 + u.zlen})")
    taps: Dict[Tuple[int, int, int], float] = {}
    for coeff, tps in u.terms:
        if len(tps) != 1 or tps[0].field != answer:
            raise LoweringError(
                "mg needs a constant-coefficient operator (every term one "
                "tap of the unknown); variable-coefficient products cannot "
                "be re-discretized geometrically")
        t = tps[0]
        off = (t.dz, t.dx, t.dy)
        if max(abs(t.dz), abs(t.dx), abs(t.dy)) > 1:
            raise LoweringError(
                f"mg supports taps within the 27-point neighbourhood; tap "
                f"{off} reaches further (re-discretization would change the "
                "coarse stencil radius)")
        taps[off] = taps.get(off, 0.0) + coeff
    for (dz, dx, dy), c in taps.items():
        if (dz, dx, dy) == (0, 0, 0):
            continue
        mirror = taps.get((-dz, -dx, -dy))
        if mirror is None or abs(mirror - c) > 1e-12 * max(1.0, abs(c)):
            raise LoweringError(
                f"mg needs a symmetric operator stencil; tap {(dz, dx, dy)} "
                f"(coeff {c}) has no matching mirror tap")
    if (0, 0, 0) not in taps:
        raise LoweringError("mg operator has no diagonal (center) tap")
    return MGOperator(shape=tuple(shape), taps=tuple(sorted(taps.items())))


def coarsen_operator(op: MGOperator) -> MGOperator:
    """Re-discretize an operator one level coarser.

    Row-sum decomposition: ``A = s·I + L`` with ``s = Σ c_d`` (the zeroth-
    order / mass part, grid-independent) and ``L = A − s·I`` (zero row sum —
    the second-order part, scaling as h⁻²).  Doubling the spacing quarters
    ``L`` while the integer tap offsets stay fixed:

        A_2h = s·I + L_h / 4

    which matches the Galerkin operator of full-weighting/trilinear
    transfers to O(h²) for symmetric stencils — the classic geometric
    coarse-grid operator, derived from the recorded taps alone.
    """
    if not coarsenable(op.shape):
        raise LoweringError(
            f"grid {op.shape} is not coarsenable: every extent must be "
            f">= {MG_MIN_DIM} so the coarse grid keeps an interior")
    s = sum(c for _, c in op.taps)
    coarse = []
    for off, c in op.taps:
        if off == (0, 0, 0):
            coarse.append((off, s + (c - s) / 4.0))
        else:
            coarse.append((off, c / 4.0))
    return MGOperator(shape=coarsen_shape(op.shape), taps=tuple(coarse))


def mg_hierarchy(op: MGOperator, max_levels: int = None) -> List[MGOperator]:
    """The level-indexed operator sequence, finest first.

    Coarsens while every extent stays >= :data:`MG_MIN_DIM` (and below
    ``max_levels`` when given).  Raises :class:`LoweringError` if the fine
    grid admits no coarsening at all — one level is relaxation, not mg.
    """
    if not coarsenable(op.shape):
        raise LoweringError(
            f"grid {op.shape} is not coarsenable: mg needs every extent "
            f">= {MG_MIN_DIM}")
    levels = [op]
    while coarsenable(levels[-1].shape):
        if max_levels is not None and len(levels) >= max_levels:
            break
        levels.append(coarsen_operator(levels[-1]))
    return levels


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


def transpose_taps(group: LoweredGroup, answer: str) -> LoweredGroup:
    """Adjoint of a lowered linear operator: transpose the tap set.

    For a linear operator body in canonical form — every term one tap of
    the unknown ``answer`` at offset ``o_x``, optionally times a coefficient
    tap at ``o_c`` — the transposed stencil follows from re-indexing the
    bilinear form ``<y, A x>``: the unknown tap moves to ``-o_x`` and the
    coefficient tap to ``o_c - o_x``::

        c * C[q + o_c] * x[q + o_x]   →   c * C[p + o_c - o_x] * x[p - o_x]

    (X/Y offsets are periodic — the roll semantics every backend
    implements — and the Moat/z-window row masking is the *same* for the
    adjoint: the identity rows of ``A`` transpose to identity rows plus a
    boundary-column correction the adjoint solver applies outside the
    Krylov loop, see :mod:`repro_torch.solver.adjoint`.)

    The result is re-canonicalized exactly like :func:`lower_update`
    (taps sorted, like terms merged, terms sorted), so a symmetric tap set
    maps to a ``LoweredGroup`` that compares **equal** to the input — and
    therefore hits the *same* kernel-cache entry in
    :func:`repro_torch.compiler.codegen.compile_group`.  Transposing twice
    is the identity on canonical groups.

    Raises :class:`LoweringError` for bodies that are not linear in
    ``answer`` (constant addend, affine-shift terms, products of unknown
    taps) — those have no well-defined operator transpose.
    """
    updates = []
    for u in group.updates:
        if u.field != answer:
            raise LoweringError(
                f"transpose_taps: update writes {u.field!r}, not the "
                f"unknown {answer!r}")
        if u.const != 0.0:
            raise LoweringError(
                f"transpose_taps: operator has a constant addend "
                f"({u.const}); A(x) must be linear in the unknown")
        poly: dict = {}
        for coeff, taps in u.terms:
            unknown = [t for t in taps if t.field == answer]
            if len(unknown) != 1:
                raise LoweringError(
                    "transpose_taps: term is not linear in the unknown "
                    f"({len(unknown)} taps of {answer!r})")
            x = unknown[0]
            rest = list(taps)
            rest.remove(x)
            new = [Tap(answer, -x.dz, -x.dx, -x.dy)] + [
                Tap(t.field, t.dz - x.dz, t.dx - x.dx, t.dy - x.dy)
                for t in rest
            ]
            key = tuple(sorted(new))
            poly[key] = poly.get(key, 0.0) + coeff
        terms = tuple(sorted(
            (coeff, taps) for taps, coeff in poly.items() if coeff != 0.0))
        updates.append(AffineUpdate(field=u.field, z0=u.z0, zlen=u.zlen,
                                    const=0.0, terms=terms))
    halo = 0
    for u in updates:
        for t in u.taps():
            halo = max(halo, abs(t.dx), abs(t.dy))
    return LoweredGroup(updates=tuple(updates), halo=halo)
