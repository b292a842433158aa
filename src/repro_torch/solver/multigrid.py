"""Geometric multigrid through the WFA program compiler.

The port of ``repro/solver/multigrid.py``.  Every multigrid component is an
ordinary recorded WFA program (or a canonical transfer op) lowered through
the existing IR → codegen path:

* the **level operators** come from
  :func:`repro_torch.compiler.ir.mg_hierarchy` — the user's recorded taps,
  re-discretized per level (row-sum rule);
* the **smoother** (weighted Jacobi, or red-black Gauss–Seidel as two
  masked half-sweeps) and the **residual** are unparsed back into recorded
  programs per level (:func:`_record_smoother` / :func:`_record_residual`)
  and compiled by :func:`repro_torch.engine.plan_mg_levels` through
  ``engine.compile_body`` — one fused kernel K1 cache entry per level on
  ``backend="pallas"``, the roll interpreter on ``backend="jit"``;
* the **transfers** (full-weighting restriction, trilinear prolongation)
  are :class:`repro_torch.compiler.ir.TransferStencil` ops compiled by
  :func:`repro_torch.compiler.codegen.compile_transfer` into the kernels K3
  and K4 of :mod:`repro_torch.kernels.transfer`.

``solve(..., method="mg")`` iterates the cycle as a standalone solver;
``precondition="mg"`` applies one cycle from a zero guess as an SPD
preconditioner inside CG/BiCGSTAB (see :mod:`repro_torch.solver.api`).

The reference's ``fori_loop`` sweeps are Python loops here, and the
red-black colour masks are device-resident boolean tensors applied with
``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.compiler import MGOperator, mg_fine_operator, mg_hierarchy
from repro_torch.core.field import Field
from repro_torch.core.program import scoped_program

#: default damping for weighted Jacobi — the classic smoothing-optimal
#: factor for the 7-point 3-D Laplacian family
JACOBI_OMEGA = 6.0 / 7.0


@dataclasses.dataclass(frozen=True)
class MGOptions:
    """Cycle shape and smoothing budget of one multigrid hierarchy.

    ``cycle``        — ``"v"`` (one coarse visit) or ``"w"`` (two);
    ``smoother``     — ``"jacobi"`` (weighted, ``omega``-damped) or ``"rb"``
                       (red-black Gauss–Seidel: two checkerboard-masked
                       half-sweeps, post-smoothing in reversed colour order
                       so the cycle stays symmetric; ``omega`` is ignored,
                       and each half-sweep reuses the full-grid smoother
                       kernel, discarding the off-colour half);
    ``nu1``/``nu2``  — pre-/post-smoothing sweeps (keep equal when the
                       cycle is used as a CG preconditioner: symmetry);
    ``coarse_iters`` — smoother sweeps standing in for the coarsest solve;
    ``max_levels``   — cap on hierarchy depth, >= 2 (``None`` = coarsen
                       while every extent stays >= ``ir.MG_MIN_DIM``).

    >>> MGOptions(cycle="w", smoother="rb").nu1
    2
    >>> MGOptions(cycle="f")
    Traceback (most recent call last):
        ...
    ValueError: mg cycle must be 'v' or 'w', got 'f'
    """

    cycle: str = "v"
    smoother: str = "jacobi"
    nu1: int = 2
    nu2: int = 2
    coarse_iters: int = 40
    omega: float = JACOBI_OMEGA
    max_levels: Optional[int] = None

    def __post_init__(self):
        if self.cycle not in ("v", "w"):
            raise ValueError(f"mg cycle must be 'v' or 'w', got {self.cycle!r}")
        if self.smoother not in ("jacobi", "rb"):
            raise ValueError(
                f"mg smoother must be 'jacobi' or 'rb', got {self.smoother!r}"
            )
        if min(self.nu1, self.nu2, self.coarse_iters) < 1:
            raise ValueError("mg smoothing counts must be >= 1")
        if self.max_levels is not None and self.max_levels < 2:
            raise ValueError(
                f"mg needs max_levels >= 2 (got {self.max_levels}); one "
                "level is plain relaxation, not multigrid"
            )


def _record_smoother(op: MGOperator, omega: float, dtype):
    """Record one level's damped-Jacobi sweep as a WFA program.

    ``x ← x + (ω/d)(b − A x)`` expands to an affine update in taps of ``x``
    plus the centre tap of ``b`` — the canonical form the compiler fuses,
    so each sweep is one kernel launch.  Returns the ``(ops, shapes,
    dtypes)`` triple :func:`repro_torch.engine.plan_mg_levels` compiles.
    """
    nz = op.shape[2]
    z0, zlen = 1, nz - 2
    wd = omega / op.diag
    with scoped_program() as p:
        x = Field("x", shape=op.shape, dtype=dtype)
        b = Field("b", shape=op.shape, dtype=dtype)
        expr = wd * b[slice(z0, z0 + zlen), 0, 0]
        for (dz, dx, dy), c in op.taps:
            coeff = 1.0 - wd * c if (dz, dx, dy) == (0, 0, 0) else -wd * c
            expr = expr + coeff * x[slice(z0 + dz, z0 + dz + zlen), dx, dy]
        x[slice(z0, z0 + zlen), 0, 0] = expr
    shapes = {n: f.shape for n, f in p.fields.items()}
    dtypes = {n: f.dtype for n, f in p.fields.items()}
    return p.ops, shapes, dtypes


def _record_residual(op: MGOperator, dtype):
    """Record one level's residual ``r = b − A x`` as a WFA program.

    Writes a third field ``r`` (zero Moat — the coarse problem's
    homogeneous Dirichlet rows come for free from the unwritten cells).
    """
    nz = op.shape[2]
    z0, zlen = 1, nz - 2
    with scoped_program() as p:
        x = Field("x", shape=op.shape, dtype=dtype)
        b = Field("b", shape=op.shape, dtype=dtype)
        r = Field("r", shape=op.shape, dtype=dtype)
        expr = b[slice(z0, z0 + zlen), 0, 0]
        for (dz, dx, dy), c in op.taps:
            expr = expr - c * x[slice(z0 + dz, z0 + dz + zlen), dx, dy]
        r[slice(z0, z0 + zlen), 0, 0] = expr
    shapes = {n: f.shape for n, f in p.fields.items()}
    dtypes = {n: f.dtype for n, f in p.fields.items()}
    return p.ops, shapes, dtypes


def _parity_mask(shape) -> np.ndarray:
    """(X, Y, Z) checkerboard: True where (x + y + z) is even."""
    gx, gy, gz = np.ogrid[: shape[0], : shape[1], : shape[2]]
    return (gx + gy + gz) % 2 == 0


class Multigrid:
    """A compiled multigrid hierarchy: V/W-cycle and preconditioner apply.

    Built by :func:`build_multigrid`; holds the engine-scheduled
    :class:`~repro_torch.engine.plan.LevelSegment` list (finest first).
    Tensors live on ``device``; the red-black masks are uploaded once.
    """

    def __init__(self, segments, opts: MGOptions, dtype, device):
        self.segments = segments
        self.opts = opts
        self.dtype = dtype
        self._masks = {}
        if opts.smoother == "rb":
            for seg in segments:
                self._masks[seg.level] = torch.tensor(
                    _parity_mask(seg.shape), device=device)

    @property
    def n_levels(self) -> int:
        return len(self.segments)

    def _smooth(self, seg, x, b, n: int, reverse: bool = False):
        red = self._masks.get(seg.level)
        for _ in range(n):
            if self.opts.smoother == "jacobi":
                x = seg.smooth({"x": x, "b": b})["x"]
                continue
            order = (~red, red) if reverse else (red, ~red)
            for mask in order:
                x = torch.where(mask, seg.smooth({"x": x, "b": b})["x"], x)
        return x

    def _residual(self, seg, x, b):
        env = {"x": x, "b": b, "r": torch.zeros_like(x)}
        return seg.resid(env)["r"]

    def _descend(self, level: int, x, b):
        seg = self.segments[level]
        if level == self.n_levels - 1:
            return self._smooth(seg, x, b, self.opts.coarse_iters)
        x = self._smooth(seg, x, b, self.opts.nu1)
        rc = seg.restrict(self._residual(seg, x, b))
        ec = torch.zeros(self.segments[level + 1].shape, dtype=rc.dtype,
                         device=rc.device)
        ec = self._descend(level + 1, ec, rc)
        if self.opts.cycle == "w" and level + 1 < self.n_levels - 1:
            ec = self._descend(level + 1, ec, rc)
        x = x + seg.prolong(ec)
        return self._smooth(seg, x, b, self.opts.nu2, reverse=True)

    def cycle(self, x, b):
        """One V/W-cycle on the finest level: ``x ← MG(x, b)``."""
        return self._descend(0, x, b)

    def apply(self, r):
        """Preconditioner action ``M⁻¹ r``: one cycle from a zero guess.

        With symmetric smoothing (``nu1 == nu2``, reversed-colour post-
        sweeps for ``"rb"``) this is a symmetric positive definite linear
        operator — safe inside CG.
        """
        return self.cycle(torch.zeros_like(r), r)

    def residual_norm2(self, x, b, dot):
        """``dot(r, r)`` of the fine-level residual (outer-loop stopping)."""
        r = self._residual(self.segments[0], x, b)
        return dot(r, r)


def build_multigrid(
    group, answer: str, shape, dtype, backend: str, opts: MGOptions = None,
    device="cuda",
) -> Multigrid:
    """Build the compiled hierarchy for a lowered operator body.

    The hierarchy lives on ``device``: the card by default, which must
    exist (pass ``device="cpu"`` to run the plain versions on the host).

    ``group`` is the operator's :class:`~repro_torch.compiler.ir.LoweredGroup`
    (``None`` when it did not lower — rejected here with the reason).
    Raises :class:`repro_torch.compiler.LoweringError` when the operator or
    grid is outside multigrid's domain: non-affine / variable-coefficient /
    asymmetric stencils, taps beyond the 27-point neighbourhood, or a grid
    with no coarsenable extent.
    """
    from repro_torch.engine import plan_mg_levels, resolve_device

    device = resolve_device(device)
    opts = opts or MGOptions()
    fine = mg_fine_operator(group, answer, tuple(shape))
    levels = mg_hierarchy(fine, opts.max_levels)
    omega = 1.0 if opts.smoother == "rb" else opts.omega
    bodies = [
        {
            "shape": op.shape,
            "diag": op.diag,
            "smooth": _record_smoother(op, omega, dtype),
            "resid": _record_residual(op, dtype),
        }
        for op in levels
    ]
    segments = plan_mg_levels(bodies, backend, dtype, device)
    return Multigrid(segments, opts, dtype, device)
