"""repro_torch.solver — implicit field equations as first-class WFA programs.

The port of ``repro.solver``, on one device or the bricks of a mesh:

1. :mod:`~repro_torch.solver.frontend` — ``Operator()``/``Rhs()`` recording
   contexts: the operator stencil ``A(v)`` is written exactly like an
   explicit update (masked self-update of the unknown — identity Moat rows
   for free);
2. :mod:`~repro_torch.solver.api` — ``solve``: compiles the recorded bodies
   through :mod:`repro_torch.compiler` (the fused kernel K1, kernel cache,
   stats, logged interpreter fallback) and runs matrix-free iterations on
   the compiled application, with the fused dot pair K2 on
   ``backend="pallas"``; ``make_sharded_solver`` (``solve(mesh=…)``) runs
   the same iterations on brick-sharded vectors;
3. :mod:`~repro_torch.solver.krylov` — CG, pipelined CG, BiCGSTAB,
   Chebyshev, Jacobi and the stationary outer loop, guarded by
   :mod:`~repro_torch.solver.health`;
4. :mod:`~repro_torch.solver.multigrid` — geometric V/W-cycles whose every
   component (per-level smoother/residual programs, re-discretized coarse
   operators, the transfer kernels K3/K4) lowers through the same IR →
   codegen path;
5. :mod:`~repro_torch.solver.presets` — canonical recorded systems (BTCS
   heat, variable-coefficient diffusion, Dirichlet Poisson).

6. :mod:`~repro_torch.solver.adjoint` — reverse-mode AD through a solve
   (the implicit-function-theorem adjoint: one transposed Krylov solve on
   the same compiled kernels).
"""

from repro_torch.solver import health, krylov
from repro_torch.solver.adjoint import ADJOINT_METHODS, make_differentiable_solver
from repro_torch.solver.api import (
    SolveInfo,
    gershgorin_bounds,
    make_sharded_solver,
    make_solver,
    operator_fns,
    solve,
)
from repro_torch.solver.frontend import Operator, Rhs, SolverMarker
from repro_torch.solver.health import (
    GuardConfig,
    NumericalFault,
    RecoveryPolicy,
    RecoveryTrace,
)
from repro_torch.solver.multigrid import MGOptions, Multigrid, build_multigrid
from repro_torch.solver.presets import (
    btcs_program,
    poisson_program,
    psi,
    record_btcs,
    record_poisson,
    record_varcoef_btcs,
)

__all__ = [
    "ADJOINT_METHODS",
    "GuardConfig",
    "MGOptions",
    "Multigrid",
    "NumericalFault",
    "Operator",
    "RecoveryPolicy",
    "RecoveryTrace",
    "Rhs",
    "SolveInfo",
    "SolverMarker",
    "btcs_program",
    "build_multigrid",
    "gershgorin_bounds",
    "health",
    "krylov",
    "make_differentiable_solver",
    "make_sharded_solver",
    "make_solver",
    "operator_fns",
    "poisson_program",
    "psi",
    "record_btcs",
    "record_poisson",
    "record_varcoef_btcs",
    "solve",
]
