"""Canonical implicit programs, recorded through the WFA frontend.

These are the systems the paper benchmarks, spelled as recorded programs so
every solver path compiles the *same* operator body through the *same*
IR → codegen pipeline as the explicit programs (the port of
``repro/solver/presets.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.field import Field
from repro_torch.core.program import Program, WFAInterface, scoped_program
from repro_torch.solver.frontend import Operator, Rhs


def psi(w: float) -> float:
    """The BTCS diagonal normalization ψ = 1/(1 + 6ω) (paper Eq. 3)."""
    return 1.0 / (1.0 + 6.0 * w)


def _record_btcs_body(T, w: float) -> None:
    """Record A = I − ωψ·S (identity Moat rows) and b = ψ·Tⁿ onto ``T``."""
    wpsi = w * psi(w)
    with Operator():
        T[1:-1, 0, 0] = T[1:-1, 0, 0] - wpsi * (
            T[2:, 0, 0]
            + T[:-2, 0, 0]
            + T[1:-1, 1, 0]
            + T[1:-1, -1, 0]
            + T[1:-1, 0, 1]
            + T[1:-1, 0, -1]
        )
    with Rhs():
        T[1:-1, 0, 0] = psi(w) * T[1:-1, 0, 0]


def btcs_program(
    shape: Tuple[int, int, int],
    w: float,
    init_data: Optional[np.ndarray] = None,
    name: str = "T",
) -> Program:
    """The BTCS heat system (paper Eq. 3) as a recorded :class:`Program`.

    Safe to call while another program is active (uses a scoped recording
    context).
    """
    with scoped_program() as program:
        T = Field(name, init_data=init_data, shape=shape)
        _record_btcs_body(T, w)
    return program


def record_btcs(T0: np.ndarray, w: float, name: str = "T"):
    """User-facing variant: records the BTCS system into a fresh
    :class:`WFAInterface`; returns ``(wse, field)`` ready for
    ``wse.solve(answer=field, ...)``."""
    wse = WFAInterface()
    T = Field(name, init_data=T0)
    _record_btcs_body(T, w)
    return wse, T


def _record_poisson_body(T, F) -> None:
    """Record A = 6I − S (unit-spacing Dirichlet Laplacian) and b = F."""
    with Operator():
        T[1:-1, 0, 0] = 6.0 * T[1:-1, 0, 0] - (
            T[2:, 0, 0]
            + T[:-2, 0, 0]
            + T[1:-1, 1, 0]
            + T[1:-1, -1, 0]
            + T[1:-1, 0, 1]
            + T[1:-1, 0, -1]
        )
    with Rhs():
        T[1:-1, 0, 0] = F[1:-1, 0, 0]


def poisson_program(
    shape: Tuple[int, int, int],
    rhs: Optional[np.ndarray] = None,
    init_data: Optional[np.ndarray] = None,
    name: str = "T",
) -> Program:
    """The Dirichlet Poisson system ``−∇²u = f`` (unit spacing) as a
    recorded :class:`Program` — the canonical stiff elliptic workload for
    the multigrid solver (``method="mg"`` / ``precondition="mg"``).

    ``init_data``'s Moat carries the boundary values (zero by default);
    ``rhs`` is the source term ``f`` on the interior.
    """
    with scoped_program() as program:
        T = Field(name, init_data=init_data, shape=shape)
        F = Field(name + "_rhs", init_data=rhs, shape=shape)
        _record_poisson_body(T, F)
    return program


def record_poisson(F0: np.ndarray, T0: Optional[np.ndarray] = None, name: str = "T"):
    """User-facing variant: records the Poisson system into a fresh
    :class:`WFAInterface`; returns ``(wse, field)`` ready for
    ``wse.solve(answer=field, method="mg", ...)``."""
    wse = WFAInterface()
    T = Field(name, init_data=T0, shape=F0.shape)
    F = Field(name + "_rhs", init_data=F0)
    _record_poisson_body(T, F)
    return wse, T


def record_varcoef_btcs(T0: np.ndarray, C0: np.ndarray, w: float, name: str = "T"):
    """Variable-coefficient implicit diffusion: A = I + ωC·(6I − S).

    ``C`` is a per-cell diffusivity field, so the operator row-scales the
    graph Laplacian and is **non-symmetric** — the BiCGSTAB use case.  The
    lowering pass turns the ``C·T`` products into two-tap terms, so
    ``backend="pallas"`` still fuses the whole application into one kernel.
    Returns ``(wse, T_field, C_field)``.
    """
    wse = WFAInterface()
    T = Field(name, init_data=T0)
    C = Field(name + "_coef", init_data=C0)
    with Operator():
        T[1:-1, 0, 0] = T[1:-1, 0, 0] + w * C[1:-1, 0, 0] * (
            6.0 * T[1:-1, 0, 0]
            - (
                T[2:, 0, 0]
                + T[:-2, 0, 0]
                + T[1:-1, 1, 0]
                + T[1:-1, -1, 0]
                + T[1:-1, 0, 1]
                + T[1:-1, 0, -1]
            )
        )
    return wse, T, C
