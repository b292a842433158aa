"""Recording markers for implicit systems: ``Operator`` and ``Rhs``.

An implicit field equation ``A(x) = b`` enters the WFA frontend exactly like
an explicit update: inside ``with Operator():`` the user records the operator
stencil as a masked self-update of the unknown field, and inside
``with Rhs():`` the update that produces the right-hand side from the
current state.  The BTCS heat system (paper Eq. 3) reads::

    wse = WFAInterface()
    T = Field("T", init_data=T0)
    with Operator():                       # A = I − ωψ·S, identity Moat rows
        T[1:-1, 0, 0] = T[1:-1, 0, 0] - wpsi * (
            T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, -1, 0]
            + T[1:-1, 0, 1] + T[1:-1, 0, -1])
    with Rhs():                            # b = ψ·Tⁿ (Moat rows carry Tⁿ)
        T[1:-1, 0, 0] = psi * T[1:-1, 0, 0]
    x = wse.solve(answer=T, method="cg")

The masked-update semantics give the operator its identity rows for free:
cells outside the target z-slice or on the (X, Y) Moat keep the input value,
so ``A(v) = v`` there — the boundary block of the paper's Eq. 3 matrix.

The markers subclass :class:`~repro_torch.core.program.ForLoop` (with
``n = 1``) so recording, grouping and compilation reuse the explicit-path
machinery unchanged; the ``role`` attribute is how the solver (and the
``make`` guard) recognise them.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.program import ForLoop


class SolverMarker(ForLoop):
    """Base class for solver recording contexts (``role`` set by subclass)."""

    role: Optional[str] = None

    def __init__(self, name: Optional[str] = None):
        super().__init__(name or type(self).__name__.lower(), 1)


class Operator(SolverMarker):
    """Record the matrix-free operator body ``x ↦ A(x)`` (self-updates of
    the unknown field; linear in the unknown, identity on unwritten cells).

    Example — a damped-diffusion operator, solved with CG on the host:

    >>> import numpy as np
    >>> from repro_torch.core import Field, WFAInterface
    >>> from repro_torch.engine import RunOptions
    >>> from repro_torch.solver import Operator, Rhs
    >>> with WFAInterface() as wse:
    ...     T = Field("T", init_data=np.full((8, 8, 8), 1.0, np.float32))
    ...     with Operator():
    ...         T[1:-1, 0, 0] = T[1:-1, 0, 0] - 0.05 * (
    ...             T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
    ...             + T[1:-1, -1, 0] + T[1:-1, 0, 1] + T[1:-1, 0, -1])
    ...     with Rhs():
    ...         T[1:-1, 0, 0] = 0.625 * T[1:-1, 0, 0]
    >>> x = wse.solve(T, method="cg", tol=1e-6,
    ...               options=RunOptions(backend="jit", device="cpu"))
    >>> x.shape, bool(np.isfinite(x).all())
    ((8, 8, 8), True)
    """

    role = "operator"


class Rhs(SolverMarker):
    """Record the right-hand-side body ``state ↦ b`` (updates of the unknown
    field; unwritten cells carry the state value — the identity-row RHS).
    See :class:`Operator` for a complete recorded system."""

    role = "rhs"
