"""Implicit BTCS heat solver (paper Eq. 3) — the legacy drivers, ported
from ``repro/core/implicit.py``.

``A = I − ωψ·S`` with ``S`` the 6-neighbour sum and ``ψ = 1/(1+6ω)``;
identity rows on the Moat.  The single-device operator is the recorded BTCS
program applied by the solver's program step
(:func:`repro_torch.solver.api.operator_fns`), and every iteration lives in
:mod:`repro_torch.solver.krylov`.  This module keeps the historical
surface:

* :func:`btcs_solve` — single-device time stepping (CG, pipelined CG,
  BiCGSTAB, Chebyshev, Jacobi);
* :func:`make_brick_operator` / :func:`make_sharded_iteration` — the brick
  operator over a :class:`repro_torch.core.mesh.Mesh` (K5 when
  ``use_kernel``) and one Krylov iteration over it, the roofline harness;
* :func:`make_sharded_implicit` — forwards to
  :func:`repro_torch.solver.api.make_sharded_solver`.

Dots accumulate in ``promote(dtype, float32)`` (the reference's legacy dots
are float32 sums whatever the dtype); a dot over bricks is the brick-local
sums added in brick order (:func:`repro_torch.core.mesh.psum`).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.explicit import interior_mask3d, neighbor_sum_padded
from repro_torch.core.halo import halo_pad
from repro_torch.core.mesh import BrickArray, Mesh, NamedSharding, psum
from repro_torch.kernels.dotprod import acc_dtype
from repro_torch.kernels.stencil7 import coef, interior
from repro_torch.solver import krylov
from repro_torch.solver.api import make_sharded_solver, operator_fns
from repro_torch.solver.presets import btcs_program, psi

__all__ = [
    "bicgstab_solve", "btcs_solve", "cg_solve", "chebyshev_bounds",
    "chebyshev_solve", "jacobi_solve", "make_brick_operator",
    "make_operator", "make_sharded_implicit", "make_sharded_iteration",
    "pipecg_solve", "psi",
]

# the Krylov/relaxation iterations, re-exported under their legacy names
cg_solve = krylov.cg
pipecg_solve = krylov.pipecg
bicgstab_solve = krylov.bicgstab
chebyshev_solve = krylov.chebyshev
jacobi_solve = krylov.jacobi

#: legacy entry points that already warned this process (warn once each)
_DEPRECATION_WARNED = set()


def _warn_legacy(fn: str) -> None:
    if fn in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(fn)
    warnings.warn(
        f"repro_torch.core.implicit.{fn} is deprecated; record the system "
        "through the WFA frontend (repro_torch.solver presets) and call "
        "wfa.solve — repro_torch.solver.solve / WFAInterface.solve — instead",
        DeprecationWarning,
        stacklevel=3,
    )


def _dot(a, b):
    return torch.sum(a * b, dtype=acc_dtype(a.dtype))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _make_operator(w: float, shape, device="cuda"):
    A, rhs = operator_fns(btcs_program(shape, w), "T", backend="jit",
                          device=device)
    return A, rhs, _dot, interior_mask3d(shape, device)


def make_operator(w: float, shape, device="cuda"):
    """Single-device masked BTCS operator, rhs builder, dot and mask, on
    ``device`` (default the card).

    .. deprecated:: use ``wfa.solve`` (or
       :func:`repro_torch.solver.operator_fns`); this shim warns once and
       forwards.
    """
    _warn_legacy("make_operator")
    return _make_operator(w, shape, device)


def make_brick_operator(w: float, brick_shape, mesh: Mesh, use_kernel: bool = False):
    """The brick operator over ``mesh``: ``(A, rhs, dot, masks)``.

    ``A(v)`` on a :class:`~repro_torch.core.mesh.BrickArray` is the halo
    exchange plus the padded stencil on every brick — K5 (its dot
    discarded) when ``use_kernel``, the plain ``v − ωψ·S`` otherwise — with
    identity Moat rows; ``dot(a, b)`` is the brick-local dots summed over
    the mesh; ``masks`` holds each brick's Moat mask.
    """
    from repro_torch.kernels import ops as kops

    bx, by, nz = brick_shape
    mx, my = mesh.dims
    wpsi = w * psi(w)
    masks = [interior(bx, by, nz, mesh.coords(b), mx * bx, my * by, d)
             for b, d in enumerate(mesh.devices)]

    def A(v: BrickArray) -> BrickArray:
        P = halo_pad(v.bricks, 1, mesh)
        out = []
        for t, p, m in zip(v.bricks, P, masks):
            if use_kernel:
                av = kops.spmv_hex(p, 1.0, -wpsi)
            else:
                av = t - coef(wpsi, t.dtype) * neighbor_sum_padded(p)
            out.append(torch.where(m, av, t))
        return BrickArray(out, v.sharding)

    def rhs(T: BrickArray) -> BrickArray:
        return BrickArray([torch.where(m, coef(psi(w), t.dtype) * t, t)
                           for t, m in zip(T.bricks, masks)], T.sharding)

    def dot(a: BrickArray, b: BrickArray) -> torch.Tensor:
        return psum([_dot(x, y) for x, y in zip(a.bricks, b.bricks)], mesh)

    return A, rhs, dot, masks


def chebyshev_bounds(w: float) -> Tuple[float, float]:
    """Analytic eigenvalue bounds of ``A = I − ωψS`` on the interior
    subspace: ``[1 − 6ωψ, 1 + 6ωψ]`` (``[0.625, 1.375]`` at ω = 0.1)."""
    wp = w * psi(w)
    return 1.0 - 6.0 * wp, 1.0 + 6.0 * wp


# ---------------------------------------------------------------------------
# time-stepping drivers
# ---------------------------------------------------------------------------

def _btcs_solve_impl(T0: torch.Tensor, w: float, steps: int, method: str,
                     tol: float, maxiter: int):
    A, rhs, dot, _ = _make_operator(w, tuple(T0.shape), T0.device)

    def dot2(a, b, c, d):
        return dot(a, b), dot(c, d)

    T, iters, res = T0, [], []
    for _ in range(steps):
        b = rhs(T)
        if method == "cg":
            T, i, r, _ = krylov.cg(A, dot, b, T, tol=tol, maxiter=maxiter)
        elif method == "pipecg":
            T, i, r, _ = krylov.pipecg(A, dot2, b, T, tol=tol, maxiter=maxiter)
        elif method == "bicgstab":
            T, i, r, _ = krylov.bicgstab(A, dot, b, T, tol=tol, maxiter=maxiter)
        elif method == "chebyshev":
            lmin, lmax = chebyshev_bounds(w)
            T, i, r, _ = krylov.chebyshev(A, b, T, lmin, lmax, iters=maxiter)
        elif method == "jacobi":
            # unit diagonal + identity Moat rows: x + b − A(x) IS the sweep
            T, i, r, _ = krylov.jacobi(lambda x, b=b: x + b - A(x), T,
                                       iters=maxiter)
        else:
            raise ValueError(method)
        iters.append(i)
        res.append(r.to(T.device))
    aux = (torch.tensor(iters, dtype=torch.int32),
           torch.stack(res) if res else torch.zeros(0, device=T0.device))
    return T, aux


def btcs_solve(T0, w: float, steps: int, method: str = "cg", tol: float = 1e-6,
               maxiter: int = 500, device=None):
    """Advance ``steps`` BTCS time steps on one device.

    ``T0`` is a tensor (its device is used) or a NumPy array (moved to
    ``device``, default the card).  Returns ``(T, (iterations, residuals))``,
    one entry per step.

    .. deprecated:: record the system (``repro_torch.solver.record_btcs``)
       and call ``wfa.solve``; this shim warns once and forwards.
    """
    from repro_torch.engine.plan import resolve_device

    _warn_legacy("btcs_solve")
    if not isinstance(T0, torch.Tensor):
        T0 = torch.as_tensor(T0, device=resolve_device(device or "cuda"))
    elif device is not None:
        T0 = T0.to(resolve_device(device))
    return _btcs_solve_impl(T0, w, steps, method=method, tol=tol, maxiter=maxiter)


def make_sharded_implicit(mesh, shape, w: float, *, method: str = "cg",
                          tol: float = 1e-6, maxiter: int = 500,
                          use_kernel: bool = False, steps: int = 1):
    """Brick-sharded BTCS solver over ``mesh``; returns ``(step_fn,
    sharding)``, ``step_fn(T)`` advancing ``steps`` BTCS steps from the
    global field (a NumPy array, a tensor or a
    :class:`~repro_torch.core.mesh.BrickArray` of ``sharding``) to a
    BrickArray.

    .. deprecated:: use ``wfa.solve(..., mesh=...)``; this shim warns once
       and forwards to :func:`repro_torch.solver.api.make_sharded_solver`
       (the recorded BTCS body through K1 per brick when ``use_kernel``, the
       roll interpreter on halo-padded bricks otherwise).
    """
    _warn_legacy("make_sharded_implicit")
    backend = "pallas" if use_kernel else "jit"
    step, sharding = make_sharded_solver(
        btcs_program(shape, w), "T", mesh, method=method, backend=backend,
        tol=tol, maxiter=maxiter, steps=steps)

    def step_fn(T):
        return step(T)[0]

    return step_fn, sharding


# ---------------------------------------------------------------------------
# roofline iteration harness (exact per-iteration accounting)
# ---------------------------------------------------------------------------

class StateSpec(NamedTuple):
    """Shape, dtype and sharding of one entry of an iteration state (the
    reference's ``jax.ShapeDtypeStruct``); ``sharding`` is None for a
    replicated scalar."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding]


def make_sharded_iteration(mesh: Mesh, shape, w: float, *, method: str = "cg",
                           use_kernel: bool = False):
    """One inner Krylov iteration over ``mesh`` as a standalone step (no
    solver set-up, no stop test).  Returns ``(step, state_specs)``; the
    state tuples are

        cg:        (x, r, p, rr)
        pipecg:    (x, r, w, z, p, s, gamma, alpha)
        chebyshev: (x, r, d, rho)

    with the vectors :class:`~repro_torch.core.mesh.BrickArray`s and the
    scalars 0-d tensors (:func:`repro_torch.convert.state_from_numpy`
    builds them).  With ``use_kernel`` cg's ``Ap`` and ``p·Ap`` come from
    K5 in one pass (its dot over the unmasked ``Ap``, as the reference's),
    pipecg and chebyshev apply the operator through K5, and pipecg's dot
    pair is K2 (:func:`repro_torch.kernels.ops.dual_dot`).
    """
    from repro_torch.kernels import ops as kops

    if method not in ("cg", "pipecg", "chebyshev"):
        raise ValueError(method)
    ax_x, ax_y = mesh.axis_names[-2], mesh.axis_names[-1]
    mx, my = mesh.shape[ax_x], mesh.shape[ax_y]
    nx, ny, nz = shape
    bx, by = nx // mx, ny // my
    sharding = NamedSharding(mesh, (ax_x, ax_y, None))
    A, rhs, dot, masks = make_brick_operator(w, (bx, by, nz), mesh,
                                             use_kernel=use_kernel)
    wpsi = w * psi(w)

    def dot2(a, b, c, d):
        if use_kernel:
            parts = [kops.dual_dot(*v) for v in zip(a.bricks, b.bricks, c.bricks,
                                                     d.bricks)]
        else:
            parts = [torch.stack([_dot(p, q), _dot(r, s)])
                     for p, q, r, s in zip(a.bricks, b.bricks, c.bricks, d.bricks)]
        part = psum(parts, mesh)
        return part[0], part[1]

    def cg(state):
        x, r, p, rr = state
        if use_kernel:
            P = halo_pad(p.bricks, 1, mesh)
            outs = [kops.spmv_hex_dot(q, 1.0, -wpsi) for q in P]
            Ap = BrickArray([torch.where(m, av, t) for (av, _), m, t
                             in zip(outs, masks, p.bricks)], sharding)
            pAp = psum([d for _, d in outs], mesh)
        else:
            Ap = A(p)
            pAp = dot(p, Ap)
        alpha = rr / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = dot(r, r)
        beta = rr_new / rr
        p = r + beta * p
        return (x, r, p, rr_new)

    def pipecg(state):
        x, r, w_, z, p, sv, gamma_prev, alpha_prev = state
        gamma, delta = dot2(r, r, w_, r)
        n = A(w_)
        beta = gamma / gamma_prev
        alpha = gamma / (delta - beta * gamma / alpha_prev)
        z = n + beta * z
        p = r + beta * p
        sv = w_ + beta * sv
        x = x + alpha * p
        r = r - alpha * sv
        w_ = w_ - alpha * z
        return (x, r, w_, z, p, sv, gamma, alpha)

    def chebyshev(state):
        x, r, d, rho = state
        lmin, lmax = chebyshev_bounds(w)
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma1 = theta / delta
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        x = x + d
        return (x, r, d, rho_new)

    step = {"cg": cg, "pipecg": pipecg, "chebyshev": chebyshev}[method]
    n_vec = {"cg": 3, "pipecg": 6, "chebyshev": 3}[method]
    n_scal = {"cg": 1, "pipecg": 2, "chebyshev": 1}[method]
    specs = tuple([StateSpec((nx, ny, nz), torch.float32, sharding)] * n_vec
                  + [StateSpec((), torch.float32, None)] * n_scal)
    return step, specs
