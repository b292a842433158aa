"""Plain reference of the heat3d configuration (``heat3d.json``).

Plain PyTorch on whatever device its tensors are on, in the dtype it is
given: the seeded initial field, the explicit FTCS step of Eq. 1 as Fig. 3
writes it, and the implicit BTCS step of Eq. 3 solved by plain conjugate
gradients.  It imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

#: the interior of the grid: no Moat ring, no first or last z plane
INTERIOR = (slice(1, -1),) * 3


def psi(omega: float) -> float:
    """The BTCS diagonal normalization ψ = 1/(1 + 6ω)."""
    return 1.0 / (1.0 + 6.0 * omega)


def bodies(cfg: dict) -> dict:
    """Each recorded body as ``(coefficient, taps)`` groups, for the
    yardstick's operation count."""
    w = cfg["omega"]
    return {"ftcs": [(1.0 - 6.0 * w, 1), (w, 6)],
            "btcs_operator": [(1.0, 1), (-w * psi(w), 6)],
            "btcs_rhs": [(psi(w), 1)]}


def shape(cfg: dict) -> tuple:
    return (cfg["nx"], cfg["ny"], cfg["nz"])


def initial_fields(cfg: dict, seed: int, count: int, device) -> list:
    """``count`` initial fields drawn from ``seed``: Fig. 3's uniform
    ``init`` with the cold and hot z planes, each interior cell moved by a
    uniform draw in ±``init_perturbation_k``; float32 on ``device``, drawn
    there by one generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    amp = cfg["assumed"]["init_perturbation_k"]
    out = []
    for _ in range(count):
        T = torch.full(shape(cfg), cfg["init"], dtype=torch.float32,
                       device=device)
        T[1:-1, 1:-1, 0] = cfg["bc_cold"]
        T[1:-1, 1:-1, -1] = cfg["bc_hot"]
        u = torch.rand(T[INTERIOR].shape, generator=gen, device=device)
        T[INTERIOR] += amp * (2.0 * u - 1.0)
        out.append(T)
    return out


def neighbours(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The sum of the six face neighbours of every interior cell, into
    ``out`` (the interior's shape)."""
    torch.add(x[2:, 1:-1, 1:-1], x[:-2, 1:-1, 1:-1], out=out)
    out += x[1:-1, 2:, 1:-1]
    out += x[1:-1, :-2, 1:-1]
    out += x[1:-1, 1:-1, 2:]
    out += x[1:-1, 1:-1, :-2]
    return out


def ftcs(T: torch.Tensor, omega: float, steps: int) -> torch.Tensor:
    """``steps`` explicit steps of Eq. 1 from ``T`` (not modified), in
    ``T``'s dtype: T ← (1 − 6ω)·T + ω·ΣT_neighbours on the interior."""
    T = T.clone()
    acc = torch.empty_like(T[INTERIOR])
    for _ in range(steps):
        neighbours(T, acc)
        acc *= omega
        acc.add_(T[INTERIOR], alpha=1.0 - 6.0 * omega)
        T[INTERIOR] = acc
    return T


def btcs_rhs(T: torch.Tensor, omega: float) -> torch.Tensor:
    """b = ψ·T on the interior, T elsewhere."""
    b = T.clone()
    b[INTERIOR] *= psi(omega)
    return b


def btcs_apply(x: torch.Tensor, omega: float, acc: torch.Tensor) -> torch.Tensor:
    """A x = x − ωψ·Σx_neighbours on the interior, x elsewhere."""
    y = x.clone()
    neighbours(x, acc)
    y[INTERIOR] -= (omega * psi(omega)) * acc
    return y


def cg(apply, b: torch.Tensor, x: torch.Tensor, tol: float,
       maxiter: int) -> tuple:
    """Plain conjugate gradients on ``apply`` from ``x`` (modified) until
    ‖b − A x‖ ≤ ``tol``; returns ``(x, iterations, converged)``.  The
    scalars are those of ``b``'s dtype."""
    r = b - apply(x)
    p = r.clone()
    rr = torch.dot(r.flatten(), r.flatten())
    for it in range(maxiter + 1):
        if math.sqrt(max(float(rr), 0.0)) <= tol:
            return x, it, True
        if it == maxiter:
            break
        Ap = apply(p)
        alpha = rr / torch.dot(p.flatten(), Ap.flatten())
        x += alpha * p
        r -= alpha * Ap
        rr_new = torch.dot(r.flatten(), r.flatten())
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, maxiter, False


def btcs_march(T: torch.Tensor, omega: float, steps: int, rel_tol: float,
               maxiter: int, abs_tol: float = None) -> tuple:
    """``steps`` implicit steps of Eq. 3 from ``T`` (not modified), each
    ``A x = b(x_prev)`` solved by :func:`cg` warm-started at the previous
    state to ``rel_tol``·‖b‖ (or ``abs_tol``), in ``T``'s dtype; returns
    ``(x, iterations by step, converged by step)``."""
    x = T.clone()
    acc = torch.empty_like(x[INTERIOR])
    iters, ok = [], []
    for _ in range(steps):
        b = btcs_rhs(x, omega)
        tol = abs_tol if abs_tol is not None else rel_tol * float(
            torch.linalg.vector_norm(b.double()))
        x, it, conv = cg(lambda v: btcs_apply(v, omega, acc), b, x, tol,
                         maxiter)
        iters.append(it)
        ok.append(conv)
    return x, iters, ok


def btcs_rhs_norm(T: torch.Tensor, omega: float) -> float:
    """‖b‖ of the BTCS system at state ``T``, in float64."""
    return float(torch.linalg.vector_norm(btcs_rhs(T.double(), omega)))
