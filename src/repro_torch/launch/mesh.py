"""Production mesh builders (functions, never module-level constants —
importing this module must not touch device state).

The port of ``repro/launch/mesh.py``: the reference's shapes and axis names
as single-process :class:`~repro_torch.core.mesh.Mesh` es whose positions
are all on ``device`` (the card unless the caller asks for the CPU) or on
the listed devices, position by position.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The target deployment mesh.

    Single pod: 16×16 = 256 positions, axes (data, model).
    Multi-pod: 2×16×16 = 512 positions, axes (pod, data, model) — the
    ``pod`` axis carries pure data parallelism.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh2d(data: int, model: int, *, pod: int = 0,
                device="cuda") -> Mesh:
    """Arbitrary-size mesh with the production axis names (tests use 2×2)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device=device)
    return make_mesh((data, model), ("data", "model"), device=device)
