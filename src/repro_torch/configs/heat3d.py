"""heat3d — the paper's own workload (Eq. 1) as a config.

Grid sizes follow the paper's test points: the Fig. 3 example (102³ with
boundary layers) and the industrially-relevant zone (5.8e6–4.67e7 cells);
the default 512×512×128 float32 grid is 3.36e7 cells, about 134 MB a field.
The implicit side of the workload (Eq. 3) is parameterized here too:
``method``/``tol``/``maxiter`` feed :func:`record_implicit`, which records
the BTCS system through the WFA frontend ready for ``wse.solve``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    name: str = "heat3d"
    nx: int = 512
    ny: int = 512
    nz: int = 128             # 3.3e7 cells ~ the industrial zone
    omega: float = 0.1        # the paper's test diagonal constant
    bc_cold: float = 300.0
    bc_hot: float = 400.0
    init: float = 500.0
    dtype: str = "float32"    # the paper runs single precision

    # implicit-solve (wfa.solve) parameters — paper Eq. 3
    method: str = "cg"        # cg | pipecg | bicgstab | chebyshev | jacobi
    tol: float = 1e-6
    maxiter: int = 500

    @property
    def cells(self) -> int:
        return self.nx * self.ny * self.nz

    def smoke(self) -> "HeatConfig":
        return dataclasses.replace(self, nx=16, ny=16, nz=12)

    def paper_example(self) -> "HeatConfig":
        """The Fig. 3 script's 102×102×102 grid."""
        return dataclasses.replace(self, nx=102, ny=102, nz=102)


def make_field(cfg: HeatConfig):
    import numpy as np
    T = np.full((cfg.nx, cfg.ny, cfg.nz), cfg.init,
                dtype=np.dtype(cfg.dtype))
    T[1:-1, 1:-1, 0] = cfg.bc_cold
    T[1:-1, 1:-1, -1] = cfg.bc_hot
    return T


def record_heat(cfg: HeatConfig, steps: int, init=None):
    """Record the README's Fig. 3 explicit heat body with ``c = omega``;
    returns ``(wse, field)`` ready for ``wse.make(answer=field, ...)``.

    ``init`` overrides the initial field (default :func:`make_field`).
    """
    from repro_torch.core import Field, ForLoop, WFAInterface

    c = cfg.omega
    center = 1.0 - 6.0 * c
    wse = WFAInterface()
    T_n = Field("T_n", init_data=make_field(cfg) if init is None else init,
                dtype=init.dtype if init is not None else cfg.dtype)
    with ForLoop("time_loop", steps):
        T_n[1:-1, 0, 0] = center * T_n[1:-1, 0, 0] \
            + c * (T_n[2:, 0, 0] + T_n[:-2, 0, 0]
                   + T_n[1:-1, 1, 0] + T_n[1:-1, 0, -1]
                   + T_n[1:-1, -1, 0] + T_n[1:-1, 0, 1])
    return wse, T_n


def record_implicit(cfg: HeatConfig):
    """Record the config's BTCS system; returns ``(wse, field)`` ready for
    ``wse.solve(answer=field, method=cfg.method, tol=cfg.tol, ...)``."""
    from repro_torch.solver import record_btcs
    return record_btcs(make_field(cfg), cfg.omega)
