"""``Field`` — the PyTorch port's analogue of the WFA's ``WSE_Array``.

A field is a named (X, Y, Z) array.  Its initial value is recorded as a host
NumPy array (the same value the JAX reference records, so both packages
start from identical data); the engine copies it to the plan's device when
the program runs.  Indexing with the paper's ``[zslice, dx, dy]`` convention
yields a lazy stencil term; assigning an expression records an update into
the active :class:`~repro_torch.core.program.Program`.

Example — the explicit heat step, verbatim from the paper's Fig. 3::

    wse = WFAInterface()
    T_n = Field('T_n', init_data=T_init)
    with ForLoop('time_loop', 40000):
        T_n[1:-1, 0, 0] = center * T_n[1:-1, 0, 0] \
            + c * (T_n[2:, 0, 0] + T_n[:-2, 0, 0]
                   + T_n[1:-1, 1, 0] + T_n[1:-1, 0, -1]
                   + T_n[1:-1, -1, 0] + T_n[1:-1, 0, 1])
    result = wse.make(answer=T_n)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import program as prog_mod
from repro_torch.core.stencil import StencilExpr, Term


def _norm_zslice(s) -> Tuple:
    if isinstance(s, slice):
        if s.step not in (None, 1):
            raise ValueError("strided z slices are not supported by the WFA")
        return (s.start, s.stop, None)
    raise TypeError("axis 0 of a Field index must be a slice (local Z cells)")


def _norm_offset(v, axis: str) -> int:
    if not isinstance(v, int):
        raise TypeError(
            f"axis {axis} of a Field index is a relative tile offset; got {v!r}"
        )
    return v


class Field:
    """A named field on the grid, stored as a global (X, Y, Z) array."""

    def __init__(self, name: str, init_data: Optional[np.ndarray] = None,
                 shape: Optional[Tuple[int, int, int]] = None,
                 dtype=np.float32):
        if init_data is None:
            if shape is None:
                raise ValueError("need init_data or shape")
            init_data = np.zeros(shape, dtype=dtype)
        init_data = np.asarray(init_data, dtype=dtype)
        if init_data.ndim != 3:
            raise ValueError("Fields are 3-D (X, Y, Z)")
        self.name = name
        self.shape = init_data.shape
        self.dtype = init_data.dtype
        self.init_data = init_data
        p = prog_mod.current_program()
        if p is not None:
            p.register_field(self)

    # -- the WFA indexing protocol ---------------------------------------
    def __getitem__(self, idx) -> Term:
        zs, dx, dy = self._parse(idx)
        return Term(self.name, zs, dx, dy)

    def __setitem__(self, idx, expr) -> None:
        zs, dx, dy = self._parse(idx)
        if dx != 0 or dy != 0:
            raise ValueError("updates must target the local tile (dx=dy=0)")
        if not isinstance(expr, StencilExpr):
            raise TypeError("rhs of a Field update must be a stencil expression")
        p = prog_mod.current_program()
        if p is None:
            raise RuntimeError(
                "Field updates must run inside a WFAInterface program context"
            )
        p.record_update(self, slice(*zs), expr)

    def _parse(self, idx):
        if not (isinstance(idx, tuple) and len(idx) == 3):
            raise TypeError("Field indices are [zslice, dx, dy]")
        return (_norm_zslice(idx[0]), _norm_offset(idx[1], "X"),
                _norm_offset(idx[2], "Y"))

    def __repr__(self):
        return f"Field({self.name!r}, shape={self.shape}, dtype={self.dtype})"
