"""repro_torch — the WFA field-equation interface on PyTorch and CUDA.

The PyTorch/H100 port of the JAX reference package ``repro``: the same
recording frontend (the paper's Fig. 3 API), IR, compiler and engine, with
every loop body of ``backend="pallas"`` running as the hand-written Hopper
kernel K1 (:mod:`repro_torch.kernels.fused`).  It imports neither JAX nor
``repro``.  Entry points run on the card by default
(``RunOptions(device="cuda")``); the caller asks for the host with
``RunOptions(device="cpu")``, where every kernel runs as its plain PyTorch
version.

>>> import numpy as np
>>> import repro_torch as wfa
>>> wse = wfa.WFAInterface()
>>> T = wfa.Field("T", init_data=np.ones((6, 6, 4), np.float32))
>>> with wfa.ForLoop("t", 2):
...     T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
>>> out = wfa.make(wse, T, options=wfa.RunOptions(backend="pallas",
...                                               device="cpu"))
>>> float(out[2, 2, 1])
0.25
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import Field, ForLoop, WFAInterface
from repro_torch.core.program import Program, release_program
from repro_torch.engine import RunOptions, stats
from repro_torch.solver import (NumericalFault, Operator, RecoveryPolicy, Rhs,
                                SolveInfo, solve)

__all__ = ["Field", "ForLoop", "NumericalFault", "Operator", "RecoveryPolicy",
           "Rhs", "RunOptions", "SolveInfo", "WFAInterface", "make", "solve",
           "stats"]


def make(target, answer, options=None) -> np.ndarray:
    """Module-level ``make``: run the program recorded by ``target`` (a
    :class:`WFAInterface` or :class:`Program`) and return ``answer``'s final
    value as a host NumPy array."""
    prog = target if isinstance(target, Program) else getattr(target, "program", None)
    if not isinstance(prog, Program):
        raise TypeError(
            f"make() expects a WFAInterface or Program; got {type(target).__name__}")
    if isinstance(target, WFAInterface):
        return target.make(answer=answer, options=options)
    from repro_torch.engine import run_program

    try:
        out = run_program(prog, options=options)
    finally:
        release_program(prog)
    return np.asarray(out[getattr(answer, "name", answer)])
