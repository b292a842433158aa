"""repro_torch — the WFA field-equation interface on PyTorch and CUDA.

The PyTorch/H100 port of the JAX reference package ``repro``: the same
recording frontend (the paper's Fig. 3 API), IR, compiler and engine, with
every loop body of ``backend="pallas"`` running as the hand-written Hopper
kernel K1 (:mod:`repro_torch.kernels.fused`).  It imports neither JAX nor
``repro``.  Entry points run on the card by default
(``RunOptions(device="cuda")``); the caller asks for the host with
``RunOptions(device="cpu")``, where every kernel runs as its plain PyTorch
version.  :class:`Ensemble` stacks B scenarios behind one program; ``make``
and ``solve`` accept it and advance all members per kernel launch
(:mod:`repro_torch.core.ensemble`).  ``RunOptions(mesh=make_mesh(...))``
and :func:`run_sharded` run a program on a brick mesh
(:mod:`repro_torch.core.mesh`, :mod:`repro_torch.core.halo`), one process
driving every brick.  ``RunOptions(check_finite=N, recovery=…)`` guards a
run's numerical health, and :func:`make_differentiable_solver` /
``engine.differentiable_runner`` put ``torch.autograd`` through a solve or
a time loop.

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

from repro_torch.core import Field, ForLoop, WFAInterface
from repro_torch.core.ensemble import Ensemble, make, solve
from repro_torch.core.halo import run_sharded
from repro_torch.engine import RunOptions, stats
from repro_torch.solver import (NumericalFault, Operator, RecoveryPolicy, Rhs,
                                SolveInfo, make_differentiable_solver)

__all__ = ["Ensemble", "Field", "ForLoop", "NumericalFault", "Operator",
           "RecoveryPolicy", "Rhs", "RunOptions", "SolveInfo", "WFAInterface",
           "make", "make_differentiable_solver", "run_sharded", "solve",
           "stats"]
