"""mfu.solve: the implicit march's operations over its host time, as a
percent of the float32 peak.  A solve of plain conjugate gradients needs,
per updated cell, the right-hand side (the ``btcs_rhs`` body), the first
residual (the operator and a subtraction), and per iteration the operator,
two dot products (2 each) and three vector updates (2 each); the
iterations are the solver's own counts."""
from fieldbench.yardstick import peaks, stencil


def read(run):
    cfg = run["cfg"]
    iters = run["counters"].get("iterations", [])
    if not iters:
        return None
    bodies = run["ref"].bodies(cfg)
    op = stencil.body_ops(bodies["btcs_operator"])
    rhs = stencil.body_ops(bodies["btcs_rhs"])
    per_cell = sum(rhs + op + 1 + it * (op + 2 * 2 + 3 * 2) for it in iters)
    flops = per_cell * stencil.interior_cells(run["ref"].shape(cfg))
    return 100.0 * flops / run["window_s"] / peaks.PEAK_FLOPS[cfg["dtype"]]
