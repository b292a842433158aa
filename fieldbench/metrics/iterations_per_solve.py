"""iterations_per_solve: the mean inner iterations of a solve, from the
iteration counts the solver returns with every call."""
from fieldbench.readers import mean


def read(run):
    return mean(run["counters"].get("iterations", []))
