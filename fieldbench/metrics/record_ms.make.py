"""record_ms.make: the mean host time to record one ``make`` call's
program with the frontend (``Field``, ``ForLoop``, ``WFAInterface``),
timed by the harness around the recording."""
from fieldbench.readers import mean


def read(run):
    m = mean(run["spans"].get("record", []))
    return None if m is None else 1e3 * m
