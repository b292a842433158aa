"""device_idle.solve: percent of the traced window in which no operation ran
on the device."""
from fieldbench.readers import idle_percent


def read(run):
    return idle_percent(run)
