"""launches_per_step.make: device operations (kernels, copies, fills) in
the traced window per explicit step."""


def read(run):
    steps = run["work"].get("steps")
    ops = run["trace"]["device_ops"]
    return len(ops) / steps if steps and ops else None
