"""mfu.make: the window's stencil operations over its host time, as a
percent of the float32 peak: Fig. 3's body applied to the grid once a step
(8 operations an updated cell).  The least bytes any implementation needs
(each field read and written once a call) are far below this bound at
these call lengths, so no change of schedule can lift it past 100 %."""
from fieldbench.yardstick import peaks, stencil


def read(run):
    cfg = run["cfg"]
    steps = run["work"].get("steps")
    if not steps:
        return None
    flops = steps * stencil.apply_flops(run["ref"].shape(cfg),
                                        run["ref"].bodies(cfg)["ftcs"])
    return 100.0 * flops / run["window_s"] / peaks.PEAK_FLOPS[cfg["dtype"]]
