"""Explicit runs: back-to-back ``WFAInterface.make`` calls of Fig. 3's body.

A scientist's explicit run that writes its field out every
``steps_per_call`` steps: each call records Fig. 3's heat body with the
port's frontend (``Field``, ``ForLoop``, ``WFAInterface``), starting from
the field the previous call returned, and runs it with
``RunOptions(backend="pallas")`` and its defaults otherwise.  The seed
gives two fields: the window's first call starts from the first, and the
set-up's warm-up call from the second, so no timed call repeats it.

Workload keys: ``steps_per_call``, ``limit_K`` (the largest |program −
reference| in kelvin), ``trace_seconds``.
"""
from __future__ import annotations

import time

import numpy as np


def record(cfg: dict, steps: int, init: np.ndarray):
    """Fig. 3's script: the heat body with c = ω over ``steps`` steps."""
    from repro_torch import Field, ForLoop, WFAInterface

    c = cfg["omega"]
    center = 1.0 - 6.0 * c
    wse = WFAInterface()
    T_n = Field("T_n", init_data=init, dtype=init.dtype)
    with ForLoop("time_loop", steps):
        T_n[1:-1, 0, 0] = center * T_n[1:-1, 0, 0] \
            + c * (T_n[2:, 0, 0] + T_n[:-2, 0, 0]
                   + T_n[1:-1, 1, 0] + T_n[1:-1, 0, -1]
                   + T_n[1:-1, -1, 0] + T_n[1:-1, 0, 1])
    return wse, T_n


def setup(ctx) -> dict:
    from repro_torch import RunOptions

    init, warm = (f.cpu().numpy() for f in
                  ctx.ref.initial_fields(ctx.cfg, ctx.seed, 2, ctx.device))
    state = {"init": init,
             "options": RunOptions(backend="pallas", device=ctx.device)}
    call(ctx, state, warm, spans=False)  # warm-up: the same shapes
    return state


def call(ctx, state, field: np.ndarray, spans: bool = True) -> np.ndarray:
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function("fieldbench.record"):
        wse, T = record(ctx.cfg, ctx.wl["steps_per_call"], field)
    t1 = time.perf_counter()
    with record_function("fieldbench.make"):
        out = wse.make(answer=T, options=state["options"])
    if spans:
        ctx.span("record", t1 - t0)
        ctx.span("make", time.perf_counter() - t1)
    return out


def window(ctx, state: dict, seconds: float) -> dict:
    t0 = time.perf_counter()
    field, calls = state["init"], 0
    while True:
        out = call(ctx, state, field)
        calls += 1
        if calls == 1:
            state["first_out"] = out
        state["tail"] = state.get("tail", [])[-1:] + [(field, out)]
        field = out
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    steps = calls * ctx.wl["steps_per_call"]
    return {"attempted": calls, "failed": 0,
            "e2e": {"step_ms": wall * 1e3 / steps},
            "work": {"steps": steps, "calls": calls, "bodies": ["ftcs"]}}


def _gap(ctx, start: np.ndarray, got) -> float:
    """max |got − reference| in kelvin, the reference stepped from
    ``start`` in the reference's precision."""
    import torch

    dt = getattr(torch, ctx.reference_dtype)
    T = torch.as_tensor(start, device=ctx.device).to(dt)
    want = ctx.ref.ftcs(T, ctx.cfg["omega"], ctx.wl["steps_per_call"])
    got = torch.as_tensor(got, device=ctx.device).to(torch.float64)
    return float((got - want.double()).abs().max())


def check(ctx, state: dict) -> list:
    """The window's first call, from the seed's field, and the worse of its
    last two, each from the field the call before it returned, against the
    reference stepped from the same field: a fault that strikes every
    other call shows in one of the two."""
    first, tail = (state["init"], state["first_out"]), state["tail"]
    state.clear()
    lim = ctx.wl["limit_K"]
    return [("max_abs_K.first_call", _gap(ctx, *first), lim),
            ("max_abs_K.last_calls", max(_gap(ctx, *c) for c in tail), lim)]


def control(ctx) -> list:
    """The comparisons of the first two calls with the plain reference in
    the control's precision in the program's place: the second, from the
    field the first returned, stands for the last two."""
    import torch

    low = getattr(torch, ctx.control_dtype)
    steps = ctx.wl["steps_per_call"]
    init = ctx.ref.initial_fields(ctx.cfg, ctx.seed, 1, ctx.device)[0]
    first = ctx.ref.ftcs(init.to(low), ctx.cfg["omega"], steps)
    second = ctx.ref.ftcs(first, ctx.cfg["omega"], steps)
    first = first.float().cpu().numpy()
    return [("max_abs_K.first_call", _gap(ctx, init.cpu().numpy(), first)),
            ("max_abs_K.last_calls", _gap(ctx, first, second))]
