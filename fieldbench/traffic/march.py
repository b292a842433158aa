"""Implicit runs: a BTCS march (Eq. 3), ``steps_per_call`` steps a call.

A user marching many initial states through implicit time steps, one
after another: ``make_solver(btcs_program(...), method=...,
steps=steps_per_call)`` built in set-up, called back to back, each call
from a fresh initial state.  The seed gives ``fields`` states for the
window, taken in turn, and one more for the set-up's warm-up call, so every
call starts from seeded noise and no timed call repeats the warm-up.  Every
step is solved to ``tol_rel``·‖b₀‖ (‖b‖ of the first state); each implicit
step is one solve.

Workload keys: ``method``, ``steps_per_call``, ``fields``, ``tol_rel``,
``maxiter``, ``reference_tol_rel``, ``limit_K`` (the largest |x − x_ref|
in kelvin), ``limit_rel`` (the largest ‖x − x_ref‖/‖x_ref‖),
``trace_seconds``.
"""
from __future__ import annotations

import time

import numpy as np


def setup(ctx) -> dict:
    from repro_torch.solver import btcs_program, make_solver

    cfg, wl = ctx.cfg, ctx.wl
    *fields, warm = ctx.ref.initial_fields(cfg, ctx.seed, wl["fields"] + 1,
                                           ctx.device)
    tol = wl["tol_rel"] * ctx.ref.btcs_rhs_norm(fields[0], cfg["omega"])
    solver = make_solver(btcs_program(ctx.ref.shape(cfg), cfg["omega"]), "T",
                         method=wl["method"], backend="pallas", tol=tol,
                         maxiter=wl["maxiter"], steps=wl["steps_per_call"],
                         device=ctx.device)
    state = {"fields": fields, "solver": solver}
    solver(warm)  # warm-up: the same shapes
    return state


def window(ctx, state: dict, seconds: float) -> dict:
    from torch.profiler import record_function

    solver, fields = state["solver"], state["fields"]
    t0 = time.perf_counter()
    calls, iters, outcomes = 0, [], []
    while True:
        x = fields[calls % len(fields)]
        with record_function("fieldbench.solve"):
            out, (it, _, oc) = solver(x)
        calls += 1
        iters.extend(int(i) for i in np.ravel(it))
        outcomes.extend(int(o) for o in np.ravel(oc))
        if calls == 1:
            state["first_out"] = out
        state["tail"] = state.get("tail", [])[-1:] + [(x, out)]
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    solves = calls * ctx.wl["steps_per_call"]
    ctx.counters["iterations"] = iters
    state["outcomes"] = outcomes
    return {"attempted": solves,
            "failed": sum(o != 0 for o in outcomes),
            "e2e": {"solve_ms": wall * 1e3 / solves},
            "work": {"solves": solves, "calls": calls,
                     "bodies": ["btcs_operator", "btcs_rhs"]}}


def _reference(ctx, start, dtype_name: str, tol_rel: float):
    import torch

    x, _, _ = ctx.ref.btcs_march(
        start.to(getattr(torch, dtype_name)), ctx.cfg["omega"],
        ctx.wl["steps_per_call"], tol_rel, ctx.wl["maxiter"])
    return x


def _gaps(ctx, start, got) -> tuple:
    """``(|got − x_ref| at its largest, in kelvin, ‖got − x_ref‖ /
    ‖x_ref‖)`` in float64, the reference marched from ``start`` in the
    reference's precision to ``reference_tol_rel``."""
    import torch

    want = _reference(ctx, start, ctx.reference_dtype,
                      ctx.wl["reference_tol_rel"]).double()
    got = torch.as_tensor(got).to(device=want.device, dtype=torch.float64)
    return (float((got - want).abs().max()),
            float(torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want)))


def _named(first, last) -> list:
    """The first call's two gaps and the worse of the last calls'."""
    return [("max_abs_K.first_call", first[0]), ("rel_gap.first_call", first[1]),
            ("max_abs_K.last_calls", max(g[0] for g in last)),
            ("rel_gap.last_calls", max(g[1] for g in last))]


def check(ctx, state: dict) -> list:
    """The window's first call and the worse of its last two, each from the
    seeded state it started from, against the reference marched from that
    state: a fault that strikes every other call shows in one of the two."""
    first, tail = (state["fields"][0], state["first_out"]), state["tail"]
    not_converged = sum(o != 0 for o in state["outcomes"])
    state.clear()
    lim = {"max_abs_K": ctx.wl["limit_K"], "rel_gap": ctx.wl["limit_rel"]}
    named = _named(_gaps(ctx, *first), [_gaps(ctx, *c) for c in tail])
    return [(n, v, lim[n.split(".")[0]]) for n, v in named] + \
        [("not_converged", not_converged, 0)]


def control(ctx) -> list:
    """The comparisons of two calls with the plain march in the control's
    precision, at the program's tolerance, in the program's place: from the
    first seeded state, and from the second, which stands for the last
    two."""
    fields = ctx.ref.initial_fields(ctx.cfg, ctx.seed, 2, ctx.device)
    gaps = [_gaps(ctx, f, _reference(ctx, f, ctx.control_dtype,
                                     ctx.wl["tol_rel"])) for f in fields]
    return _named(gaps[0], gaps[1:])
