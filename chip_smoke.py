#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. ``build``           — builds every kernel of the main paths from
                         ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
                         one nvcc per source, all started together;
2. ``kernel_vs_ref``   — holds K1 bitwise against its plain PyTorch version
                         on the card, at float32 and float64: the heat3d body
                         at its full main-path shapes (k = 1 and the auto
                         tile), and a small multi-field, off-axis,
                         multi-update body at k = 1, k = 2, and through
                         ``make`` with a remainder launch;
3. ``dual_dot_vs_ref`` — K2 on 512×512×128 float32 and float64 operands,
                         distinct and aliased as pipelined CG passes them,
                         within ``1e-5·Σ|aᵢbᵢ|`` (f32) / ``1e-13·Σ|aᵢbᵢ|``
                         (f64) of the plain version evaluated in float64,
                         and bitwise deterministic;
4. ``transfer_vs_ref`` — K3 and K4 bitwise against their plain versions at
                         every level pair of the 512×512×128 hierarchy, at
                         float32 and float64;
5. ``heat3d``          — ``HeatConfig()`` (512×512×128 float32) through
                         ``make(backend="pallas")`` at ``time_tile=1`` and at
                         the auto pick, checked against each other and against
                         the ``jit`` roll interpreter on the card, with K1's
                         launch count equal to the engine's; ms per step by
                         CUDA events after a warm-up, beside the bytes bound;
6. ``solve_heat3d``    — ``record_implicit(HeatConfig())`` through
                         ``solve(backend="pallas")`` with ``cg``, ``pipecg``
                         and ``cg`` + ``precondition="mg"`` at
                         ``tol = 1e-5·‖b‖``: the outcome word, iterations,
                         K1–K4 launches, an independent float64 residual,
                         the difference from ``backend="jit"``, ms per solve
                         and per iteration, the device time by kernel and
                         the device idle share;
7. ``mg_poisson``      — ``record_poisson`` at 512×512×128 with a unit-norm
                         random interior right-hand side from ``--seed``,
                         ``method="mg"`` and ``cg`` + ``precondition="mg"``;
8. ``legacy_kernels_vs_ref`` — K6 and K7 bitwise against their plain
                         versions at float32 and float64: K6 on the padded
                         514×514×128 brick (1×1 mesh), the padded 258×258×128
                         brick (2×2 mesh) and the reference's test shapes, K7
                         with random planes on the 1×1 mesh's brick and on
                         each brick of a 2×2 mesh; K5's ``Ap`` bitwise and its
                         dot within ``1e-5·Σ|c·Ap|`` (f32) / ``1e-13·Σ|c·Ap|``
                         (f64) of the plain version in float64, and bitwise
                         deterministic, on the same bricks;
9. ``legacy_ftcs``     — ``HeatConfig()`` through ``make_sharded_ftcs`` with
                         all five variants on a 1×1 mesh, then a random field
                         from ``--seed`` on 1×1 and 2×2 meshes: every variant
                         and mesh bitwise equal, ``ftcs_solve`` within 1 f32
                         ulp of the field per step, K6/K7 launched once per
                         brick per step; ms per step and device idle share;
10. ``legacy_btcs``    — ``make_sharded_iteration`` (cg, pipecg, chebyshev;
                         with and without kernels; 1×1 and 2×2 meshes) from a
                         seeded 512×512×128 state for 20 iterations: kernel
                         vs plain and 2×2 vs 1×1 within 4 f32 ulp of the field
                         per iteration and their recurrence scalars within
                         1e-4 relative — cg and pipecg at their last iteration
                         with ‖r‖ above 1e-6·‖r₀‖, chebyshev bitwise at the
                         20th — one K5 per brick per iteration
                         and one K2 per brick per pipecg iteration; ms per
                         iteration; one ``btcs_solve`` cg step with its
                         independent float64 residual;
11. ``kernels``        — one JSON line describing every kernel of the paths.

Each main path (``heat3d``, ``solve_heat3d``, ``mg_poisson``, ``legacy_ftcs``,
``legacy_btcs``) runs with the launch counters set to 0 just before it and
read just after, and fails if one of its kernels was not launched.  Then the card's name and power limit,
and last the result line.  Any failed check raises: the script exits
non-zero and prints no result line.  Without a CUDA device it exits
non-zero before printing anything.

    python3 chip_smoke.py [--steps 200] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM device-memory rate and float32 / float64 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: the kernel libraries of the main paths (csrc/<stem>.cu)
LIBRARIES = ("fused_stencil", "dual_dot", "transfer", "stencil7")
#: K2 vs the plain version in float64: |K2 − exact| ≤ REL · Σ|aᵢbᵢ|.  The
#: kernel sums 32 terms per thread, then a 256-thread tree, then the block
#: partials: about 50 roundings deep, so 50·u (u = 6e-8 at f32, 1.1e-16 at
#: f64) on the sum of magnitudes, with margin
K2_REL = {"float32": 1e-5, "float64": 1e-13}
#: the implicit tolerance, relative to ‖b‖ (HeatConfig().tol = 1e-6 is an
#: absolute bound that a float32 solve on Kelvin-scale data cannot reach)
SOLVE_REL_TOL = 1e-5
#: the jit roll interpreter vs the fused kernel on Kelvin-scale fields.  The
#: two sum the taps in different orders (recorded vs canonical), so they
#: drift apart by rounding: within 2e-4 over a short run (the bound the
#: reference documents for its backends), and within one float32 ulp of the
#: field's magnitude per step over a long one
JIT_SHORT_STEPS = 16
JIT_SHORT_ATOL = 2e-4
#: a solve on ``backend="pallas"`` vs the same solve on ``"jit"``: the two
#: sum the operator's taps (K1 vs the roll interpreter) and the dots (K2 vs
#: torch) in different orders, so each iteration's update of the solution
#: may round differently; over the same number of iterations they stay
#: within this many float32 ulp of the field's magnitude per iteration
SOLVE_JIT_ULPS = 4
#: K5's dot vs the plain version in float64: |K5 − exact| ≤ REL · Σ|c·Ap|
#: (one product per cell, a 256-thread tree per block, then torch.sum over
#: the partials: shallower than K2's sum, so K2's bound holds)
K5_REL = K2_REL
#: the legacy Krylov iterations of each make_sharded_iteration run
LEGACY_ITERS = 20
#: make_sharded_iteration, kernel vs plain and 2×2 vs 1×1: the dots sum in
#: other orders, so each iteration's update may round differently, within
#: this many float32 ulp of the field's magnitude per iteration, and the
#: recurrence scalars (rr, γ, α) within ITER_SCALAR_REL of each other
ITER_ULPS = 4
ITER_SCALAR_REL = 1e-4
#: CG's and pipelined CG's float32 recurrences lose their accuracy once ‖r‖
#: falls below about this share of ‖r₀‖ (16 u), and the iteration harness,
#: unlike the solver, never replaces the residual: from there two dot orders
#: may drift apart without bound (at ``--seed 0`` pipecg's recurrence ‖r‖
#: climbs back from 8e-8·‖r₀‖ at iteration 10 to 4e-6 at 13; the
#: legacy_btcs line records each method's ‖r‖ history and each pair's
#: difference at the last iteration).  So both are compared at the last
#: iteration before ‖r‖ first falls to this floor, where a wrong dot would
#: still show
KRYLOV_FLOOR = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn()`` over ``repeats`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def body_ops(kernel) -> int:
    """Floating-point operations one sub-step of ``kernel``'s body needs per
    output (x, y) cell, summed over its updates' z windows."""
    total = 0
    for u in kernel.updates:
        groups = {}
        for coeff, taps in u.terms:
            groups.setdefault(coeff, []).append(taps)
        per = 0
        for coeff, prods in groups.items():
            per += sum(len(t) - 1 for t in prods) + len(prods) - 1
            per += coeff != 1.0
        per += max(len(groups) - 1, 0) + (u.const != 0.0 and bool(groups))
        total += per * u.zlen
    return total


def bound_ms(kernel, dtype_name: str) -> tuple:
    """(least ms, "bytes" | "operations") for one launch of ``kernel``: each
    padded input read once and each output written once, against the
    body's operations on the interior cells of k sub-steps."""
    itemsize = 4 if dtype_name == "float32" else 8
    ph = kernel.pad
    nbytes = 0
    for name, nz in zip(kernel.in_names, kernel.nz):
        nbytes += (kernel.bx + 2 * ph) * (kernel.by + 2 * ph) * nz * itemsize
        if name in kernel.written:
            nbytes += kernel.bx * kernel.by * nz * itemsize
    ops = kernel.k * (kernel.nx - 2) * (kernel.ny - 2) * body_ops(kernel)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_coupled(mod, A0, C0, B0, steps):
    """A small multi-field, off-axis, multi-update body: advection–diffusion
    of A with a variable-coefficient cross term (2-tap products), B reading
    A's new value at dz = ±1, and A re-written from its own new value at
    dz = -1 (the kernel's in-place hazard path)."""
    wse = mod.WFAInterface()
    A = mod.Field("A", init_data=A0, dtype=A0.dtype)
    C = mod.Field("C", init_data=C0, dtype=C0.dtype)
    B = mod.Field("B", init_data=B0, dtype=B0.dtype)
    with mod.ForLoop("t", steps):
        A[1:-1, 0, 0] = A[1:-1, 0, 0] \
            + 0.05 * (A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0]
                      + A[1:-1, -1, 0] + A[1:-1, 0, 1] + A[1:-1, 0, -1]
                      - 6.0 * A[1:-1, 0, 0]) \
            - 0.1 * (A[1:-1, 0, 0] - A[1:-1, -1, 0]) \
            + C[1:-1, 0, 0] * (A[1:-1, 1, 1] + A[1:-1, -1, -1]
                               - 2.0 * A[1:-1, 0, 0])
        B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (A[2:, 0, 0]
                                                     + A[:-2, 0, 0]) + 0.125
        A[2:-1, 0, 0] = A[2:-1, 0, 0] - 0.01 * A[1:-2, 0, 0]
    return wse, A, B


def record_wide(mod, P0, Q0, R0, steps):
    """Edge cases: halo 2, fields of different nz in one body, a 2-tap
    product across them, a constant-only update, and a halo-free field."""
    wse = mod.WFAInterface()
    P = mod.Field("P", init_data=P0, dtype=P0.dtype)
    Q = mod.Field("Q", init_data=Q0, dtype=Q0.dtype)
    R = mod.Field("R", init_data=R0, dtype=R0.dtype)
    with mod.ForLoop("t", steps):
        P[1:-1, 0, 0] = 0.3 * P[1:-1, 0, 0] + 0.2 * (
            P[1:-1, 2, 0] + P[1:-1, -2, 1]) + Q[:, 0, 0] * Q[:, 1, -2]
        Q[2:5, 0, 0] = 0.0 * Q[2:5, 0, 0] + 1.5
        R[1:-1, 0, 0] = 0.5 * R[2:, 0, 0] + 0.5 * R[:-2, 0, 0]
    return wse


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_libraries(LIBRARIES)
    ptxas = {stem: [ln.strip() for ln in build.build_log.get(stem, "").splitlines()
                    if "Used" in ln or "spill" in ln] for stem in LIBRARIES}
    emit({"phase": "build", "libraries": list(LIBRARIES),
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {s: build.build_seconds[s] for s in LIBRARIES},
          "ptxas": ptxas})


def _build_kernel(program_ops, shapes, dtypes, k, device):
    from repro_torch.compiler.codegen import _field_specs
    from repro_torch.compiler.ir import lower_group
    from repro_torch.kernels.fused import build_fused_call

    group = lower_group(program_ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    kernel, _ = build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                 ny, time_tile=k, wrap=True, device=device)
    return kernel


def _padded_inputs(kernel, env, device):
    import torch

    from repro_torch.compiler.codegen import _wrap_pad

    return [_wrap_pad(torch.tensor(env[n], device=device), kernel.pad)
            if kernel.pad else torch.tensor(env[n], device=device)
            for n in kernel.in_names]


def compare_kernel(kernel, padded):
    """K1 vs fused_step_ref on the same card inputs: max |diff| (must be 0)."""
    import torch

    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    got = launch_fused(kernel, padded)
    want = fused_step_ref(kernel, padded)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("K1 produced non-finite values")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(g, w):
            raise AssertionError(f"K1 differs from fused_step_ref (max {err})")
    return err


def small_body_cases():
    """K1 vs its plain version on small bodies that reach every branch of
    the kernel, and ``make`` on the card vs ``make`` on the CPU with a
    remainder launch."""
    import numpy as np

    import repro_torch as rt
    from repro_torch.engine import RunOptions
    from repro_torch.kernels.fused import launch_fused

    cases = []
    rng = np.random.default_rng(0)
    shape = (37, 29, 11)   # ragged against every tile size
    for dtype in (np.float32, np.float64):
        A0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
        C0 = rng.uniform(0.0, 0.05, shape).astype(dtype)
        B0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
        env = {"A": A0, "C": C0, "B": B0}
        wide = {"P": rng.uniform(0.0, 1.0, (20, 23, 9)).astype(dtype),
                "Q": rng.uniform(0.0, 0.1, (20, 23, 7)).astype(dtype),
                "R": rng.uniform(0.0, 1.0, (20, 23, 6)).astype(dtype)}
        bodies = (
            ("coupled_advdiff", env,
             lambda: record_coupled(rt, A0, C0, B0, 4)[0]),
            ("wide_halo2_mixed_nz", wide,
             lambda: record_wide(rt, wide["P"], wide["Q"], wide["R"], 4)))
        for body, body_env, record in bodies:
            wse = record()
            prog = wse.program
            wse.__exit__()
            shapes = {n: f.shape for n, f in prog.fields.items()}
            dtypes = {n: f.dtype for n, f in prog.fields.items()}
            for k in (1, 2):
                kern = _build_kernel(prog.ops, shapes, dtypes, k, "cuda")
                err = compare_kernel(
                    kern, _padded_inputs(kern, body_env, "cuda"))
                cases.append({"body": body,
                              "shape": list(shapes[kern.in_names[0]]),
                              "dtype": np.dtype(dtype).name, "k": k,
                              "halo": kern.halo, "hazard": kern.hazard,
                              "max_abs_err": err})
        # through make, on the card and on the CPU: 5 steps at k=2 = 2 tiled
        # launches + 1 remainder
        outs = {}
        for device in ("cuda", "cpu"):
            wse, A, B = record_coupled(rt, A0, C0, B0, 5)
            before = launch_fused.launches
            outs[device] = wse.make(answer=A, options=RunOptions(
                backend="pallas", time_tile=2, device=device))
            if device == "cuda" and launch_fused.launches - before != 3:
                raise AssertionError("expected 2 tiled + 1 remainder launch")
        if not np.array_equal(outs["cuda"], outs["cpu"]):
            raise AssertionError("make on the card differs from make on the CPU")
        cases.append({"body": "coupled_advdiff", "path": "make", "steps": 5,
                      "time_tile": 2, "dtype": np.dtype(dtype).name,
                      "devices": ["cuda", "cpu"],
                      "max_abs_err": float(np.abs(
                          outs["cuda"].astype(np.float64) - outs["cpu"]).max())})
    return cases


def phase_kernel_vs_ref(steps_heat: int):
    import torch

    from repro_torch.compiler.ir import auto_tile, lower_group
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_heat

    dev = torch.device("cuda")
    cases = []
    cfg = HeatConfig()
    heat = {}
    for dtype in ("float32", "float64"):
        c = HeatConfig(dtype=dtype)
        wse, T = record_heat(c, steps_heat)
        ops = wse.program.ops
        shapes = {"T_n": T.shape}
        dtypes = {"T_n": T.dtype}
        wse.__exit__()
        k_auto = auto_tile(lower_group(ops), (c.nx, c.ny), steps_heat)
        for k in sorted({1, k_auto}):
            kern = _build_kernel(ops, shapes, dtypes, k, dev)
            padded = _padded_inputs(kern, {"T_n": make_field(c)}, dev)
            err = compare_kernel(kern, padded)
            cases.append({"body": "heat3d", "shape": [c.nx, c.ny, c.nz],
                          "dtype": dtype, "k": k, "max_abs_err": err})
            if dtype == cfg.dtype and k == 1:
                heat = {"kernel": kern, "padded": padded, "err": err}
    cases += small_body_cases()
    emit({"phase": "kernel_vs_ref", "tolerance": "bitwise", "cases": cases})
    return heat


def phase_heat3d(steps: int, heat):
    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, reset_stats, single_runner, stats
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    outs, runs = {}, []
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    compiler.clear_cache()
    reset_stats()
    launch_fused.launches = 0
    for tag, tt in (("k1", 1), ("auto", None)):
        wse, T = record_heat(cfg, steps)
        before = (launch_fused.launches, stats.launches)
        outs[tag] = wse.make(answer=T, options=RunOptions(backend="pallas",
                                                          time_tile=tt))
        runs.append({"run": tag, "time_tile": stats.max_time_tile,
                     "k1_launches": launch_fused.launches - before[0],
                     "engine_launches": stats.launches - before[1]})
    main_launches = launch_fused.launches
    fallbacks = compiler.stats.fallbacks
    engine_launches = stats.launches
    # -----------------------------------------------------------------------
    wse, T = record_heat(cfg, steps)
    outs["jit"] = wse.make(answer=T, options=RunOptions(backend="jit"))
    short = {}
    for backend in ("pallas", "jit"):
        wse, T = record_heat(cfg, min(steps, JIT_SHORT_STEPS))
        short[backend] = wse.make(answer=T, options=RunOptions(
            backend=backend, time_tile=1))
    if fallbacks != 0:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the main path")
    if main_launches == 0 or main_launches != engine_launches:
        raise AssertionError(f"K1 launches {main_launches} != engine launches "
                             f"{engine_launches}")
    for tag, out in outs.items():
        if out.shape != (cfg.nx, cfg.ny, cfg.nz) or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: bad shape {out.shape} or non-finite")
    auto_err = float(np.abs(outs["k1"].astype(np.float64) - outs["auto"]).max())
    if not np.array_equal(outs["k1"], outs["auto"]):
        raise AssertionError(f"time_tile=1 and the auto tile disagree "
                             f"(max {auto_err})")
    short_err = float(np.abs(short["pallas"].astype(np.float64)
                             - short["jit"]).max())
    if short_err > JIT_SHORT_ATOL:
        raise AssertionError(f"pallas vs jit over {JIT_SHORT_STEPS} steps: "
                             f"{short_err} > {JIT_SHORT_ATOL}")
    jit_err = float(np.abs(outs["k1"].astype(np.float64) - outs["jit"]).max())
    jit_atol = steps * float(np.spacing(np.abs(outs["jit"]).max()))
    if jit_err > jit_atol:
        raise AssertionError(f"pallas vs jit over {steps} steps: {jit_err} > "
                             f"{jit_atol} (1 ulp per step)")

    # --- timing: whole runs on device tensors, CUDA events --------------
    timing = {}
    for tag, opts in (("k1", RunOptions(backend="pallas", time_tile=1)),
                      ("auto", RunOptions(backend="pallas")),
                      ("jit", RunOptions(backend="jit"))):
        wse, T = record_heat(cfg, steps)
        p = plan(wse.program, opts)
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"T_n": T.init_data}, "cuda")
        ms = cuda_time_ms(lambda: run(env), repeats=3)
        timing[tag] = {"ms_per_step": ms / steps,
                       "time_tile": p.segments[0].time_tile,
                       **device_breakdown(lambda: run(env))}
    kern, padded = heat["kernel"], heat["padded"]
    k1_ms = cuda_time_ms(lambda: launch_fused(kern, padded), repeats=20)
    plain_ms = cuda_time_ms(lambda: fused_step_ref(kern, padded), repeats=5)
    b_ms, b_by = bound_ms(kern, cfg.dtype)
    emit({"phase": "heat3d", "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "steps": steps, "runs": runs,
          "fallbacks": fallbacks, "k1_launches": main_launches,
          "engine_launches": engine_launches,
          "k1_vs_auto_max_abs_err": auto_err,
          "pallas_vs_jit": {"steps": steps, "max_abs_err": jit_err,
                            "atol": jit_atol},
          "pallas_vs_jit_short": {"steps": min(steps, JIT_SHORT_STEPS),
                                  "max_abs_err": short_err,
                                  "atol": JIT_SHORT_ATOL},
          "timing": timing,
          "bound_ms_per_step_k1": b_ms, "bound_by": b_by,
          "k1_kernel_ms": k1_ms, "k1_plain_ms": plain_ms})
    return {"launches": main_launches, "err": heat["err"], "ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


# ---------------------------------------------------------------------------
# slice 2: K2, K3, K4 and the implicit solves
# ---------------------------------------------------------------------------

def kernel_counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from repro_torch.kernels.dotprod import launch_dual_dot
    from repro_torch.kernels.fused import launch_fused
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict

    from repro_torch.kernels.spmv import launch_spmv_dot
    from repro_torch.kernels.stencil7 import launch_stencil7, launch_stencil_planes

    return {"K1": launch_fused, "K2": launch_dual_dot, "K3": launch_restrict,
            "K4": launch_prolong, "K5": launch_spmv_dot, "K6": launch_stencil7,
            "K7": launch_stencil_planes}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


def phase_dual_dot_vs_ref(seed: int):
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases, main = [], {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        a, b, c, d = (torch.randn(shape, device="cuda", generator=g, dtype=dtype)
                      for _ in range(4))
        # pipelined CG passes (r, r, w, r) and PCG (r, z, r, r): two distinct
        # operands, the main path's case
        for label, ops4 in (("distinct", (a, b, c, d)), ("aliased_rrwr", (a, a, b, a))):
            got = ops.dual_dot(*ops4)
            again = ops.dual_dot(*ops4)
            exact = dual_dot_ref(*(t.double() for t in ops4))
            scale = torch.stack([(ops4[0].double() * ops4[1]).abs().sum(),
                                 (ops4[2].double() * ops4[3]).abs().sum()])
            err = (got.double() - exact).abs()
            ratio = float((err / scale).max())
            if not torch.equal(got, again):
                raise AssertionError(f"K2 is not deterministic ({name}, {label})")
            if not bool(torch.isfinite(got).all()) or ratio > K2_REL[name]:
                raise AssertionError(f"K2 {name} {label}: |err|/Σ|ab| = {ratio} > "
                                     f"{K2_REL[name]}")
            cases.append({"dtype": name, "operands": label,
                          "max_abs_err": float(err.max()),
                          "err_over_sum_abs": ratio, "bound": K2_REL[name]})
            if dtype == torch.float32 and label == "aliased_rrwr":
                main = {"ops": ops4, "err": float(err.max())}
    a, _, b, _ = main["ops"]
    ops4 = main["ops"]
    ms = cuda_time_ms(lambda: launch_dual_dot(*ops4), repeats=50)
    wrapper_ms = cuda_time_ms(lambda: ops.dual_dot(*ops4), repeats=50)
    plain_ms = cuda_time_ms(lambda: dual_dot_ref(*ops4), repeats=20)
    lib_ms = cuda_time_ms(lambda: (torch.dot(a.view(-1), a.view(-1)),
                                   torch.dot(b.view(-1), a.view(-1))), repeats=50)
    n = a.numel()
    blocks = -(-n // 8192)
    nbytes = 2 * n * 4 + blocks * 2 * 4       # two distinct operands + partials
    b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                     (4 * n / PEAK_FLOPS["float32"] * 1e3, "operations"))
    emit({"phase": "dual_dot_vs_ref", "shape": list(shape),
          "tolerance": "|K2 - dual_dot_ref(f64)| <= rel * sum|a_i b_i|",
          "cases": cases, "timed": "float32, (r, r, w, r)",
          "k2_ms": ms, "k2_with_partial_sum_ms": wrapper_ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
          "bound_bytes": nbytes, "distinct_operands": 2})
    return {"err": main["err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def hierarchy_shapes(shape):
    """The fine shapes of every level pair of ``shape``'s hierarchy."""
    from repro_torch.compiler.ir import coarsen_shape, coarsenable

    out = []
    while coarsenable(shape):
        out.append(tuple(shape))
        shape = coarsen_shape(shape)
    return out


def transfer_ops(fine, coarse):
    """Operations of the plain separable transfers for one level pair:
    restriction 4 per x/y/z-pass output, prolongation 2 per odd (averaged)
    pass output."""
    m = [n // 2 - 1 for n in fine]
    (nx, ny, nz), (cx, cy, cz) = fine, coarse
    r_ops = 4 * (m[0] * ny * nz + m[0] * m[1] * nz + m[0] * m[1] * m[2])
    p_ops = 2 * ((m[0] + 1) * cy * cz + nx * (m[1] + 1) * cz + nx * ny * (m[2] + 1))
    return r_ops, p_ops


def phase_transfer_vs_ref(seed: int):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.compiler.ir import coarsen_shape
    from repro_torch.kernels.transfer import (launch_prolong, launch_restrict,
                                              prolong_ref, restrict_ref)

    cfg = HeatConfig()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    pairs = []
    for dtype in (torch.float32, torch.float64):
        for fine in hierarchy_shapes((cfg.nx, cfg.ny, cfg.nz)):
            coarse = coarsen_shape(fine)
            f = torch.randn(fine, device="cuda", generator=g, dtype=dtype)
            c = torch.randn(coarse, device="cuda", generator=g, dtype=dtype)
            errs = []
            for kern, plain in ((launch_restrict(f), restrict_ref(f)),
                                (launch_prolong(c, fine), prolong_ref(c, fine))):
                torch.cuda.synchronize()
                errs.append(float((kern.double() - plain.double()).abs().max()))
                if not torch.equal(kern, plain):
                    raise AssertionError(f"K3/K4 differ from the plain version at "
                                         f"{fine} {dtype} (max {errs[-1]})")
            pairs.append({"fine": list(fine), "coarse": list(coarse),
                          "dtype": str(dtype).removeprefix("torch."),
                          "k3_max_abs_err": errs[0], "k4_max_abs_err": errs[1]})
    # time at the finest pair, float32 (the main path's)
    fine = (cfg.nx, cfg.ny, cfg.nz)
    coarse = coarsen_shape(fine)
    f = torch.randn(fine, device="cuda", generator=g)
    c = torch.randn(coarse, device="cuda", generator=g)
    w = torch.tensor([0.25, 0.5, 0.25], device="cuda")
    W = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None, None]
    v = torch.tensor([0.5, 1.0, 0.5], device="cuda")
    V = (v[:, None, None] * v[None, :, None] * v[None, None, :])[None, None]
    f5 = f[None, None, 1:, 1:, 1:].contiguous()
    c5 = c[None, None].contiguous()
    lib_r = lambda: F.conv3d(f5, W, stride=2)                    # noqa: E731
    lib_p = lambda: F.conv_transpose3d(c5, V, stride=2)          # noqa: E731
    # the library calls compute the same interiors (up to association)
    lib_r_err = float((lib_r()[0, 0] - restrict_ref(f)[1:-1, 1:-1, 1:-1]).abs().max())
    n = fine
    lib_p_err = float((lib_p()[0, 0, 2:n[0], 2:n[1], 2:n[2]]
                       - prolong_ref(c, fine)[1:-1, 1:-1, 1:-1]).abs().max())
    r_ops, p_ops = transfer_ops(fine, coarse)
    cells_f = fine[0] * fine[1] * fine[2]
    cells_c = coarse[0] * coarse[1] * coarse[2]
    rows = {}
    for key, kern, plain, lib, ops_n in (
            ("K3", lambda: launch_restrict(f), lambda: restrict_ref(f), lib_r, r_ops),
            ("K4", lambda: launch_prolong(c, fine), lambda: prolong_ref(c, fine),
             lib_p, p_ops)):
        nbytes = 4 * (cells_f + cells_c)
        b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (ops_n / PEAK_FLOPS["float32"] * 1e3, "operations"))
        rows[key] = {"ms": cuda_time_ms(kern, repeats=50),
                     "plain_ms": cuda_time_ms(plain, repeats=10),
                     "library_ms": cuda_time_ms(lib, repeats=20),
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
                     "err": max(p[f"{key.lower()}_max_abs_err"] for p in pairs)}
    emit({"phase": "transfer_vs_ref", "tolerance": "bitwise", "pairs": pairs,
          "timed": {"fine": list(fine), "coarse": list(coarse), "dtype": "float32"},
          "K3": {k: v for k, v in rows["K3"].items() if k != "err"},
          "K4": {k: v for k, v in rows["K4"].items() if k != "err"},
          "library_vs_plain_max_abs_err": {"conv3d": lib_r_err,
                                           "conv_transpose3d": lib_p_err}})
    return rows


def btcs_relative_residual(x, T0, w):
    """‖b − A x‖ / ‖b‖ of the BTCS system, in float64 by plain slicing on the
    card: A = I − ωψ·S on the interior, identity on the Moat rows; b = ψ·T0
    on the interior, T0 on the Moat."""
    import torch

    psi = 1.0 / (1.0 + 6.0 * w)
    x = torch.as_tensor(x, device="cuda").double()
    b = torch.as_tensor(T0, device="cuda").double().clone()
    b[1:-1, 1:-1, 1:-1] *= psi
    Ax = x.clone()
    Ax[1:-1, 1:-1, 1:-1] = x[1:-1, 1:-1, 1:-1] - w * psi * neighbours(x)
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def poisson_relative_residual(x, F):
    """‖b − A x‖ / ‖b‖ of the Poisson system, in float64 by plain slicing on
    the card: A = 6I − S on the interior, identity on the (zero) Moat rows;
    b = F on the interior."""
    import torch

    x = torch.as_tensor(x, device="cuda").double()
    F = torch.as_tensor(F, device="cuda").double()
    b = torch.zeros_like(x)
    b[1:-1, 1:-1, 1:-1] = F[1:-1, 1:-1, 1:-1]
    Ax = x.clone()
    Ax[1:-1, 1:-1, 1:-1] = 6.0 * x[1:-1, 1:-1, 1:-1] - neighbours(x)
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def neighbours(x):
    """Sum of the six face neighbours over the interior."""
    c = (slice(1, -1),) * 3
    total = 0
    for ax in range(3):
        lo = list(c)
        hi = list(c)
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        total = total + x[tuple(lo)] + x[tuple(hi)]
    return total


def time_solve(step, x0, iterations):
    """ms per solve and per iteration of ``step(x0)`` on device tensors,
    after a warm-up solve, and its device breakdown."""
    ms = cuda_time_ms(lambda: step(x0), repeats=3)
    return {"ms_per_solve": ms, "ms_per_iteration": ms / max(iterations, 1),
            **device_breakdown(lambda: step(x0), top=6)}


def run_solve_path(record, method, precondition, tol, maxiter):
    """One solve through the user's entry point, with the launch counters
    set to 0 just before and read just after."""
    from repro_torch import compiler
    from repro_torch.engine import RunOptions, reset_stats, stats

    compiler.reset_stats()
    reset_stats()
    reset_counts()
    wse, T = record()
    x, info = wse.solve(T, method=method, precondition=precondition, tol=tol,
                        maxiter=maxiter, options=RunOptions(backend="pallas"),
                        return_info=True)
    counts = read_counts()
    return x, info, counts, {"fallbacks": compiler.stats.fallbacks,
                             "kernels_built": compiler.stats.kernels_built,
                             "mg_level_log": [[list(shape), f, r] for shape, f, r
                                              in stats.mg_level_log]}


def phase_solve_heat3d():
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field, record_implicit
    from repro_torch.engine import RunOptions
    from repro_torch.solver import make_solver

    cfg = HeatConfig()
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * cfg.omega)
    norm_b = float(np.linalg.norm(b))
    tol = SOLVE_REL_TOL * norm_b
    x0 = torch.tensor(T0, device="cuda")
    runs, total = [], dict.fromkeys(kernel_counters(), 0)
    for method, pc in (("cg", None), ("pipecg", None), ("cg", "mg")):
        x, info, counts, comp = run_solve_path(
            lambda: record_implicit(cfg), method, pc, tol, cfg.maxiter)
        outcome = str(info.outcomes[0])
        iters = int(info.iterations[0])
        rel = btcs_relative_residual(x, T0, cfg.omega)
        wse, T = record_implicit(cfg)
        x_jit, info_jit = wse.solve(T, method=method, precondition=pc, tol=tol,
                                    maxiter=cfg.maxiter,
                                    options=RunOptions(backend="jit"),
                                    return_info=True)
        jit_iters = int(info_jit.iterations[0])
        jit_err = float(np.abs(x.astype(np.float64) - x_jit).max())
        jit_atol = SOLVE_JIT_ULPS * max(iters, 1) * float(
            np.spacing(np.abs(x_jit).max().astype(x_jit.dtype)))
        wse, T = record_implicit(cfg)
        prog = wse.program
        wse.__exit__()
        step = make_solver(prog, "T", method=method, precondition=pc,
                           backend="pallas", tol=tol, maxiter=cfg.maxiter)
        timing = time_solve(step, x0, iters)
        need = {"K1"} | ({"K2"} if method == "pipecg" or pc else set()) \
            | ({"K3", "K4"} if pc else set())
        runs.append({"method": method, "precondition": pc, "outcome": outcome,
                     "iterations": iters, "residual_reported": float(info.residual[0]),
                     "independent_f64_relative_residual": rel,
                     "jit_iterations": jit_iters,
                     "pallas_vs_jit_max_abs_err": jit_err,
                     "pallas_vs_jit_atol": jit_atol, "launches": counts,
                     "fallbacks": comp["fallbacks"], **timing})
        if outcome != "CONVERGED":
            raise AssertionError(f"solve {method}/{pc} ended {outcome}")
        if not np.isfinite(x).all() or x.shape != T0.shape:
            raise AssertionError(f"solve {method}/{pc}: bad shape or non-finite")
        if rel > SOLVE_REL_TOL:
            raise AssertionError(f"solve {method}/{pc}: independent residual "
                                 f"{rel} > {SOLVE_REL_TOL}")
        if jit_iters != iters:
            raise AssertionError(f"solve {method}/{pc}: {iters} iterations, "
                                 f"{jit_iters} with backend='jit'")
        if jit_err > jit_atol:
            raise AssertionError(f"solve {method}/{pc}: pallas vs jit {jit_err}"
                                 f" > {jit_atol} ({SOLVE_JIT_ULPS} ulp of the "
                                 "field per iteration)")
        if comp["fallbacks"]:
            raise AssertionError(f"solve {method}/{pc}: interpreter fallbacks")
        missing = [k for k in sorted(need) if counts[k] == 0]
        if missing:
            raise AssertionError(f"solve {method}/{pc}: {missing} never launched")
        for k in total:
            total[k] += counts[k]
    emit({"phase": "solve_heat3d", "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "norm_b": norm_b, "tol": tol,
          "tol_relative": SOLVE_REL_TOL, "runs": runs, "launches": total})
    return total


def phase_mg_poisson(seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.solver import make_solver, poisson_program, record_poisson

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    rng = np.random.default_rng(seed)
    F = np.zeros(shape, np.float32)
    F[1:-1, 1:-1, 1:-1] = rng.normal(
        size=tuple(n - 2 for n in shape)).astype(np.float32)
    F /= np.linalg.norm(F)
    tol = SOLVE_REL_TOL
    x0 = torch.zeros(shape, device="cuda")
    runs, total = [], dict.fromkeys(kernel_counters(), 0)
    for method, pc, maxiter in (("mg", None, 60), ("cg", "mg", 200)):
        x, info, counts, comp = run_solve_path(
            lambda: record_poisson(F), method, pc, tol, maxiter)
        outcome = str(info.outcomes[0])
        iters = int(info.iterations[0])
        rel = poisson_relative_residual(x, F)
        step = make_solver(poisson_program(shape, rhs=F), "T", method=method,
                           precondition=pc, backend="pallas", tol=tol,
                           maxiter=maxiter)
        timing = time_solve(step, x0, iters)
        runs.append({"method": method, "precondition": pc, "outcome": outcome,
                     "iterations": iters, "residual_reported": float(info.residual[0]),
                     "independent_f64_relative_residual": rel, "launches": counts,
                     "fallbacks": comp["fallbacks"], **timing,
                     "mg_level_log": comp["mg_level_log"]})
        if outcome != "CONVERGED" or not np.isfinite(x).all():
            raise AssertionError(f"poisson {method}/{pc} ended {outcome}")
        if rel > tol:
            raise AssertionError(f"poisson {method}/{pc}: independent residual "
                                 f"{rel} > {tol}")
        if comp["fallbacks"]:
            raise AssertionError(f"poisson {method}/{pc}: interpreter fallbacks")
        need = {"K1", "K3", "K4"} | ({"K2"} if pc else set())
        missing = [k for k in sorted(need) if counts[k] == 0]
        if missing:
            raise AssertionError(f"poisson {method}/{pc}: {missing} never launched")
        for k in total:
            total[k] += counts[k]
    emit({"phase": "mg_poisson", "shape": list(shape), "seed": seed,
          "rhs": "unit-norm standard normal interior", "tol_relative": tol,
          "runs": runs, "launches": total})
    return total


# ---------------------------------------------------------------------------
# slice 3: K5, K6, K7 and the legacy brick drivers
# ---------------------------------------------------------------------------

#: brick extents of the reference's kernel tests (tests/test_kernels.py)
LEGACY_TEST_SHAPES = ((3, 7, 9), (6, 10, 5), (7, 130, 12))
#: K5/K6 bricks: the 1×1 and 2×2 meshes' bricks of 512×512×128, then the
#: reference's test shapes
LEGACY_BRICKS = ((512, 512, 128), (256, 256, 128)) + LEGACY_TEST_SHAPES
#: the make_sharded_ftcs variants, in the reference's order of precedence
FTCS_VARIANTS = (("baseline", {}), ("overlap", {"overlap": True}),
                 ("halo_depth4", {"halo_depth": 4}),
                 ("kernel", {"use_kernel": True}),
                 ("planes", {"use_kernel": "planes"}))


def roofline(nbytes: float, ops: float, dtype_name: str) -> tuple:
    """(least ms, "bytes" | "operations") for moving ``nbytes`` and doing
    ``ops`` floating-point operations of ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seven_point_weight(c_diag: float, c_off: float, like):
    """The 3×3×3 ``conv3d`` weight of ``c_diag·c + c_off·Σ6``."""
    import torch

    W = torch.zeros((1, 1, 3, 3, 3), dtype=like.dtype, device=like.device)
    W[0, 0, 1, 1, 1] = c_diag
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        W[(0, 0) + d] = c_off
    return W


def stencil_conv(P, W):
    """The library counterpart of K6: z edge-replicated by ``F.pad``, then
    one ``F.conv3d`` over the padded brick."""
    import torch.nn.functional as F

    return F.conv3d(F.pad(P[None, None], (1, 1, 0, 0, 0, 0), mode="replicate"),
                    W)[0, 0]


def spmv_conv(P, W):
    """The library counterpart of K5: :func:`stencil_conv` and
    ``torch.dot``."""
    import torch

    av = stencil_conv(P, W)
    return av, torch.dot(P[1:-1, 1:-1].reshape(-1), av.reshape(-1))


def phase_legacy_kernels_vs_ref(seed: int):
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmv import launch_spmv_dot, spmv_dot_ref
    from repro_torch.kernels.stencil7 import (affine_stencil_ref, launch_stencil7,
                                              launch_stencil_planes,
                                              stencil_planes_ref)

    cfg = HeatConfig()
    w = cfg.omega
    a, wpsi = 1.0 - 6.0 * w, w / (1.0 + 6.0 * w)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    def rnd(shape, dtype):
        return torch.randn(shape, device="cuda", generator=g, dtype=dtype)

    k6, k5, k7, main = [], [], [], {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for bx, by, nz in LEGACY_BRICKS:
            P = rnd((bx + 2, by + 2, nz), dtype)
            got, want = launch_stencil7(P, a, w), affine_stencil_ref(P, a, w)
            av, parts = launch_spmv_dot(P, 1.0, -wpsi)
            av2, parts2 = launch_spmv_dot(P, 1.0, -wpsi)
            want_av, plain_dot = spmv_dot_ref(P, 1.0, -wpsi)
            torch.cuda.synchronize()
            err6 = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K6 differs from affine_stencil_ref at "
                                     f"{(bx, by, nz)} {name} (max {err6})")
            prod = P[1:-1, 1:-1].double() * want_av.double()
            dot, dot2 = torch.sum(parts), torch.sum(parts2)
            dot_err = abs(float(dot) - float(prod.sum()))
            ratio = dot_err / float(prod.abs().sum())
            if not torch.equal(av, want_av):
                raise AssertionError(f"K5's Ap differs from spmv_dot_ref at "
                                     f"{(bx, by, nz)} {name}")
            if not (torch.equal(av, av2) and torch.equal(dot, dot2)):
                raise AssertionError(f"K5 is not deterministic at {(bx, by, nz)} {name}")
            if not bool(torch.isfinite(dot)) or ratio > K5_REL[name]:
                raise AssertionError(f"K5 dot {name} {(bx, by, nz)}: |err|/Σ|c·Ap| "
                                     f"= {ratio} > {K5_REL[name]}")
            k6.append({"brick": [bx, by, nz], "dtype": name, "max_abs_err": err6})
            k5.append({"brick": [bx, by, nz], "dtype": name, "ap_max_abs_err": 0.0,
                       "dot_abs_err": dot_err, "dot_err_over_sum_abs": ratio,
                       "plain_dot_abs_err": abs(float(plain_dot) - float(prod.sum())),
                       "bound": K5_REL[name]})
            if dtype == torch.float32 and bx == cfg.nx:
                main.update(P=P, k5_err=dot_err)
        for mesh_shape in ((1, 1), (2, 2)):
            bx, by = cfg.nx // mesh_shape[0], cfg.ny // mesh_shape[1]
            for cx in range(mesh_shape[0]):
                for cy in range(mesh_shape[1]):
                    T = rnd((bx, by, cfg.nz), dtype)
                    planes = [rnd(s, dtype) for s in ((1, by, cfg.nz), (1, by, cfg.nz),
                                                      (bx, 1, cfg.nz), (bx, 1, cfg.nz))]
                    args = (T, *planes, (cx, cy), a, w, cfg.nx, cfg.ny)
                    got, want = launch_stencil_planes(*args), stencil_planes_ref(*args)
                    torch.cuda.synchronize()
                    err = float((got.double() - want.double()).abs().max())
                    if not torch.equal(got, want):
                        raise AssertionError(f"K7 differs from stencil_planes_ref on "
                                             f"brick {(cx, cy)} of {mesh_shape} "
                                             f"{name} (max {err})")
                    k7.append({"mesh": list(mesh_shape), "coords": [cx, cy],
                               "brick": [bx, by, cfg.nz], "dtype": name,
                               "max_abs_err": err})
                    if dtype == torch.float32 and mesh_shape == (1, 1):
                        main["planes"] = args

    # time at the main path's float32 shapes
    P, args = main["P"], main["planes"]
    cells = cfg.nx * cfg.ny * cfg.nz
    interior = (cfg.nx - 2) * (cfg.ny - 2) * (cfg.nz - 2)
    blocks = launch_spmv_dot(P, 1.0, -wpsi)[1].numel()
    W6, W5 = seven_point_weight(a, w, P), seven_point_weight(1.0, -wpsi, P)
    lib6_err = float((stencil_conv(P, W6) - affine_stencil_ref(P, a, w)).abs().max())
    rows = {}
    for key, kern, plain, lib, nbytes, ops_n in (
            ("K6", lambda: launch_stencil7(P, a, w), lambda: affine_stencil_ref(P, a, w),
             lambda: stencil_conv(P, W6), 4 * (P.numel() + cells), 8 * cells),
            ("K5", lambda: launch_spmv_dot(P, 1.0, -wpsi),
             lambda: spmv_dot_ref(P, 1.0, -wpsi), lambda: spmv_conv(P, W5),
             4 * (P.numel() + cells + blocks), 10 * cells),
            ("K7", lambda: launch_stencil_planes(*args), lambda: stencil_planes_ref(*args),
             None, 4 * (2 * cells + 2 * (cfg.ny + cfg.nx) * cfg.nz), 8 * interior)):
        b_ms, b_by = roofline(nbytes, ops_n, "float32")
        rows[key] = {"ms": cuda_time_ms(kern, repeats=50),
                     "plain_ms": cuda_time_ms(plain, repeats=10),
                     "library_ms": cuda_time_ms(lib, repeats=10) if lib else None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes}
    rows["K5"]["with_partial_sum_ms"] = cuda_time_ms(
        lambda: ops.spmv_hex_dot(P, 1.0, -wpsi), repeats=50)
    rows["K6"]["err"] = max(c["max_abs_err"] for c in k6)
    rows["K7"]["err"] = max(c["max_abs_err"] for c in k7)
    rows["K5"]["err"] = main["k5_err"]
    emit({"phase": "legacy_kernels_vs_ref",
          "tolerance": {"K6": "bitwise", "K7": "bitwise", "K5 Ap": "bitwise",
                        "K5 dot": "|K5 - exact(f64)| <= rel * sum|c*Ap|"},
          "K6_cases": k6, "K7_cases": k7, "K5_cases": k5,
          "timed": {"padded": list(P.shape), "brick": list(args[0].shape),
                    "dtype": "float32"},
          "library": {"K6": "F.pad(z, replicate) + F.conv3d, TF32 off",
                      "K5": "the same + torch.dot",
                      "K7": None},
          "library_vs_plain_max_abs_err": {"K6": lib6_err},
          **{k: {kk: vv for kk, vv in v.items() if kk != "err"} for k, v in rows.items()}})
    return rows


def phase_legacy_ftcs(steps: int, seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.core.explicit import ftcs_solve, make_sharded_ftcs
    from repro_torch.core.mesh import make_mesh

    cfg = HeatConfig()
    shape, w = (cfg.nx, cfg.ny, cfg.nz), cfg.omega
    meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}

    def run_variants(mesh, T, n):
        outs, per = {}, {}
        for name, kw in FTCS_VARIANTS:
            k = kw.get("halo_depth", 1)
            if n % k:
                raise ValueError(f"{n} steps do not divide into halo depth {k}")
            step, sharding = make_sharded_ftcs(mesh, shape, w, steps_per_call=n // k,
                                               **kw)
            x = sharding.shard(T)
            before = read_counts()
            out = step(x).gather()
            torch.cuda.synchronize()
            per[name] = {kk: v - before[kk] for kk, v in read_counts().items()}
            if not torch.isfinite(out).all() or tuple(out.shape) != shape:
                raise AssertionError(f"legacy_ftcs {name}: bad shape or non-finite")
            outs[name] = out
        bricks = mesh.size
        for name, d in per.items():
            want6 = n * bricks if name == "kernel" else 0
            want7 = n * bricks if name == "planes" else 0
            if (d["K6"], d["K7"]) != (want6, want7):
                raise AssertionError(f"legacy_ftcs {name} on {mesh.dims}: K6/K7 "
                                     f"launches {(d['K6'], d['K7'])}, expected "
                                     f"{(want6, want7)}")
        base = outs["baseline"]
        for name, out in outs.items():
            if not torch.equal(out, base):
                err = float((out.double() - base.double()).abs().max())
                raise AssertionError(f"legacy_ftcs: {name} differs from the baseline "
                                     f"on {mesh.dims} (max {err})")
        return outs, per

    # --- the main path: counters to 0 just before, read just after -------
    T0 = torch.tensor(make_field(cfg), device="cuda")
    reset_counts()
    heat, heat_counts = run_variants(meshes["1x1"], T0, steps)
    main_counts = read_counts()
    # -----------------------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    R0 = 300.0 + 200.0 * torch.rand(shape, device="cuda", generator=g)
    rand_steps = 20
    rand = {m: run_variants(mesh, R0, rand_steps)[0]["baseline"]
            for m, mesh in meshes.items()}
    if not torch.equal(rand["2x2"], rand["1x1"]):
        raise AssertionError("legacy_ftcs: the 2×2 mesh differs from the 1×1 mesh")
    solved = ftcs_solve(T0, w, steps)
    solve_err = float((solved.double() - heat["baseline"].double()).abs().max())
    solve_atol = steps * float(np.spacing(np.float32(heat["baseline"].abs().max().item())))
    if not torch.isfinite(solved).all() or solve_err > solve_atol:
        raise AssertionError(f"ftcs_solve vs make_sharded_ftcs: {solve_err} > "
                             f"{solve_atol} (1 ulp per step)")

    # --- timing: 20-step calls on device bricks, CUDA events -------------
    timing = {}
    n = 20
    for m, mesh in meshes.items():
        for name, kw in FTCS_VARIANTS:
            step, sharding = make_sharded_ftcs(
                mesh, shape, w, steps_per_call=n // kw.get("halo_depth", 1), **kw)
            x = sharding.shard(T0)
            timing[f"{m} {name}"] = {
                "ms_per_step": cuda_time_ms(lambda: step(x), repeats=3) / n,
                **device_breakdown(lambda: step(x))}
    timing["ftcs_solve"] = {
        "ms_per_step": cuda_time_ms(lambda: ftcs_solve(T0, w, n), repeats=3) / n,
        **device_breakdown(lambda: ftcs_solve(T0, w, n))}
    emit({"phase": "legacy_ftcs", "shape": list(shape), "dtype": cfg.dtype,
          "steps": steps, "variants": [v[0] for v in FTCS_VARIANTS],
          "launches": heat_counts, "main_path_launches": main_counts,
          "variants_bitwise": True,
          "random_field": {"seed": seed, "steps": rand_steps,
                           "meshes": list(meshes), "bitwise": True},
          "ftcs_solve_vs_sharded": {"max_abs_err": solve_err, "atol": solve_atol},
          "timing": timing})
    return main_counts


def initial_iteration_state(method: str, x0, w: float):
    """A seeded state of ``make_sharded_iteration``, computed in float64
    from ``x0`` and rounded to float32: the start of the method on
    ``A x = b`` with ``b = rhs(x0)``."""
    import torch

    psi = 1.0 / (1.0 + 6.0 * w)
    x = x0.double()
    b = x.clone()
    b[1:-1, 1:-1, 1:-1] *= psi

    def A(v):
        out = v.clone()
        out[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1] - w * psi * neighbours(v)
        return out

    r = b - A(x)
    f32 = lambda *vs: tuple(torch.as_tensor(v, device="cuda").float() for v in vs)  # noqa: E731
    if method == "cg":
        return f32(x, r, r, (r * r).sum())
    if method == "pipecg":
        z = torch.zeros_like(x)
        return f32(x, r, A(r), z, z, z, 1e30, 1.0)
    lmin, lmax = 1.0 - 6.0 * w * psi, 1.0 + 6.0 * w * psi
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    d = r / theta
    return f32(x + d, r, d, delta / theta)


def phase_legacy_btcs(seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.implicit import btcs_solve, make_sharded_iteration
    from repro_torch.core.mesh import BrickArray, make_mesh

    cfg = HeatConfig()
    shape, w = (cfg.nx, cfg.ny, cfg.nz), cfg.omega
    meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    x0 = 300.0 + 200.0 * torch.rand(shape, device="cuda", generator=g,
                                    dtype=torch.float64)
    ulp = float(np.spacing(np.float32(x0.abs().max().item())))
    methods = ("cg", "pipecg", "chebyshev")
    states = {m: initial_iteration_state(m, x0, w) for m in methods}
    del x0
    iters = LEGACY_ITERS
    # where each method's runs are compared: CG and pipelined CG at the last
    # iteration before the recurrence residual ‖rᵢ‖ (state entry 1) of the
    # plain 1×1 run first falls to KRYLOV_FLOOR·‖r₀‖; chebyshev at the last
    check_at, history = {"chebyshev": iters}, {}
    for method in ("cg", "pipecg"):
        step, specs = make_sharded_iteration(meshes["1x1"], shape, w, method=method)
        s = state_from_numpy(states[method], specs[0].sharding)
        norms = [float(torch.linalg.vector_norm(s[1].gather().double()))]
        for _ in range(iters):
            s = step(s)
            norms.append(float(torch.linalg.vector_norm(s[1].gather().double())))
        history[method] = [v / norms[0] for v in norms]
        below = [i for i, h in enumerate(history[method]) if h <= KRYLOV_FLOOR]
        check_at[method] = below[0] - 1 if below else iters
        if check_at[method] < 1:
            raise AssertionError(f"legacy_btcs {method}: no iteration above the floor")
    runs, results, steps, last_x = [], {}, {}, {}
    # --- the main path: counters to 0 just before, read just after -------
    reset_counts()
    for method in methods:
        for m, mesh in meshes.items():
            for use_kernel in (False, True):
                step, specs = make_sharded_iteration(mesh, shape, w, method=method,
                                                     use_kernel=use_kernel)
                s = state_from_numpy(states[method], specs[0].sharding)
                before = read_counts()
                for i in range(iters):
                    s = step(s)
                    if i + 1 == check_at[method]:
                        out = tuple(v.gather() if isinstance(v, BrickArray) else v
                                    for v in s)
                torch.cuda.synchronize()
                d = {k: v - before[k] for k, v in read_counts().items()}
                final = [v.gather() if isinstance(v, BrickArray) else v for v in s]
                if not all(bool(torch.isfinite(v).all()) for v in (*out, *final)):
                    raise AssertionError(f"legacy_btcs {method} {m} kernel={use_kernel}: "
                                         "non-finite state")
                last_x[method, m, use_kernel] = final[0]
                del final
                want5 = iters * mesh.size if use_kernel else 0
                want2 = want5 if method == "pipecg" else 0
                if (d["K5"], d["K2"]) != (want5, want2):
                    raise AssertionError(f"legacy_btcs {method} {m} kernel={use_kernel}: "
                                         f"K5/K2 launches {(d['K5'], d['K2'])}, "
                                         f"expected {(want5, want2)}")
                results[method, m, use_kernel] = out
                steps[method, m, use_kernel] = (step, specs)
                runs.append({"method": method, "mesh": m, "use_kernel": use_kernel,
                             "launches": {k: d[k] for k in ("K2", "K5")}})
    main_counts = read_counts()
    # -----------------------------------------------------------------------
    checks = []
    for method in methods:
        n = check_at[method]
        atol = ITER_ULPS * n * ulp
        pairs = [((method, "1x1", True), (method, "1x1", False)),
                 ((method, "2x2", False), (method, "1x1", False)),
                 ((method, "2x2", True), (method, "1x1", True))]
        for got_key, want_key in pairs:
            got, want = results[got_key], results[want_key]
            vec_err = max(float((g_.double() - w_.double()).abs().max())
                          for g_, w_ in zip(got, want) if g_.ndim)
            scal = [abs(float(g_) / float(w_) - 1.0) if float(w_) else 0.0
                    for g_, w_ in zip(got, want) if not g_.ndim]
            bitwise = all(torch.equal(g_.to(w_.device), w_) for g_, w_ in zip(got, want))
            last_err = float((last_x[got_key].double()
                              - last_x[want_key].double()).abs().max())
            checks.append({"got": list(got_key), "want": list(want_key),
                           "at_iteration": n, "vectors_max_abs_err": vec_err,
                           "atol": atol, "scalars_rel_diff": scal,
                           "scalars_rel_bound": ITER_SCALAR_REL, "bitwise": bitwise,
                           f"x_max_abs_err_at_iteration_{iters}": last_err})
            if method == "chebyshev" and not bitwise:
                raise AssertionError(f"legacy_btcs chebyshev {got_key} vs {want_key}: "
                                     f"not bitwise (max {vec_err})")
            if vec_err > atol:
                raise AssertionError(f"legacy_btcs {got_key} vs {want_key}: {vec_err} > "
                                     f"{atol} ({ITER_ULPS} ulp of the field per "
                                     "iteration)")
            if max(scal, default=0.0) > ITER_SCALAR_REL:
                raise AssertionError(f"legacy_btcs {got_key} vs {want_key}: recurrence "
                                     f"scalars differ by {scal} > {ITER_SCALAR_REL} "
                                     "relative")
    timing = {}
    for (method, m, use_kernel), (step, specs) in steps.items():
        if m != "1x1":
            continue
        s = state_from_numpy(states[method], specs[0].sharding)
        timing[f"{method} kernel={use_kernel}"] = {
            "ms_per_iteration": cuda_time_ms(lambda: step(s), repeats=20),
            **device_breakdown(lambda: step(s))}
    # one legacy BTCS time step with cg, on one device
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * w)
    tol = SOLVE_REL_TOL * float(np.linalg.norm(b))
    T0c = torch.tensor(T0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T1, (its, res) = btcs_solve(T0c, w, 1, method="cg", tol=tol, maxiter=cfg.maxiter)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    rel = btcs_relative_residual(T1, T0, w)
    if not torch.isfinite(T1).all() or tuple(T1.shape) != shape or rel > SOLVE_REL_TOL:
        raise AssertionError(f"btcs_solve cg: independent residual {rel} > "
                             f"{SOLVE_REL_TOL} or a bad result")
    emit({"phase": "legacy_btcs", "shape": list(shape), "dtype": "float32",
          "iterations": iters, "seed": seed, "compared_at": check_at,
          "residual_history_over_r0": history, "krylov_floor": KRYLOV_FLOOR,
          "runs": runs, "checks": checks,
          "main_path_launches": main_counts, "timing": timing,
          "btcs_solve": {"method": "cg", "tol": tol, "iterations": int(its[0]),
                         "residual_reported": float(res[0]),
                         "independent_f64_relative_residual": rel,
                         "ms_host_clock": solve_ms}})
    return main_counts


def device_breakdown(fn, top: int = 4) -> dict:
    """Device time by kernel over one ``fn()`` under ``torch.profiler``, and
    the device's idle share: of the profiled call's wall time
    (``device_idle_share``, the profiler's own host cost included) and of
    an unprofiled call's (``device_idle_share_unprofiled``).  The shares are
    None where the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us, e.key[:60], e.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return {"device_kernels_us": [{"kernel": name, "us": us, "calls": n}
                                  for us, name, n in kernels[:top]],
            "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us if kernels else None,
            "device_idle_share_unprofiled":
                1.0 - busy / plain_wall_us if kernels else None}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="heat3d time steps per run (default 200)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random operands and right-hand sides")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    heat = phase_kernel_vs_ref(args.steps)
    k2 = phase_dual_dot_vs_ref(args.seed)
    transfers = phase_transfer_vs_ref(args.seed)
    k1 = phase_heat3d(args.steps, heat)
    solve_counts = phase_solve_heat3d()
    phase_mg_poisson(args.seed)
    legacy = phase_legacy_kernels_vs_ref(args.seed)
    ftcs_counts = phase_legacy_ftcs(args.steps, args.seed)
    btcs_counts = phase_legacy_btcs(args.seed)
    csrc = "src/repro_torch/kernels/csrc/"
    rows = [("K1 fused_stencil", "fused_stencil.cu",
             "src/repro/kernels/fused.py:245", dict(k1, library_ms=None)),
            ("K2 dual_dot", "dual_dot.cu", "src/repro/kernels/dotprod.py:39",
             dict(k2, launches=solve_counts["K2"] + btcs_counts["K2"])),
            ("K3 restrict", "transfer.cu", "src/repro/kernels/transfer.py:119",
             dict(transfers["K3"], launches=solve_counts["K3"])),
            ("K4 prolong", "transfer.cu", "src/repro/kernels/transfer.py:126",
             dict(transfers["K4"], launches=solve_counts["K4"])),
            ("K5 spmv_dot", "stencil7.cu", "src/repro/kernels/spmv.py:52",
             dict(legacy["K5"], launches=btcs_counts["K5"])),
            ("K6 affine_stencil", "stencil7.cu", "src/repro/kernels/stencil7.py:62",
             dict(legacy["K6"], launches=ftcs_counts["K6"])),
            ("K7 stencil_planes", "stencil7.cu", "src/repro/kernels/stencil7.py:140",
             dict(legacy["K7"], launches=ftcs_counts["K7"]))]
    missing = [name for name, _, _, r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their main paths: {missing}")
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + src, "replaces": where,
        "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, src, where, r in rows]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
