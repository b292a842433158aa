#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. ``build``          — builds every kernel of the main path from
                        ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a);
2. ``kernel_vs_ref``  — holds K1 bitwise against its plain PyTorch version
                        on the card, at float32 and float64: the heat3d body
                        at its full main-path shapes (k = 1 and the auto
                        tile), and a small multi-field, off-axis,
                        multi-update body at k = 1, k = 2, and through
                        ``make`` with a remainder launch;
3. ``heat3d``         — ``HeatConfig()`` (512×512×128 float32) through
                        ``make(backend="pallas")`` at ``time_tile=1`` and at
                        the auto pick, checked against each other and against
                        the ``jit`` roll interpreter on the card, with K1's
                        launch count equal to the engine's; ms per step by
                        CUDA events after a warm-up, beside the bytes bound;
4. ``kernels``        — one JSON line describing every kernel of the path.

Then the card's name and power limit, and last the result line.  Any failed
check raises: the script exits non-zero and prints no result line.  Without
a CUDA device it exits non-zero before printing anything.

    python3 chip_smoke.py [--steps 200]
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
#: the jit roll interpreter vs the fused kernel on Kelvin-scale fields.  The
#: two sum the taps in different orders (recorded vs canonical), so they
#: drift apart by rounding: within 2e-4 over a short run (the bound the
#: reference documents for its backends), and within one float32 ulp of the
#: field's magnitude per step over a long one
JIT_SHORT_STEPS = 16
JIT_SHORT_ATOL = 2e-4


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
    build.load_library("fused_stencil")
    ptxas = [ln.strip() for ln in build.build_log.get("fused_stencil", "").splitlines()
             if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "fused_stencil",
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds["fused_stencil"], "ptxas": ptxas})


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
        rows, idle = device_breakdown(run, env)
        timing[tag] = {"ms_per_step": ms / steps,
                       "time_tile": p.segments[0].time_tile,
                       "device_kernels_us": rows, "device_idle_share": idle}
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


def device_breakdown(run, env, top: int = 4):
    """Device time by kernel over one ``run(env)`` under ``torch.profiler``,
    and the device's busy share of that run's wall time.  Returns None for
    both where the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(env)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(env)
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
    if not kernels:
        return None, None
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    rows = [{"kernel": name, "us": us, "calls": n} for us, name, n in kernels[:top]]
    return rows, 1.0 - busy / wall_us


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="heat3d time steps per run (default 200)")
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
    k1 = phase_heat3d(args.steps, heat)
    emit({"kernels": [{
        "name": "K1 fused_stencil", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_stencil.cu",
        "replaces": "src/repro/kernels/fused.py:245",
        "launches": k1["launches"], "max_abs_err": k1["err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
