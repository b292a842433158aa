#!/usr/bin/env python3
"""Device time of the legacy 7-point kernels K5, K6 and K7 (and, with
``--k4``, of the multigrid transfers K3 and K4, with ``--k1-hazard`` of
K1 on a hazard body and on heat3d) on one card.

Imports the port from ``--src`` (default: this checkout's ``src``), so that
one machine can time two trees of the port, one process each.  On the
padded bricks of ``HeatConfig()``'s 512×512×128 float32 grid on a 1×1 mesh
(514×514×128) and on a 2×2 mesh (258×258×128) it measures the mean device
time (CUDA events around ``--repeats`` launches after a warm-up, enqueued
behind a sleep kernel so that the host's launch cost does not pace the
card; K5 also back to back, ``K5_paced_ms``):

* of one K5 launch (``launch_spmv_dot``) and of K5 with its partials summed
  (``ops.spmv_hex_dot``), with K5's partial count;
* of one K6 launch (``launch_stencil7``) and one K7 launch
  (``launch_stencil_planes``) on the same bricks, with K7's host µs per
  launch;

beside each kernel's bytes bound (each input read once, each output
written once, at 3.35 TB/s), with ``--xc`` K5's time at other tile
depths (x planes per block; skipped on trees whose ``spmv.py`` has no
``spmv_launch_shape``) and with ``--k7-xc`` K7's (skipped on trees whose
``stencil7.py`` has no ``k7_launch_shape``), each with its grid.  With
``--ftcs`` it times the legacy FTCS step that launches K7
(``make_sharded_ftcs(use_kernel="planes")`` on 1×1 and 2×2 meshes of the
512×512×128 grid): ms per step by CUDA events around a 20-step call,
the median and the spread of ``--runs`` calls.  With ``--iterations`` it also times the legacy
Krylov iteration that launches K5 (``make_sharded_iteration``: cg, pipecg
and chebyshev with kernels, on 1×1 and 2×2 meshes of the 512×512×128
grid): ms per iteration by CUDA events around 20 iterations, back to back
as a caller runs them, the median and the spread of ``--runs`` runs, and
the median host ms to enqueue one iteration (5 iterations after a
synchronise).  K5's host µs per launch is the median of 50 launches on an
idle card, and so is K7's.

With ``--k4`` it times K4 (``launch_prolong``) and K3 (``launch_restrict``)
at float32 on every level pair of the 512×512×128 hierarchy, queued behind
a sleep kernel: the median, min and max of ``--runs`` means of
``--repeats`` launches, beside each pair's bytes bound (the coarse level
read once, the fine one written once, or the reverse), with K4's launch
shape where the tree has ``k4_launch_shape``; ``--k4-xc`` adds K4's
medians at other tile depths (coarse x steps per block).  It also prints
a digest of the SASS of each ``restrict_kernel`` instantiation (``cuobjdump
-sass``, the anonymous-namespace hash stripped from the names) and its
instruction count, so that two trees' K3 can be compared.  With
``--mg-solves`` it runs the multigrid solves of ``chip_smoke.py`` through
``solve(backend="pallas")`` — ``record_implicit(HeatConfig())`` with cg +
mg at ``tol = 1e-5·‖b‖``, and the 512×512×128 Poisson system (unit-norm
random interior right-hand side, seed 0) with mg and cg + mg at 1e-5 —
and prints each one's outcome, iterations, K3/K4 launches by level pair,
the sha256 of its solution's bytes and ms per solve (CUDA events around a
``make_solver`` call after a warm-up; median, min and max of ``--runs``).
Prints one JSON line and the ``ptxas`` lines of the ``stencil7`` library
(and, with ``--k4``, of ``transfer``): each kernel's entry, registers and
spills.  Exits 2 without a CUDA device.

With ``--sass`` it prints the digest and instruction count of the SASS of
every kernel in the four libraries (``fused_stencil``, ``dual_dot``,
``transfer``, ``stencil7``: K1–K7), so that two trees' kernels can be
compared whole.

With ``--k1-hazard`` it times K1 (``launch_fused``) at float32 on
``HeatConfig()``'s 512×512×128 grid, margin mode, queued behind a sleep
kernel (median, min and max of ``--runs`` means, each of enough launches
for 0.2 s of device time, at most ``--repeats``): the hazard body of
``chip_smoke.py::record_coupled`` at k = 1 and at k = 8 beside their
bytes bounds and the k = 8 sweep schedule's, and heat3d's k = 1 launch
(padded and margin) and k = 8 sweep — whatever route the tree gives each.
``--k1-block`` adds the hazard launches at forced column-entry blocks
``BZxBY`` (trees with ``hazard_stage_bytes`` only).  It prints a digest of
the SASS of each ``fused_column_kernel`` instantiation (as for K3), so
that two trees' hazard-free column entry can be compared.

    python3 tools/k5_time.py [--src DIR] [--repeats 200] [--xc 4,8,16]
                             [--k7-xc 2,4,8,16,32] [--ftcs] [--iterations]
                             [--k4] [--k4-xc 1,2,4,8,16] [--mg-solves]
                             [--k1-hazard] [--k1-block 32x8,64x4,128x2]
                             [--runs 7]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hbm_bytes_per_s() -> float:
    """The H100 SXM device-memory rate, from the cost model of the port
    under test (importable once ``--src`` is on the path)."""
    from repro_torch.core.perfmodel import HBM_BYTES_PER_S

    return HBM_BYTES_PER_S


def device_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def queued_ms(fn, n: int) -> float:
    """:func:`device_ms` with the ``n`` calls enqueued behind a sleep
    kernel, doubled until the start event is still pending when the last
    call has been enqueued."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    cycles = int(4e3 * (2 * n * host_us + 1e3))
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        cycles *= 2
    raise RuntimeError("queued_ms: the card caught up with the host")


def iteration_ms(shape, w: float, runs: int) -> dict:
    """ms per iteration of make_sharded_iteration with kernels, by method
    and mesh: the median, min and max of ``runs`` runs of 20 iterations
    from a seeded state (x 300–500 K, r standard normal)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.convert import state_from_numpy
    from repro_torch.core.implicit import make_sharded_iteration
    from repro_torch.core.mesh import make_mesh

    # the iteration's time does not depend on its values: seeded vectors
    rng = np.random.default_rng(0)
    x = rng.uniform(300.0, 500.0, shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    z = np.zeros_like(x)
    rr = np.float32((r.astype(np.float64) ** 2).sum())
    states = {"cg": (x, r, r, rr),
              "pipecg": (x, r, r, z, z, z, np.float32(1e30), np.float32(1.0)),
              "chebyshev": (x, r, r, np.float32(0.375))}
    out = {}
    for dims in ((1, 1), (2, 2)):
        mesh = make_mesh(dims, ("data", "model"))
        for method, state in states.items():
            step, specs = make_sharded_iteration(mesh, shape, w, method=method,
                                                  use_kernel=True)
            s0 = state_from_numpy(state, specs[0].sharding)

            def twenty(s=s0, step=step):
                for _ in range(20):
                    s = step(s)
                return s

            ms = [device_ms(twenty, 1) / 20 for _ in range(runs)]
            host = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = s0
                for _ in range(5):
                    s = step(s)
                host.append((time.perf_counter() - t0) * 1e3 / 5)
            torch.cuda.synchronize()
            out[f"{method} {dims[0]}x{dims[1]}"] = {
                "median": statistics.median(ms), "min": min(ms), "max": max(ms),
                "host_ms_median": statistics.median(host)}
    return out


def ftcs_ms(shape, w: float, runs: int) -> dict:
    """ms per step of make_sharded_ftcs(use_kernel="planes") by mesh: the
    median, min and max of ``runs`` 20-step calls on a seeded 300–500 K
    field."""
    import statistics

    import torch

    from repro_torch.core.explicit import make_sharded_ftcs
    from repro_torch.core.mesh import make_mesh

    g = torch.Generator(device="cuda").manual_seed(0)
    T0 = 300.0 + 200.0 * torch.rand(shape, device="cuda", generator=g)
    out = {}
    for dims in ((1, 1), (2, 2)):
        step, sharding = make_sharded_ftcs(make_mesh(dims, ("data", "model")),
                                           shape, w, steps_per_call=20,
                                           use_kernel="planes")
        x = sharding.shard(T0)
        ms = [device_ms(lambda: step(x), 1) / 20 for _ in range(runs)]
        out[f"planes {dims[0]}x{dims[1]}"] = {
            "median": statistics.median(ms), "min": min(ms), "max": max(ms)}
    return out


def with_xc(own, xc: int):
    """``own`` (a launch-shape function) with its tile depth forced to
    ``xc`` and its x tiles recounted."""
    def shaped(bx, by, nz):
        s = own(bx, by, nz)
        x_t = -(-bx // xc)
        fields = dict(grid=(s.grid[0], x_t, s.grid[2]), xc=xc)
        if hasattr(s, "partials"):
            fields["partials"] = s.grid[0] * x_t * s.grid[2]
        return s._replace(**fields)
    return shaped


def host_us(fn, n: int = 50) -> float:
    """Median host µs of one ``fn()`` call, the card idle before each."""
    import statistics

    import torch

    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def transfer_ms(repeats: int, runs: int, k4_xc: str) -> dict:
    """K4 and K3 device ms at every level pair of the 512×512×128 hierarchy
    (float32, seeded operands): median, min and max of ``runs`` queued
    means, the bytes bound, and K4's shape and depth sweep where the tree
    has ``k4_launch_shape``."""
    import statistics

    import torch

    from repro_torch.compiler.ir import coarsen_shape, coarsenable
    from repro_torch.kernels import transfer
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict

    def spread(fn):
        ms = [queued_ms(fn, repeats) for _ in range(runs)]
        return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}

    g = torch.Generator(device="cuda").manual_seed(0)
    out, fine = {}, (512, 512, 128)
    while coarsenable(fine):
        coarse = coarsen_shape(fine)
        f = torch.randn(fine, device="cuda", generator=g)
        c = torch.randn(coarse, device="cuda", generator=g)
        nbytes = 4 * (f.numel() + c.numel())
        row = {"coarse": list(coarse),
               "K4_ms": spread(lambda: launch_prolong(c, fine)),
               "K3_ms": spread(lambda: launch_restrict(f)),
               "bound_ms": nbytes / hbm_bytes_per_s() * 1e3, "bound_bytes": nbytes}
        own = getattr(transfer, "k4_launch_shape", None)
        if own is not None:
            s4 = own(*fine)
            row["K4_shape"] = {"grid": s4.grid, "xc": s4.xc}
            sweep = {}
            for xc in (map(int, k4_xc.split(",")) if k4_xc else ()):
                def forced(nx, ny, nz, xc=xc):
                    s = own(nx, ny, nz)
                    x_t = -(-(-(-nx // 2)) // xc)
                    return s._replace(grid=(s.grid[0], x_t, s.grid[2]), xc=xc)
                transfer.k4_launch_shape = forced
                sweep[xc] = {"grid": forced(*fine).grid,
                             "K4_ms": spread(lambda: launch_prolong(c, fine))}
            transfer.k4_launch_shape = own
            if sweep:
                row["K4_ms_by_xc"] = sweep
        out["x".join(map(str, fine))] = row
        fine = coarse
    return out


def mg_solves(runs: int) -> dict:
    """Outcome, iterations, K3/K4 launches by level pair, solution digest
    and ms per solve of the multigrid solves of ``chip_smoke.py``."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field, record_implicit
    from repro_torch.engine import RunOptions
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict
    from repro_torch.solver import make_solver, poisson_program, record_poisson

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * cfg.omega)
    btcs_tol = 1e-5 * float(np.linalg.norm(b))
    rng = np.random.default_rng(0)
    F = np.zeros(shape, np.float32)
    F[1:-1, 1:-1, 1:-1] = rng.normal(
        size=tuple(n - 2 for n in shape)).astype(np.float32)
    F /= np.linalg.norm(F)
    cases = (("btcs cg+mg", lambda: record_implicit(cfg), "cg", "mg", btcs_tol,
              cfg.maxiter, T0),
             ("poisson mg", lambda: record_poisson(F), "mg", None, 1e-5, 60,
              np.zeros(shape, np.float32)),
             ("poisson cg+mg", lambda: record_poisson(F), "cg", "mg", 1e-5, 200,
              np.zeros(shape, np.float32)))
    out = {}
    for name, record, method, pc, tol, maxiter, x0 in cases:
        for fn in (launch_prolong, launch_restrict):
            fn.launches = 0
            getattr(fn, "by_level", {}).clear()
        wse, T = record()
        x, info = wse.solve(T, method=method, precondition=pc, tol=tol,
                            maxiter=maxiter, options=RunOptions(backend="pallas"),
                            return_info=True)
        levels = {k: {"x".join(map(str, sh)): n
                      for sh, n in getattr(fn, "by_level", {}).items()}
                  for k, fn in (("K3", launch_restrict), ("K4", launch_prolong))}
        launched = {"K3": launch_restrict.launches, "K4": launch_prolong.launches}
        wse, T = record()
        prog = wse.program
        wse.__exit__()
        step = make_solver(prog, "T", method=method, precondition=pc,
                           backend="pallas", tol=tol, maxiter=maxiter)
        xd = torch.tensor(x0, device="cuda")
        ms = [device_ms(lambda: step(xd), 1) for _ in range(runs)]
        out[name] = {"outcome": str(info.outcomes[0]),
                     "iterations": int(info.iterations[0]),
                     **launched, "by_level": levels,
                     "sha256": hashlib.sha256(
                         np.ascontiguousarray(x).tobytes()).hexdigest(),
                     "ms_median": statistics.median(ms), "ms_min": min(ms),
                     "ms_max": max(ms)}
    return out


def kernel_sass(lib_path: str, stem: str, kernel: str) -> dict:
    """sha256 and instruction count of the SASS of each instantiation of
    ``kernel`` in ``lib_path`` (built from ``csrc/<stem>.cu``), keyed by its
    name with the anonymous-namespace hash stripped; the digest covers the
    code without the name, so two spellings of one instantiation (an added
    template argument) compare equal."""
    from repro_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_" + stem + r"_cu_[0-9a-f]{8}", "",
                  text)
    out = {}
    for sec in text.split("Function : ")[1:]:
        name = sec.splitlines()[0].strip()
        if kernel not in name:
            continue
        body = "\n".join(sec.split(".......")[0].splitlines()[1:])
        out[name] = {"sha256": hashlib.sha256(body.encode()).hexdigest(),
                     "instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", body))}
    return out


def _record_coupled(A0, C0, B0, steps):
    """``chip_smoke.py::record_coupled``'s hazard body (a copy: importing
    ``chip_smoke`` would put this checkout's ``src`` ahead of ``--src``)."""
    import repro_torch as rt

    wse = rt.WFAInterface()
    A = rt.Field("A", init_data=A0, dtype=A0.dtype)
    C = rt.Field("C", init_data=C0, dtype=C0.dtype)
    B = rt.Field("B", init_data=B0, dtype=B0.dtype)
    with rt.ForLoop("t", steps):
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
    return wse


def k1_ms(repeats: int, runs: int, blocks: str) -> dict:
    """K1's device ms at float32 on 512×512×128, margin mode (and heat3d's
    k = 1 launch padded too): the hazard body at k = 1 and 8, heat3d at
    k = 1 and 8, each through the route the tree gives it, with bounds;
    the hazard launches at forced blocks ``blocks`` ("BZxBY,...")."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.compiler.codegen import _field_specs, _wrap_pad
    from repro_torch.compiler.ir import lower_group
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_heat
    from repro_torch.engine.layout import HaloLayout, wrap_refresh
    from repro_torch.kernels import fused

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    rng = np.random.default_rng(0)
    hazard_env = {"A": rng.random(shape, dtype=np.float32),
                  "C": np.float32(0.05) * rng.random(shape, dtype=np.float32),
                  "B": rng.random(shape, dtype=np.float32)}
    bodies = {}
    for body, record, env in (
            ("hazard", lambda: _record_coupled(hazard_env["A"], hazard_env["C"],
                                               hazard_env["B"], 8), hazard_env),
            ("heat3d", lambda: record_heat(cfg, 8)[0],
             {"T_n": make_field(cfg)})):
        wse = record()
        bodies[body] = (wse.program, env)
        wse.__exit__()

    def spread(fn):
        one = max(queued_ms(fn, 1), 1e-3)
        n = max(3, min(repeats, int(200.0 / one)))
        ms = [queued_ms(fn, n) for _ in range(runs)]
        return {"median": statistics.median(ms), "min": min(ms),
                "max": max(ms), "launches_per_mean": n}

    def kernel_for(prog, k, resident=True):
        """``prog``'s kernel at time tile k, in margin mode (M = k·h) or
        padded."""
        group = lower_group(prog.ops)
        specs, (nx, ny) = _field_specs(
            group, {n: f.shape for n, f in prog.fields.items()},
            {n: f.dtype for n, f in prog.fields.items()})
        return fused.build_fused_call(
            group.updates, specs, group.halo, nx, ny, nx, ny, time_tile=k,
            wrap=True, device="cuda",
            margin=k * group.halo if resident else 0)[0]

    def margin_launch(kern, env):
        lay = HaloLayout(pad=kern.margin, shapes={})
        ins = [wrap_refresh(lay.enter({n: torch.tensor(env[n], device="cuda")}
                                      )[n], kern.margin, kern.pad)
               for n in kern.in_names]
        out = [torch.empty_like(ins[kern.in_names.index(n)])
               for n in kern.written]
        return lambda: fused.launch_fused(kern, ins, out=out)

    def bytes_ms(kern, regions):
        nbytes = 0
        for rx, ry, pad in regions:
            for name, nz in zip(kern.in_names, kern.nz):
                nbytes += (rx + 2 * pad) * (ry + 2 * pad) * nz * 4
                if name in kern.written:
                    nbytes += rx * ry * nz * 4
        return nbytes / hbm_bytes_per_s() * 1e3

    out = {}
    for body, (prog, env) in bodies.items():
        for k in (1, 8):
            kern = kernel_for(prog, k)
            row = {"route": fused.fused_entry(kern), "hazard": kern.hazard,
                   "ms": spread(margin_launch(kern, env)),
                   "bound_ms": bytes_ms(kern, [(kern.bx, kern.by, kern.pad)])}
            if k > 1:
                h = kern.halo
                row["sweep_schedule_bound_ms"] = bytes_ms(kern, [
                    (kern.bx + 2 * (k - s - 1) * h,
                     kern.by + 2 * (k - s - 1) * h, h) for s in range(k)])
            if kern.hazard and blocks and hasattr(fused, "hazard_stage_bytes"):
                own = fused.k1_launch_shape
                by_block = {}
                for spec in blocks.split(","):
                    bz, bty = map(int, spec.split("x"))

                    def forced(kernel, extent=None, bz=bz, bty=bty):
                        rx, ry = extent or (kernel.bx, kernel.by)
                        return (-(-ry // bty), rx), (bz, bty)

                    fused.k1_launch_shape = forced
                    by_block[spec] = spread(margin_launch(
                        kernel_for(prog, k), env))
                fused.k1_launch_shape = own
                row["ms_by_block"] = by_block
            out[f"{body} k={k} margin"] = row
    kern = kernel_for(bodies["heat3d"][0], 1, resident=False)
    padded = [_wrap_pad(torch.tensor(bodies["heat3d"][1]["T_n"],
                                     device="cuda"), kern.pad)]
    out["heat3d k=1 padded"] = {
        "route": fused.fused_entry(kern),
        "ms": spread(lambda: fused.launch_fused(kern, padded)),
        "bound_ms": bytes_ms(kern, [(kern.bx, kern.by, kern.pad)])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--repeats", type=int, default=200,
                    help="launches timed per kernel (default 200)")
    ap.add_argument("--xc", default="",
                    help="comma-separated tile depths to time K5 at besides "
                         "the shape's own")
    ap.add_argument("--k7-xc", default="",
                    help="comma-separated tile depths to time K7 at besides "
                         "the shape's own")
    ap.add_argument("--ftcs", action="store_true",
                    help="also time make_sharded_ftcs(use_kernel='planes')")
    ap.add_argument("--iterations", action="store_true",
                    help="also time make_sharded_iteration with kernels")
    ap.add_argument("--k4", action="store_true",
                    help="also time K4 and K3 at every level pair of "
                         "512x512x128, and digest K3's SASS")
    ap.add_argument("--k4-xc", default="",
                    help="comma-separated tile depths to time K4 at besides "
                         "the shape's own (with --k4)")
    ap.add_argument("--mg-solves", action="store_true",
                    help="also run the multigrid solves: iterations, "
                         "solution digest, ms per solve")
    ap.add_argument("--k1-hazard", action="store_true",
                    help="also time K1 on the hazard body and on heat3d, "
                         "and digest the column entry's SASS")
    ap.add_argument("--k1-block", default="",
                    help="comma-separated BZxBY column-entry blocks to time "
                         "the hazard launches at besides the shape's own "
                         "(with --k1-hazard)")
    ap.add_argument("--sass", action="store_true",
                    help="also digest the SASS of every kernel of the four "
                         "kernel libraries (K1-K7)")
    ap.add_argument("--runs", type=int, default=7,
                    help="runs of 20 iterations per method and mesh, of "
                         "20-step FTCS calls per mesh and of queued K3/K4 "
                         "means per level pair (default 7)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("k5_time: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import spmv, stencil7
    from repro_torch.kernels.spmv import launch_spmv_dot
    from repro_torch.kernels.stencil7 import launch_stencil7, launch_stencil_planes

    cfg = HeatConfig()
    w = cfg.omega
    a, wpsi = 1.0 - 6.0 * w, w / (1.0 + 6.0 * w)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for mesh in (1, 2):
        bx, by, nz = cfg.nx // mesh, cfg.ny // mesh, cfg.nz
        P = torch.randn((bx + 2, by + 2, nz), device="cuda", generator=g)
        T = torch.randn((bx, by, nz), device="cuda", generator=g)
        planes = [torch.randn(s, device="cuda", generator=g)
                  for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
        cells = bx * by * nz
        partials = launch_spmv_dot(P, 1.0, -wpsi)[1].numel()
        k5_bytes = 4 * (P.numel() + cells + partials)
        k6_bytes = 4 * (P.numel() + cells)
        k7_bytes = 4 * (2 * cells + 2 * (bx + by) * nz)
        k7 = lambda: launch_stencil_planes(T, *planes, (0, 0), a, w,  # noqa: E731
                                           bx * mesh, by * mesh)
        out[f"{bx + 2}x{by + 2}x{nz}"] = {
            "K5_ms": queued_ms(lambda: launch_spmv_dot(P, 1.0, -wpsi), args.repeats),
            "K5_paced_ms": device_ms(lambda: launch_spmv_dot(P, 1.0, -wpsi),
                                     args.repeats),
            "K5_with_partial_sum_ms": queued_ms(
                lambda: ops.spmv_hex_dot(P, 1.0, -wpsi), args.repeats),
            "K5_partials": partials,
            "K5_host_us": host_us(lambda: launch_spmv_dot(P, 1.0, -wpsi)),
            "K5_with_partial_sum_host_us": host_us(
                lambda: ops.spmv_hex_dot(P, 1.0, -wpsi)),
            "K5_bound_ms": k5_bytes / hbm_bytes_per_s() * 1e3,
            "K6_ms": queued_ms(lambda: launch_stencil7(P, a, w), args.repeats),
            "K6_bound_ms": k6_bytes / hbm_bytes_per_s() * 1e3,
            "K7_ms": queued_ms(k7, args.repeats),
            "K7_host_us": host_us(k7),
            "K7_bound_ms": k7_bytes / hbm_bytes_per_s() * 1e3,
        }
        if hasattr(stencil7, "k7_launch_shape"):
            s7 = stencil7.k7_launch_shape(bx, by, nz)
            out[f"{bx + 2}x{by + 2}x{nz}"]["K7_shape"] = {"grid": s7.grid,
                                                          "xc": s7.xc}
        if args.xc and hasattr(spmv, "spmv_launch_shape"):
            own = spmv.spmv_launch_shape
            sweep = {}
            for xc in map(int, args.xc.split(",")):
                spmv.spmv_launch_shape = with_xc(own, xc)
                sweep[xc] = {"partials": launch_spmv_dot(P, 1.0, -wpsi)[1].numel(),
                             "K5_ms": queued_ms(lambda: launch_spmv_dot(P, 1.0, -wpsi),
                                                args.repeats)}
            spmv.spmv_launch_shape = own
            out[f"{bx + 2}x{by + 2}x{nz}"]["K5_ms_by_xc"] = sweep
        if args.k7_xc and hasattr(stencil7, "k7_launch_shape"):
            own = stencil7.k7_launch_shape
            sweep = {}
            for xc in map(int, args.k7_xc.split(",")):
                stencil7.k7_launch_shape = with_xc(own, xc)
                sweep[xc] = {"grid": stencil7.k7_launch_shape(bx, by, nz).grid,
                             "K7_ms": queued_ms(k7, args.repeats)}
            stencil7.k7_launch_shape = own
            out[f"{bx + 2}x{by + 2}x{nz}"]["K7_ms_by_xc"] = sweep
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    iters = (iteration_ms((cfg.nx, cfg.ny, cfg.nz), w, args.runs)
             if args.iterations else None)
    ftcs = ftcs_ms((cfg.nx, cfg.ny, cfg.nz), w, args.runs) if args.ftcs else None
    transfers = sass = k1 = k1_sass = None
    solves = mg_solves(args.runs) if args.mg_solves else None
    if args.k1_hazard:
        k1 = k1_ms(args.repeats, args.runs, args.k1_block)
        k1_sass = kernel_sass(build.load_library("fused_stencil")._name,
                              "fused_stencil", "fused_column_kernel")
    if args.k4:
        transfers = transfer_ms(args.repeats, args.runs, args.k4_xc)
        sass = kernel_sass(build.load_library("transfer")._name, "transfer",
                           "restrict_kernel")
    all_sass = ({lib: kernel_sass(build.load_library(lib)._name, lib, "")
                 for lib in ("fused_stencil", "dual_dot", "transfer",
                             "stencil7")} if args.sass else None)
    print(json.dumps({"src": args.src, "card": card[0] if card else None,
                      "dtype": "float32", "bricks": out,
                      "iteration_ms": iters, "ftcs_ms_per_step": ftcs,
                      "transfers": transfers, "restrict_sass": sass,
                      "mg_solves": solves, "k1": k1,
                      "column_sass": k1_sass, "sass": all_sass}),
          flush=True)
    libs = (("stencil7",) + ("transfer",) * args.k4
            + ("fused_stencil",) * args.k1_hazard)
    for lib in libs:
        for ln in build.build_log.get(lib, "").splitlines():
            if "entry function" in ln or "Used" in ln or "spill" in ln:
                print(ln.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
