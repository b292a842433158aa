#!/usr/bin/env python3
"""Host time of K1's launcher and of the resident heat3d step on one card.

Imports the port from ``--src`` (default: this checkout's ``src``), so that
one machine can time two trees of the port, one process each.  On
``HeatConfig()``'s 512×512×128 float32 heat body it measures, on an idle
card (synchronised before every sample), the median host time:

* of one ``launch_fused`` call — the k = 1 kernel in the padded mode and in
  the margin mode, and the auto tile's kernel in the margin mode — from the
  call to its return, over ``--samples`` calls;
* of one ``make`` step on the halo-resident layout at k = 1 and at the auto
  tile — a ``--steps``-step run's host time over its steps — over ``--runs``
  runs;

and the mean device time of the same launches (CUDA events).  Prints one
JSON line.  Exits 2 without a CUDA device.

    python3 tools/k1_host_us.py [--src DIR] [--samples 200] [--runs 7]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_samples_us(fn, n: int) -> list:
    import torch

    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--samples", type=int, default=200,
                    help="launches timed per kernel (default 200)")
    ap.add_argument("--runs", type=int, default=7,
                    help="make runs timed per tile (default 7)")
    ap.add_argument("--steps", type=int, default=200,
                    help="heat3d steps per make run (default 200)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("k1_host_us: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler.codegen import _field_specs, _wrap_pad
    from repro_torch.compiler.ir import auto_tile, lower_group
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, single_runner
    from repro_torch.engine.layout import HaloLayout, wrap_refresh
    from repro_torch.kernels.fused import build_fused_call, launch_fused

    dev = torch.device("cuda")
    cfg = HeatConfig()
    wse, T = record_heat(cfg, args.steps)
    group = lower_group(wse.program.ops)
    wse.__exit__()
    specs, (nx, ny) = _field_specs(group, {"T_n": T.shape}, {"T_n": T.dtype})
    field = torch.tensor(T.init_data, device=dev)
    k_auto = auto_tile(group, (nx, ny), args.steps)

    def kernel(k, margin):
        return build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                ny, time_tile=k, wrap=True, device=dev,
                                margin=margin)[0]

    launches = {}
    for tag, k, resident in (("k1_padded", 1, False), ("k1_margin", 1, True),
                             (f"k{k_auto}_margin", k_auto, True)):
        kern = kernel(k, k * group.halo if resident else 0)
        if resident:
            lay = HaloLayout(pad=kern.margin, shapes={})
            ins = [wrap_refresh(lay.enter({"T_n": field})["T_n"], kern.margin,
                                kern.pad)]
            out = [torch.empty_like(ins[0])]
            fn = lambda kern=kern, ins=ins, out=out: launch_fused(kern, ins,
                                                                  out=out)
        else:
            ins = [_wrap_pad(field, kern.pad)]
            fn = lambda kern=kern, ins=ins: launch_fused(kern, ins)
        host = host_samples_us(fn, args.samples)
        launches[tag] = {"host_us_median": statistics.median(host),
                         "host_us_min": min(host),
                         "device_ms": device_ms(fn, 20)}
        del ins, fn
    steps = {}
    for tag, tt in (("k1", 1), ("auto", None)):
        wse, T = record_heat(cfg, args.steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=tt))
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"T_n": T.init_data}, "cuda")
        host = [us / args.steps
                for us in host_samples_us(lambda: run(env), args.runs)]
        steps[tag] = {"time_tile": p.segments[0].time_tile,
                      "host_us_per_step_median": statistics.median(host),
                      "host_us_per_step": host}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(json.dumps({"src": args.src, "card": card[0] if card else None,
                      "shape": [cfg.nx, cfg.ny, cfg.nz], "dtype": cfg.dtype,
                      "launch": launches, "resident_step": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
