#!/usr/bin/env python3
"""The controls of ``correct``: each cell's comparison, with the plain
reference computed in the precision below the configuration's in the
program's place, on the card at the cell's own size.

    python3 fieldbench/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed: the number each comparison reads.  A control that
reads at or below its limit is one that the limit would not catch.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, device: str = "cuda", root=None, cfg=None,
             wl=None) -> list:
    """``[(seed, [(name, value), ...]), ...]`` of the control of
    ``workload`` of the benchmark at ``root`` on each seed."""
    from fieldbench import harness

    root = root or harness.ROOT
    spec = harness.load_spec(root)
    cell = harness.find_cell(spec, workload)
    files = harness.cell_files(spec, cell, root)
    cfg = cfg or harness.load_json(files["config"])
    wl = wl or harness.load_json(files["workload"])
    ref = harness.load_module(files["reference"], f"fieldbench_ref_{cfg['name']}")
    driver = harness.load_module(files["driver"],
                                 f"fieldbench_traffic_{wl['kind']}")
    out = []
    for seed in seeds:
        ctx = harness.Ctx(cell, cfg, wl, seed, device, ref)
        out.append((seed, driver.control(ctx)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        t0 = time.perf_counter()
        (_, got), = readings(args.workload, [seed])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": dict(got),
                          "seconds": time.perf_counter() - t0,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
