"""Run one cell of ``BENCHMARK.json`` once and build its result line.

A cell names a configuration (``configs/<config>.json`` and its plain
reference ``configs/<config>.py``) and a traffic mix
(``workloads/<traffic>.json``), whose ``kind`` names the driver
``traffic/<kind>.py``.  A driver has four functions:

- ``setup(ctx) -> state``: inputs from the seed, the program built and
  every shape of the cell warmed;
- ``window(ctx, state, seconds) -> dict``: the timed path, back to back for
  ``seconds``; returns ``attempted``, ``failed``, the end-to-end metrics it
  measured (``e2e``) and the work done (``work``);
- ``check(ctx, state) -> [(name, value, limit)]``: frees the program's
  state, then compares what the window produced with the plain reference;
- ``control(ctx) -> [(name, value)]``: the same comparison with the plain
  reference, in the precision below the configuration's, in the program's
  place (run by ``control.py``, never by a benchmark run).

Per-layer metrics are read in a traced run by ``metrics/<metric>.py``,
whose ``read(run)`` returns a number or None (nothing to read: the metric
is left out of the line).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that the run may not hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the plain reference's precision, and the control's: the nearest below the
#: configuration's (the stencils do no matrix product, so no TF32 step)
REFERENCE_DTYPE = "float64"
LOWER = {"float64": "float32", "float32": "bfloat16"}


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    """The files a cell is made of, found by the names it gives."""
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg_json = root / config["file"]
    wl_json = root / HERE.name / "workloads" / f"{cell['traffic']}.json"
    kind = load_json(wl_json)["kind"]
    return {"config": cfg_json,
            "reference": cfg_json.with_suffix(".py"),
            "workload": wl_json,
            "driver": root / HERE.name / "traffic" / f"{kind}.py"}


def metric_file(name: str, root: Path = ROOT) -> Path:
    """The reader of the per-layer metric ``name``."""
    return root / HERE.name / "metrics" / f"{name}.py"


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells it lists, or
    else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


class Ctx:
    """What a driver is given: the cell, its configuration and traffic, the
    seed, the device, the plain reference and the precisions it runs in,
    and the harness's own spans (seconds by name) and the program's
    counters that the driver collects."""

    def __init__(self, cell, cfg, wl, seed, device, ref):
        self.cell, self.cfg, self.wl = cell, cfg, wl
        self.seed, self.device, self.ref = seed, device, ref
        self.reference_dtype = REFERENCE_DTYPE
        self.control_dtype = LOWER[cfg["dtype"]]
        self.spans = {}
        self.counters = {}

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float = None, root: Path = ROOT,
             cfg: dict = None, wl: dict = None) -> dict:
    """Run ``workload`` of the benchmark at ``root`` once; returns the
    result (the line's keys, and ``checks``).  ``cfg`` and ``wl`` replace
    the cell's files (the tests shrink them to run on the host)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    cell = find_cell(spec, workload)
    files = cell_files(spec, cell, root)
    cfg = cfg or load_json(files["config"])
    wl = wl or load_json(files["workload"])
    ref = load_module(files["reference"], f"fieldbench_ref_{cfg['name']}")
    driver = load_module(files["driver"], f"fieldbench_traffic_{wl['kind']}")
    ctx = Ctx(cell, cfg, wl, seed, device, ref)

    state = driver.setup(ctx)
    sync(device)
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    traced = None
    if trace:
        from fieldbench import tracing

        seconds = min(seconds, wl.get("trace_seconds", seconds))
        with tracing.profiled() as prof:
            t0 = time.perf_counter()
            out = driver.window(ctx, state, seconds)
            sync(device)
            window_s = time.perf_counter() - t0
        traced = tracing.reduce(prof, window_s)
    else:
        t0 = time.perf_counter()
        out = driver.window(ctx, state, seconds)
        sync(device)
        window_s = time.perf_counter() - t0
    setup_s = t0 - t_start
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)

    t_check = time.perf_counter()
    checks = driver.check(ctx, state)
    del state
    print(f"fieldbench: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    e2e_names = [m["name"] for m in spec["end_to_end"]
                 if applies(m, workload, ())]
    metrics = {}
    if not trace:
        measured = dict(out["e2e"], setup_s=setup_s)
        missing = set(e2e_names) - set(measured)
        if missing:
            raise RuntimeError(f"the window measured no {sorted(missing)}: "
                               f"too little work done in {seconds} s")
        for m in spec["end_to_end"]:
            if m["name"] in e2e_names:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    else:
        run = {"cell": workload, "cfg": cfg, "wl": wl, "ref": ref,
               "window_s": window_s, "work": out["work"],
               "counters": ctx.counters, "spans": ctx.spans,
               "trace": traced}
        for m in spec["per_layer"]:
            if not applies(m, workload, e2e_names):
                continue
            reader = load_module(metric_file(m["name"], root),
                                 "fieldbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device.startswith("cuda") else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
    failed = out["failed"]
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {name: {"value": v if finite(v) else repr(v),
                               "limit": lim} for name, v, lim in checks}
    return result


def forbidden_modules() -> list:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def main(args, t_start: float) -> int:
    """The command line's run: checks the card, runs the cell, prints each
    compared number beside its limit on standard error and the result as
    the last line of standard output."""
    import torch

    spec = load_spec()
    cell = find_cell(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"fieldbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"fieldbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    values = [m["value"] for m in result["metrics"].values()]
    if not all(finite(v) for v in values):
        print(f"fieldbench: a metric is not finite: {result['metrics']}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
