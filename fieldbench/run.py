#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on the card.

    python3 fieldbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints each compared number beside its limit as the last lines of standard
error and one JSON result line as the last line of standard output (see
``fieldbench/harness.py``).  Exits non-zero, with no result line, without
enough CUDA devices, outside a checkout that holds the program (``src/``),
or when the process has loaded JAX or the JAX package ``repro``.  Every
build and kernel cache stays inside the checkout, at fixed paths.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "fieldbench", "build")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    try:
        import repro_torch  # noqa: F401
        from fieldbench import harness
    except ImportError as exc:
        print(f"fieldbench: the program is not in this checkout: {exc}",
              file=sys.stderr)
        return 2
    try:
        return harness.main(args, T_START)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
