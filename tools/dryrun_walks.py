#!/usr/bin/env python3
"""``python -m repro_torch.launch.dryrun --all`` and ``--all --multi-pod``
side by side on the host, each timed by the host clock (no device is
used).  Prints the card's name and power limit where ``nvidia-smi`` is
there, then each walk's exit code, seconds and record count; the records
go to ``OUT/all16.jsonl`` and ``OUT/allmp.jsonl``.

    python3 tools/dryrun_walks.py [--out build/dryrun_walks]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/dryrun_walks")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {}
    for tag, extra in (("all16", []), ("allmp", ["--multi-pod"])):
        log = open(os.path.join(args.out, f"{tag}.log"), "w")
        procs[tag] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             *extra, "--out", os.path.join(args.out, f"{tag}.jsonl")],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    rc = 0
    while procs:
        for tag, (t0, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[tag]
            rc = rc or proc.returncode
            with open(os.path.join(args.out, f"{tag}.jsonl")) as f:
                n = sum(1 for _ in f)
            print(tag, "rc", proc.returncode, "seconds",
                  time.perf_counter() - t0, "records", n, flush=True)
        time.sleep(1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
