#!/usr/bin/env python3
"""The mesh LM phases of two trees on one card, interleaved: ``chip_smoke.py``'s
``lm_serve_mesh`` and ``lm_train_split`` of the parent tree and of the
change, run parent, change, change, parent, each in a fresh process from
its tree's root (TF32 off, as the smoke's ``main`` sets it).  Prints one
JSON line a run (decode ms a token and prefill ms on 2×2 and 1×4, the
split step's ms and median, each phase's seconds) and, with ``--out``,
writes them all to that file.  Compare the two trees only within one
run of this script: the host's pace drifts between machines and within
a run.

    python3 tools/ab_lm_phases.py PARENT_TREE CHANGE_TREE [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CODE = ("import sys; sys.path[:0] = ['src', '.']\n"
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "import chip_smoke as cs\n"
        "cs.phase_lm_serve_mesh(0)\n"
        "cs.phase_lm_train_split(0)\n")


def run(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                         capture_output=True, text=True)
    got = {"rc": out.returncode}
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if d.get("phase") == "lm_serve_mesh":
            got["serve_s"] = d["seconds"]
            for mesh in ("2x2", "1x4"):
                m = d["meshes"][mesh]
                got[f"{mesh}_decode_ms"] = m["decode_ms_per_token"]
                got[f"{mesh}_prefill_ms"] = m["prefill_ms"]
        elif d.get("phase") == "lm_train_split":
            got["split_s"] = d["seconds"]
            got["split_step_ms"] = d["step_ms"]
            got["split_step_ms_median"] = d["step_ms_median"]
    if out.returncode:
        got["stderr"] = out.stderr[-1500:]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    trees = {"parent": args.parent, "change": args.change}
    rows = []
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        rows.append({"run": i + 1, "tree": tag, **run(trees[tag])})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return max(r["rc"] for r in rows)


if __name__ == "__main__":
    sys.exit(main())
