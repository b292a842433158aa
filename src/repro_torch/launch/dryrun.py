"""Multi-pod dry-run: every (arch × shape × mesh) cell, with no devices.

The port of ``repro/launch/dryrun.py``.  For each cell this shows, without
hardware:

* the sharding config is coherent (every leaf's spec divides its shape on
  the mesh),
* what one position holds (the argument, output and donated bytes), and
* what a step costs (the counted FLOPs, bytes and collectives → roofline
  terms on H100 constants, :mod:`repro_torch.launch.roofline`).

The production meshes are the full 16×16 and 2×16×16, with every position
on the ``meta`` device: the reference fakes 512 host devices through
``XLA_FLAGS`` before JAX starts; here no environment variable is set and
nothing is allocated, on the CPU or on a card.

The record keeps the reference's keys where the meaning holds
(``argument_size_in_bytes``, ``output_size_in_bytes``,
``alias_size_in_bytes``, the roofline terms, ``n_params``, ``n_active``,
``model_flops_per_chip``, ``useful_flop_ratio``) and drops what only XLA
has: ``lower_s`` and ``compile_s`` (there is no compile),
``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` (XLA's buffer
assignment and code), ``total_bytes_per_device`` (a sum over the temp
bytes), ``hbm_fused_bytes_per_chip`` / ``t_memory_fused`` (the HLO
parser's; the port's HBM bytes already count at op granularity) and the
``raw_*`` keys (uncalibrated XLA counts).  It adds
``matmul_bytes_per_chip`` (the counted ops' operand and result bytes) and
``count_s`` (host seconds the cell took to count).  Every time in a record
is a model, not a measurement.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, cells_for
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import META, cell_specs, memory_fields


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, overrides=None, cfg=None, verbose: bool = True,
             calibrate: bool = True):
    """Count one cell; returns the §Dry-run/§Roofline record.

    ``calibrate`` extrapolates the counts from 1- and 2-layer variants
    (and, above :data:`~repro_torch.launch.roofline.SEQ_DIRECT` tokens,
    from three shorter sequences); without it every layer of the cell is
    counted at its full length.
    """
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    chips = mesh.size
    t0 = time.perf_counter()
    spec = cell_specs(arch, shape_name, mesh, overrides, cfg=cfg)
    rec = {"arch": arch, "shape": spec["shape"].name,
           "mesh": str(mesh.shape), "chips": chips}
    mem = memory_fields(spec, mesh)
    rec.update(mem)
    if calibrate:
        counts = roofline.layer_extrapolated(spec["cfg"], spec["shape"])
    else:
        counts = roofline.count_cell(spec["cfg"], spec["shape"],
                                     seq_direct=spec["shape"].seq_len)
    terms = roofline.terms(spec, mesh, counts, mem)
    terms.pop("collective_breakdown")
    rec.update(terms)

    counts_p = roofline.count_params(spec["cfg"])
    rec["n_params"] = counts_p["total"]
    rec["n_active"] = counts_p["active"]
    mf = roofline.model_flops(spec["cfg"], spec["shape"], counts_p["total"],
                              counts_p["active"])
    rec["model_flops_per_chip"] = mf / chips
    if rec.get("flops_per_chip"):
        rec["useful_flop_ratio"] = mf / chips / rec["flops_per_chip"]
    rec["count_s"] = time.perf_counter() - t0
    if verbose:
        print(json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in cells_for(arch):
                cells.append((arch, shape))
    else:
        if not args.arch:
            ap.error("--arch or --all")
        shapes = [args.shape] if args.shape else cells_for(args.arch)
        cells = [(args.arch, s) for s in shapes]

    mesh = make_production_mesh(multi_pod=args.multi_pod, device=META)
    done = set()
    if args.skip_existing and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))

    out_f = open(args.out, "a") if args.out else None
    ok = True
    try:
        for arch, shape in cells:
            if (arch, shape, str(mesh.shape)) in done:
                print(f"skip {arch} {shape} (already recorded)")
                continue
            try:
                rec = run_cell(arch, shape, mesh=mesh,
                               calibrate=not args.no_calibrate)
            except Exception as e:
                ok = False
                rec = {"arch": arch, "shape": shape, "mesh": str(mesh.shape),
                       "error": repr(e)}
                print(json.dumps(rec))
                traceback.print_exc()
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
