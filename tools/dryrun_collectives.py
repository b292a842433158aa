#!/usr/bin/env python3
"""The dry-run's ``model``-axis collectives of one arch's cells, a chip, by
kind, and where they come from.

For each cell of ``--arch`` on each mesh (default the production 16×16 and
2×16×16, on ``meta``) prints one JSON line: the per-chip ``all-reduce`` and
``all-gather`` bytes and counts that ``repro_torch.launch.roofline`` charges
from the port's split, the data-parallel ring beside them, and the split
into what every layer adds (one layer of each kind, from the 1- and 2-layer
variants) and what lies outside the layers (the embedding's sum, the
lm_head's vocab gather and input gradient, the clip): ``f₁ − Σ (f₂ − f₁)``
of the variants' tallies, ``f₁`` with one layer of each kind and each
``f₂`` with two of one kind.

``--gspmd`` instead compiles the reference's prefill and decode of the
arch at ``smoke()`` on a 2×2 mesh of 4 fake host devices (layers
unrolled: ``scan_layers=False``, so that the HLO holds every layer's
collectives) and prints ``repro.launch.roofline.collective_bytes`` of its
partitioned HLO (result bytes, every group) beside the port's tally of a
chip at the same size in the same convention (result bytes).  This mode
imports JAX and the reference; the default does not.
``tests/test_torch_dryrun_split.py`` holds the two to each other, one
collective at a time, but for the differences of the port's design.

    PYTHONPATH=src python3 tools/dryrun_collectives.py [--arch qwen3-0.6b]
    PYTHONPATH=src python3 tools/dryrun_collectives.py --gspmd
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

def _sub(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) - b.get(k, 0) for k in dict.fromkeys([*a, *b])}


def _brief(coll: dict) -> dict:
    return {k: coll[k] for k in ("all-reduce", "all-reduce_n", "all-gather",
                                 "all-gather_n")}


def port(arch: str, meshes, cfg=None) -> list:
    """The port's per-chip breakdown of ``arch``'s cells on ``meshes``."""
    from repro_torch.configs import cells_for
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import cell_specs

    out = []
    for mesh in meshes:
        for shape in cells_for(arch):
            spec = cell_specs(arch, shape, mesh, cfg=cfg)
            c, s, rules = spec["cfg"], spec["shape"], spec["rules"]
            tally = roofline.cell_collectives(spec)
            one = roofline.count_collectives(roofline._variant_cfg(c, {}), s,
                                             rules)
            layers, outside = {}, dict(one)
            for kind in dict.fromkeys(k for k, _ in c.segments):
                layer = _sub(roofline.count_collectives(
                    roofline._variant_cfg(c, {kind: 2}), s, rules), one)
                layers[kind] = _brief(roofline.per_chip(layer))
                outside = _sub(outside, layer)
            out.append({
                "arch": arch, "shape": shape, "mesh": str(mesh.shape),
                "model": _brief(roofline.per_chip(tally)),
                "ring_all_reduce": roofline.gradient_reduction(
                    spec, mesh)["all-reduce"],
                "per_layer": layers,
                "outside_layers": _brief(roofline.per_chip(outside))})
    return out


def gspmd(arch: str) -> list:
    """The reference's HLO collectives of ``arch``'s prefill and decode at
    ``smoke()`` on 2×2, beside the port's tally of the same cells."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from repro.configs import get_config as ref_config
    from repro.launch.mesh import make_mesh2d as ref_mesh
    from repro.launch.roofline import collective_bytes
    from repro.launch.specs import cell_specs as ref_specs
    from repro.parallel.sharding import use_sharding

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_mesh2d
    from repro_torch.launch.specs import cell_specs

    mesh = ref_mesh(2, 2)
    rcfg = dataclasses.replace(ref_config(arch).smoke(), scan_layers=False)
    cfg = get_config(arch).smoke()
    out = []
    for shape in ("prefill_32k", "decode_32k"):
        spec = ref_specs(arch, shape, mesh, cfg=rcfg)
        jitted = jax.jit(spec["fn"], in_shardings=spec["in_shardings"],
                         out_shardings=spec["out_shardings"],
                         donate_argnums=spec["donate_argnums"])
        with use_sharding(spec["rules"]):
            hlo = jitted.lower(*spec["args"]).compile().as_text()
        ref = collective_bytes(hlo)
        tally = roofline.cell_collectives(cell_specs(
            arch, shape, make_mesh2d(2, 2, device="meta"), cfg=cfg))
        ours = {}
        for kind in ("all-reduce", "all-gather"):
            ours[kind] = sum(v for (b, k, _, f), v in tally.items()
                             if (b, k, f) == (0, kind, "bytes"))
            ours[kind + "_n"] = sum(v for (b, k, _, f), v in tally.items()
                                    if (b, k, f) == (0, kind, "n"))
        out.append({"arch": arch, "shape": shape, "mesh": "2x2",
                    "config": "smoke()",
                    "gspmd_result_bytes": {k: ref[k] for k in (
                        "all-reduce", "all-reduce_n", "all-gather",
                        "all-gather_n")},
                    "port_result_bytes": _brief(ours)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--gspmd", action="store_true")
    args = ap.parse_args(argv)
    if args.gspmd:
        rows = gspmd(args.arch)
    else:
        from repro_torch.launch.mesh import make_production_mesh
        rows = port(args.arch, [make_production_mesh(multi_pod=mp,
                                                     device="meta")
                                for mp in (False, True)])
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
