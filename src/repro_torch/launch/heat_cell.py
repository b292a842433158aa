"""The paper's own workload (heat3d) as a production-mesh dry-run cell.

The port of ``repro/launch/heat_cell.py``: the brick-decomposed FTCS step
and the inner Krylov iterations at the 16×16 (and 2×16×16) mesh for the
2048×2048×512 grid, nine variants under the reference's names:

    explicit: baseline | overlap | wide-halo 4 | K6 kernel | K7 planes
    implicit: cg | cg + K5 | pipecg | chebyshev

Per-chip terms come from the cost model of
:mod:`repro_torch.core.perfmodel` at the mesh's brick
(:func:`~repro_torch.core.perfmodel.ftcs_brick_cost` for FTCS,
:func:`~repro_torch.core.perfmodel.cg_brick_cost` for the iterations, with
one fused reduction for pipecg; the model has no reduction-free entry, so
chebyshev is charged cg's two scalars, 16 bytes beside its halo), on the
H100's float32 peak.  The collective *schedule* is the port's own: one step
of each variant runs on a small CPU mesh (:data:`COUNT_GRID` on 2×2) and
:data:`repro_torch.core.mesh.collectives` counts its plane shifts
(``collective-permute``) and reductions (``all-reduce``); the reference
reads the same from its HLO.  They give ``n_collectives`` and the latency
floor ``t_latency`` (:func:`~repro_torch.launch.roofline.
collective_latency`).  The wide halo exchanges once every
``halo_depth`` steps, so only its collective terms are divided by it.

``state_bytes_per_device`` is the bytes of one brick's state (the field,
or the iteration's vectors and scalars); XLA's ``total_bytes_per_device``
(with its temp buffers) has no counterpart.  Every time here is a model.
"""
from __future__ import annotations

import torch

from repro_torch.configs.heat3d import HeatConfig
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.explicit import make_sharded_ftcs
from repro_torch.core.implicit import make_sharded_iteration
from repro_torch.core.perfmodel import (H100_SXM_FP32_FLOPS, cg_brick_cost,
                                        ftcs_brick_cost)
from repro_torch.launch import roofline

PROD_GRID = HeatConfig(nx=2048, ny=2048, nz=512)   # 2.1e9 cells, fp32

#: the grid one step of each variant runs on, on a 2×2 CPU mesh, to count
#: its collectives (a step's schedule does not depend on the grid)
COUNT_GRID = (16, 16, 8)

EXPLICIT = {
    "explicit_baseline": dict(),
    "explicit_overlap": dict(overlap=True),
    "explicit_wide_halo4": dict(halo_depth=4),
    "explicit_kernel": dict(use_kernel=True),
    "explicit_kernel_planes": dict(use_kernel="planes"),
}

#: (variant, method, use_kernel)
IMPLICIT = (("implicit_cg", "cg", False), ("implicit_cg_kernel", "cg", True),
            ("implicit_pipecg", "pipecg", False),
            ("implicit_chebyshev", "chebyshev", False))

DTYPE_BYTES = 4


def variant_names(variants=None):
    """The nine variant names in order (those in ``variants`` if given)."""
    names = list(EXPLICIT) + [v for v, _, _ in IMPLICIT]
    return [n for n in names if not variants or n in variants]


def count_schedule(name: str, w: float = PROD_GRID.omega):
    """``({"collective-permute": n, "all-reduce": n}, (vectors, scalars))``
    of one step of variant ``name``, run on a 2×2 CPU mesh at
    :data:`COUNT_GRID`: its collectives and its state's entries."""
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    if name in EXPLICIT:
        step, sharding = make_sharded_ftcs(mesh, COUNT_GRID, w,
                                           steps_per_call=1, **EXPLICIT[name])
        state = (sharding.shard(torch.full(COUNT_GRID, 500.0)),)
        run = lambda: step(state[0])  # noqa: E731
        entries = (1, 0)
    else:
        _, method, kernel = next(v for v in IMPLICIT if v[0] == name)
        step, specs = make_sharded_iteration(mesh, COUNT_GRID, w,
                                             method=method, use_kernel=kernel)
        state = tuple(s.sharding.shard(torch.ones(s.shape)) if s.sharding
                      else torch.ones(()) for s in specs)
        run = lambda: step(state)  # noqa: E731
        n_vec = sum(1 for s in specs if s.sharding is not None)
        entries = (n_vec, len(specs) - n_vec)
    mesh_mod.reset_collectives()
    run()
    return dict(mesh_mod.collectives), entries


def heat_record(name: str, mesh, cfg: HeatConfig = PROD_GRID) -> dict:
    """The roofline record of one variant on ``mesh`` (its last two axes
    cut the grid into bricks)."""
    mx, my = mesh.dims[-2:]
    if cfg.nx % mx or cfg.ny % my:
        raise ValueError(f"grid {cfg.nx}×{cfg.ny} does not divide into "
                         f"{mx}×{my} bricks")
    bx, by, nz = cfg.nx // mx, cfg.ny // my, cfg.nz
    sched, (n_vec, n_scal) = count_schedule(name, cfg.omega)
    every = 1
    if name in EXPLICIT:
        every = EXPLICIT[name].get("halo_depth", 1)
        cost = ftcs_brick_cost(bx, by, nz, DTYPE_BYTES, halo_depth=every)
    else:
        method = next(m for v, m, _ in IMPLICIT if v == name)
        cost = cg_brick_cost(bx, by, nz, mx, my, DTYPE_BYTES,
                             fused_reductions=method == "pipecg")
    coll = roofline.no_collectives()
    for kind, n in sched.items():
        coll[kind + "_n"] = n
    coll["count"] = sum(sched.values())
    rec = roofline.analyze(flops_per_chip=cost.flops,
                           hbm_bytes_per_chip=cost.hbm_bytes,
                           collective_bytes_per_chip=cost.collective_bytes,
                           peak_flops=H100_SXM_FP32_FLOPS)
    rec.pop("collective_breakdown")
    rec["collective_bytes_per_chip"] /= every
    rec["t_collective"] /= every
    rec["t_latency"] = roofline.collective_latency(coll, mx, my) / every
    rec["n_collectives"] = coll["count"]
    rec["collective_schedule"] = sched
    rec["t_total"] = (max(rec["t_compute"], rec["t_memory"])
                      + rec["t_collective"] + rec["t_latency"])
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"] + rec["t_latency"]}
    rec["bound"] = max(terms, key=terms.get)
    rec["state_bytes_per_device"] = (n_vec * bx * by * nz + n_scal) \
        * DTYPE_BYTES
    rec["brick"] = (bx, by, nz)
    return rec


def run_heat_cells(mesh, cfg: HeatConfig = PROD_GRID, variants=None):
    """Returns {variant: roofline record} for the heat workload on mesh."""
    return {name: heat_record(name, mesh, cfg)
            for name in variant_names(variants)}


def main(argv=None):
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
    recs = run_heat_cells(mesh)
    out_f = open(args.out, "a") if args.out else None
    for name, rec in recs.items():
        rec = dict(rec, variant=name, mesh=str(mesh.shape),
                   grid=f"{PROD_GRID.nx}x{PROD_GRID.ny}x{PROD_GRID.nz}")
        print(json.dumps(rec))
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
