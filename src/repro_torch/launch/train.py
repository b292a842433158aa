"""Training driver: mesh → params → resilient loop → checkpoints.

The port of ``repro/launch/train.py``.  It trains seeded random weights on
the seeded :class:`TokenDataset` stream, on the card unless ``--device
cpu``, each step under ``use_sharding(rules)`` of the run's mesh::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

The mesh is single-process and every position is on the run's device
(``launch/mesh.py``): the reference's default ``(n/2) × 2`` over the
``n`` cards (1×1 on one card or the CPU), or with ``--production-mesh``
its 16×16.  Where the rules' batch axes divide a microbatch's rows the step
is data-parallel over them; where the rules split a parameter over
``model`` the parameters and AdamW's moments are placed by their specs
and every pass splits over ``model`` (:mod:`repro_torch.launch.steps`),
all held once on the device.

Each step fires the engine's step hook with its step number and the tag
``"train"``, so a :class:`~repro_torch.runtime.FaultInjector` armed with
``fail_at`` raises in that step; the loop then restores the last
checkpoint and the stream position and replays from there.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenDataset, shard_batch
from repro_torch.device import resolve_device
from repro_torch.engine import hooks
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh2d, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.tree import leaves
from repro_torch.parallel import param_specs_for, rules_for, use_sharding
from repro_torch.parallel.sharding import _axes
from repro_torch.parallel.tensor import MODEL, PlacedParams, place_params
from repro_torch.runtime import HeartbeatMonitor, ResilientLoop


def build(cfg, mesh=None, *, compress: bool = False, seed: int = 0,
          device="cuda", **step_kw):
    """(params, opt_state, train_step, rules) for ``cfg`` on ``mesh``
    (default a 1×1 mesh on ``device``): seeded weights on the mesh's home
    device, fresh AdamW state, the step of
    :func:`~repro_torch.launch.steps.make_train_step` (``step_kw`` its
    schedule and clip) and the config's rule table on the mesh.  Call the
    step under ``use_sharding(rules)``.  As the reference's ``build``
    does, the weights are placed by their specs
    (``param_specs_for(cfg, params, rules)``): where the rules split some
    leaf over ``model`` they come back as
    :class:`~repro_torch.parallel.tensor.PlacedParams` (the drawn tree
    freed once placed) and AdamW's moments placed alike; else the
    :class:`~repro_torch.models.model.ParamTree`, replicated."""
    if mesh is None:
        mesh = make_mesh2d(1, 1, device=device)
    rules = rules_for(cfg, mesh)
    params = M.init_params(cfg, seed=seed, device=resolve_device(mesh.home))
    specs = param_specs_for(cfg, params.tree(), rules)
    if mesh.shape.get(MODEL, 1) > 1 and any(
            MODEL in _axes(e) for spec in leaves(specs) for e in spec):
        tree = params.tree()
        del params
        params = place_params(tree, rules, cfg, specs)
        del tree
    opt = steps_mod.make_opt_state(params, compress=compress)
    step_fn = steps_mod.make_train_step(cfg, compress=compress, **step_kw)
    return params, opt, step_fn, rules


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int, device="cuda", compress: bool = False,
          seed: int = 0, mesh=None, **step_kw):
    """Train ``steps`` steps through :class:`ResilientLoop` on ``mesh``
    (default 1×1 on ``device``), each under ``use_sharding(rules)``,
    checkpointing every ``ckpt_every`` steps into ``ckpt_dir``.  A failed
    step restores the last checkpoint: its parameters and moments are
    copied back into the live tensors and the stream is put back where it
    was.  Returns (params, opt_state, the step reached, every completed
    step's metrics in order, replays included)."""
    params, opt, step_fn, rules = build(cfg, mesh, device=device,
                                        compress=compress, seed=seed,
                                        **step_kw)
    ds = TokenDataset(cfg.vocab_size, seq, batch, seed=seed,
                      n_codebooks=cfg.n_codebooks)
    mgr = CheckpointManager(ckpt_dir)
    batch_sharding = rules.sharding(("batch", "seq"), (batch, seq))
    live = {"params": params if isinstance(params, PlacedParams)
            else params.tree(), "opt": opt}
    history = []

    def one_step(state, batch):
        hooks.fire_step_hook(ds.state()["step"] - 1, "train")
        with use_sharding(rules):
            _, o, metrics = step_fn(params, state["opt"],
                                    shard_batch(batch, batch_sharding))
        live["opt"] = o
        history.append(metrics)
        return {"params": state["params"], "opt": o}, metrics

    def save_fn(step, state):
        mgr.save(step, state, blocking=False, extra={"data": ds.state()})

    def restore_fn():
        # the restored values go into the live tensors (a placed one's
        # single tensor), which the step updates in place
        restored, step, extra = mgr.restore(live)
        with torch.no_grad():
            for dst, src in zip(leaves(live), leaves(restored)):
                dst.copy_(src)
        ds.restore(extra["data"])
        return dict(live), step

    loop = ResilientLoop(one_step, save_fn, restore_fn, ds,
                         ckpt_every=ckpt_every, monitor=HeartbeatMonitor())
    state, step, _ = loop.run(dict(live), 0, steps)
    mgr.wait()
    return params, state["opt"], step, history


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    if args.production_mesh:
        mesh = make_production_mesh(device=dev)
    else:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = make_mesh2d(max(1, n // 2), min(2, n) if n > 1 else 1,
                           device=dev)
    t0 = time.time()
    params, opt, step, history = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=dev,
        compress=args.compress, mesh=mesh)
    dt = time.time() - t0
    loss = float(history[-1]["loss"]) if history else float("nan")
    print(f"trained {step} steps in {dt:.1f}s  final loss {loss:.4f}")
    return params, opt


if __name__ == "__main__":
    main()
