"""Training driver: params → resilient loop → checkpoints, on one device.

The port of ``repro/launch/train.py`` without its mesh (the port's mesh
parallelism comes later; one device is the reference's 1×1 mesh).  It
trains seeded random weights on the seeded :class:`TokenDataset` stream,
on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

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
from repro_torch.models import model as M
from repro_torch.optim.tree import leaves
from repro_torch.runtime import HeartbeatMonitor, ResilientLoop


def build(cfg, *, device="cuda", compress: bool = False, seed: int = 0,
          **step_kw):
    """(params, opt_state, train_step) for ``cfg``: seeded weights on
    ``device``, fresh AdamW state and the step of
    :func:`~repro_torch.launch.steps.make_train_step` (``step_kw`` its
    schedule and clip)."""
    params = M.init_params(cfg, seed=seed, device=resolve_device(device))
    opt = steps_mod.make_opt_state(params, compress=compress)
    step_fn = steps_mod.make_train_step(cfg, compress=compress, **step_kw)
    return params, opt, step_fn


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int, device="cuda", compress: bool = False,
          seed: int = 0, **step_kw):
    """Train ``steps`` steps through :class:`ResilientLoop`, checkpointing
    every ``ckpt_every`` steps into ``ckpt_dir``.  A failed step restores
    the last checkpoint: its parameters and moments are copied back into
    the live tensors and the stream is put back where it was.  Returns
    (params, opt_state, the step reached, every completed step's metrics
    in order, replays included)."""
    dev = resolve_device(device)
    params, opt, step_fn = build(cfg, device=dev, compress=compress,
                                 seed=seed, **step_kw)
    ds = TokenDataset(cfg.vocab_size, seq, batch, seed=seed,
                      n_codebooks=cfg.n_codebooks)
    mgr = CheckpointManager(ckpt_dir)
    live = {"params": params.tree(), "opt": opt}
    history = []

    def one_step(state, batch):
        hooks.fire_step_hook(ds.state()["step"] - 1, "train")
        _, o, metrics = step_fn(params, state["opt"], shard_batch(batch, dev))
        live["opt"] = o
        history.append(metrics)
        return {"params": state["params"], "opt": o}, metrics

    def save_fn(step, state):
        mgr.save(step, state, blocking=False, extra={"data": ds.state()})

    def restore_fn():
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
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    t0 = time.time()
    params, opt, step, history = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=dev,
        compress=args.compress)
    dt = time.time() - t0
    loss = float(history[-1]["loss"]) if history else float("nan")
    print(f"trained {step} steps in {dt:.1f}s  final loss {loss:.4f}")
    return params, opt


if __name__ == "__main__":
    main()
