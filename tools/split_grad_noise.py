#!/usr/bin/env python3
"""How far bfloat16 rounding alone moves a train step's gradients, on the
CPU, so that the model split's distance from one device can be read
against it.

qwen3-0.6b at ``smoke()`` in bfloat16 (``"dots"``, 4 microbatches of
16 × 64 rows, seeded weights and batch) takes one step of
``launch/train.py::build``'s step on the CPU meshes 1×1, 2×1 (data only,
a ``ParamTree``), 2×2 and 1×2 (the ``model`` axis split, placed), and one
step of the same weights in float32 on 1×1.  Each leaf's first moment
after the step (0.1 × the clipped float32 mean gradient) is held against
the bfloat16 1×1 step's and the float32 step's: ``‖Δm‖ / ‖m‖`` and
``max|Δm| / max|m|``, their largest and median over the leaves.  Prints
one JSON line.

    PYTHONPATH=src python3 tools/split_grad_noise.py [--threads 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import TokenDataset, shard_batch
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.optim.tree import leaves
from repro_torch.parallel import ShardedTensor, rules_for, use_sharding

KW = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 24}
B, S = 16, 64


def first_moments(params, opt, step, rules, batch):
    """The step's loss, gradient norm and each leaf's first moment."""
    with use_sharding(rules):
        _, opt, m = step(params, opt, shard_batch(
            batch, rules.sharding(("batch", "seq"), (B, S))))
    return (float(m["loss"]), float(m["grad_norm"]),
            [t.gather() if isinstance(t, ShardedTensor) else t.clone()
             for t in leaves(opt.m)])


def distance(got, want) -> dict:
    l2 = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    mx = [float((a - b).abs().max() / b.abs().max())
          for a, b in zip(got, want)]
    return {"l2_max": max(l2), "l2_median": statistics.median(l2),
            "max_rel_max": max(mx)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").smoke(num_microbatches=4),
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="dots")
    batch = TokenDataset(cfg.vocab_size, S, B, seed=0).next_batch()
    out, ms = {}, {}
    for dims in ((1, 1), (2, 1), (2, 2), (1, 2)):
        params, opt, step, rules = train_mod.build(
            cfg, make_mesh2d(*dims, device="cpu"), seed=0, **KW)
        if dims == (1, 1):
            weights = lm_params_to_numpy(params)
        loss, gnorm, ms[dims] = first_moments(params, opt, step, rules, batch)
        out[f"{dims[0]}x{dims[1]}"] = {"kind": type(params).__name__,
                                       "loss": loss, "grad_norm": gnorm}
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = lm_params_from_numpy(weights, f32, "cpu")
    rules = rules_for(f32, make_mesh2d(1, 1, device="cpu"))
    loss, gnorm, truth = first_moments(
        params, steps_mod.make_opt_state(params),
        steps_mod.make_train_step(f32, **KW), rules, batch)
    out["float32_1x1"] = {"loss": loss, "grad_norm": gnorm}
    for dims in ((2, 1), (2, 2), (1, 2)):
        out[f"{dims[0]}x{dims[1]}"]["vs_1x1"] = distance(ms[dims],
                                                         ms[(1, 1)])
    for dims in ((1, 1), (2, 2)):
        out[f"{dims[0]}x{dims[1]}"]["vs_float32"] = distance(ms[dims], truth)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
