#!/usr/bin/env python3
"""``chip_smoke.py``'s ``lm_train`` uninterrupted run at other depths, on
one card.

For each depth of ``--layers``: qwen3-0.6b at full width cut to its first
``N`` layers (``chip_smoke.lm_train_config``), in bfloat16 with its
``remat="dots"`` and 8 microbatches, the phase's 24 steps of 8 × 512 rows
of ``TokenDataset`` under deterministic algorithms, its schedule and seed.
It prints one JSON line a depth: every step's loss, the means of the
first and the last ``LM_TRAIN_LOSS_WINDOW`` steps, the held-out batch's
loss before and after the run (``chip_smoke.held_out_loss``, the phase's
``loss_falls`` check), and the run's seconds.

    python3 tools/lm_train_probe.py --layers 12 16 28 [--seed 0]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts the checkout's src on the path)


def run(layers: int, seed: int) -> dict:
    import torch

    from repro_torch.data import TokenDataset, shard_batch
    from repro_torch.launch import train as train_mod

    cs.LM_TRAIN_LAYERS = layers
    cfg = cs.lm_train_config()
    t0 = time.perf_counter()
    params, opt, step, _ = train_mod.build(cfg, device=cs.DEV, seed=seed,
                                           **cs.LM_TRAIN_KW)
    one = cs.held_out_batch(cfg, seed)
    held = [cs.held_out_loss(params, one, cfg)]
    ds = TokenDataset(cfg.vocab_size, cs.LM_TRAIN_SEQ, cs.LM_TRAIN_BATCH,
                      seed=seed)
    losses = []
    for _ in range(cs.LM_TRAIN_STEPS):
        params, opt, m = step(params, opt, shard_batch(ds.next_batch(),
                                                       cs.DEV))
        losses.append(float(m["loss"]))
    held.append(cs.held_out_loss(params, one, cfg))
    torch.cuda.synchronize()
    w = cs.LM_TRAIN_LOSS_WINDOW
    return {"layers": cfg.n_layers, "seconds": time.perf_counter() - t0,
            "loss": losses, "loss_first_mean": sum(losses[:w]) / w,
            "loss_last_mean": sum(losses[-w:]) / w,
            "held_out_loss_before_after": held,
            "loss_falls": held[1] < held[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[16])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lm_train_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = cs._train_determinism()
    try:
        for n in args.layers:
            print(json.dumps(dict(run(n, args.seed), card=cs.card_line())),
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        cs._restore_determinism(prev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
