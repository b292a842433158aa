"""LM serving driver: batched prefill, then greedy decode from the cache.

The port of ``repro/launch/serve.py``.  It serves random weights from
``seed`` and random prompts from ``seed + 1``, on the card unless
``device="cpu"``.  On a mesh whose ``model`` axis has more than one
position it places the parameters by their specs and runs the model
split (:mod:`repro_torch.parallel.tensor`: heads, ``mlp``, vocab and
experts over ``model``, the attention caches' sequence over ``model``,
the recurrent mixers' heads, ``conv_dim`` and ``ssm_inner`` over
``model``, rows over the batch axes), for all ten archs; every position
must be on ``device``'s type, the first on ``device``.  ``main`` builds
the reference's mesh over the cards, 1×1 on one card::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.models import model as M
from repro_torch.parallel import rules_for, use_sharding
from repro_torch.parallel.tensor import MODEL, place_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve(cfg, mesh=None, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device="cuda"):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen − 1`` more greedily.  Returns (tokens (batch, gen[, K]),
    decode tokens per second by the host clock, from the first decode step
    to the last token's arrival).  ``mesh`` None, or a mesh whose ``model``
    axis is 1, serves as on one device; else the tokens come back gathered
    on the mesh's home device."""
    dev = resolve_device(device)
    split = mesh is not None and mesh.shape.get(MODEL, 1) > 1
    if mesh is not None and (mesh.home != dev or any(
            d.type != dev.type for d in mesh.devices)):
        raise ValueError(f"serve on device {dev} takes a mesh whose first "
                         f"position is on it and every position on a "
                         f"{dev.type} device; got "
                         f"{[str(d) for d in mesh.devices]}")
    params = M.init_params(cfg, seed=seed, device=dev)
    shape = ((batch, prompt_len) if cfg.n_codebooks == 1
             else (batch, prompt_len, cfg.n_codebooks))
    gen_t = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(1, cfg.vocab_size, shape, generator=gen_t,
                            device=dev)
    rules = None if mesh is None else rules_for(cfg, mesh)
    if split:
        params = place_params(params, rules, cfg)

    with use_sharding(rules):
        logits, cache = M.prefill(params, prompts, cfg, prompt_len + gen)
        out_tokens = [torch.argmax(logits, dim=-1)]
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(prompt_len, prompt_len + gen - 1):
            logits, cache = M.decode_step(params, cache, out_tokens[-1], i,
                                          cfg)
            out_tokens.append(torch.argmax(logits, dim=-1))
        _sync(dev)
        dt = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1)
    return toks, batch * (gen - 1) / max(dt, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    # the reference's mesh over the n cards: 1×1 on one card (and the CPU)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data, model = max(1, n // 2), (min(2, n) if n > 1 else 1)
    devices = [dev] + [torch.device("cuda", i) for i in range(n)
                       if torch.device("cuda", i) != dev]
    mesh = make_mesh2d(data, model, device=devices[:data * model])
    toks, rate = serve(cfg, mesh, batch=args.batch,
                       prompt_len=args.prompt_len, gen=args.gen, device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"generated {tuple(toks.shape)} tokens at {rate:.1f} tok/s "
          f"on {where}")


if __name__ == "__main__":
    main()
