"""Step builders: prefill and decode.

The serving half of ``repro/launch/steps.py``: the functions the serving
driver calls once per prompt batch and once per token.  They run on the
device of their parameters.
"""
from __future__ import annotations

from repro_torch.models import model as M


def make_prefill_step(cfg):
    def prefill_step(params, tokens):
        logits, _ = M.forward(params, tokens, cfg, last_only=True)
        return logits
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg)
    return decode_step
