"""repro_torch.configs — the workloads the port runs: heat3d
(:mod:`repro_torch.configs.heat3d`) and the ten LM architectures.

``get_config(arch)`` / ``ARCHS`` is the architecture registry, a copy of
the reference's field for field (``smoke()`` included), so that both
packages reduce a config the same way.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, MoECfg,
                                      ModelConfig, ShapeCfg, SSMCfg,
                                      cells_for)

_FACTORIES: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    return _FACTORIES[name]()


def arch_names():
    return sorted(_FACTORIES)


ARCHS = ["glm4-9b", "minicpm3-4b", "qwen3-0.6b", "starcoder2-3b",
         "musicgen-medium", "chameleon-34b", "mixtral-8x7b",
         "deepseek-v2-236b", "rwkv6-7b", "zamba2-2.7b"]

# the ten architecture modules register themselves on import
from repro_torch.configs import (chameleon_34b, deepseek_v2_236b,  # noqa: E402,F401
                                 glm4_9b, minicpm3_4b, mixtral_8x7b,
                                 musicgen_medium, qwen3_0_6b, rwkv6_7b,
                                 starcoder2_3b, zamba2_2_7b)

__all__ = ["ARCHS", "SHAPES", "LONG_CONTEXT_ARCHS", "MoECfg", "ModelConfig",
           "ShapeCfg", "SSMCfg", "cells_for", "get_config", "arch_names",
           "register"]
