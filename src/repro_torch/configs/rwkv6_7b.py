"""rwkv6-7b [ssm] — 32L d=4096 (attention-free) d_ff=14336 V=65536.

RWKV6 "Finch": data-dependent decay, DDLerp token shift, head size 64
(64 heads).  [arXiv:2404.05892]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("rwkv6-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab_size=65536,
        segments=(("rwkv", 32),),
        rwkv_lora=64, rwkv_chunk=64,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", num_microbatches=4,
    )
