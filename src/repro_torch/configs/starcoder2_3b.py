"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) d_ff=12288 V=49152.

GQA, RoPE, non-gated GELU MLP (StarCoder2 uses a standard MLP).
[arXiv:2402.19173]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("starcoder2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
        d_ff=12288, vocab_size=49152,
        segments=(("attn", 30),),
        rope_theta=1e5, gated_mlp=False, mlp_act="gelu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", num_microbatches=4,
    )
