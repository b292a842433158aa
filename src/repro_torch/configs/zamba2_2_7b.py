"""zamba2-2.7b [hybrid] — 54L d=2560 (Mamba2) + shared attn, V=32000.

Mamba2 backbone (d_inner=5120, 80 heads × headdim 64, state 64) with a
single globally-shared attention+MLP block applied every 6th layer on
concat(x, x_embed) (width 5120, 32 heads), per the Zamba2 recipe.
ssm_state=64.  [arXiv:2411.15242]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, SSMCfg


@register("zamba2-2.7b")
def config() -> ModelConfig:
    # 54 layers = 9 × (5 mamba + 1 mamba_shared)
    segments = (("mamba", 5), ("mamba_shared", 1)) * 9
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000,
        segments=segments,
        ssm=SSMCfg(d_inner=5120, n_heads=80, headdim=64, d_state=64,
                   d_conv=4, chunk=64),
        zamba_period=6, shared_n_heads=32, shared_d_ff=10240,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=4,
    )
