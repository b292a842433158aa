"""musicgen-medium [audio] — 48L d=1536 24H (MHA) d_ff=6144 V=2048.

Decoder-only over EnCodec tokens (4 codebooks, delay pattern); the EnCodec
frontend is a stub — inputs are (B, S, 4) codebook ids and input_specs()
provides them precomputed.  Non-gated GELU MLP.  [arXiv:2306.05284]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048,
        segments=(("attn", 48),),
        rope_theta=1e4, gated_mlp=False, mlp_act="gelu",
        n_codebooks=4,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", num_microbatches=2,
    )
