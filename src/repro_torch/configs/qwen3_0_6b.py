"""qwen3-0.6b [dense] — 28L d=1024 16H (GQA kv=8) d_ff=3072 V=151936.

qk-norm, GQA, head_dim=128 (decoupled from d_model), tied embeddings.
[hf:Qwen/Qwen3-0.6B]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936,
        segments=(("attn", 28),),
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="dots", num_microbatches=8,
    )
