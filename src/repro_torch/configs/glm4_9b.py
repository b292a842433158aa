"""glm4-9b [dense] — 40L d=4096 32H (GQA kv=2) d_ff=13696 V=151552.

RoPE (partial, 0.5 fraction per GLM convention), GQA.  [hf:THUDM/glm-4-9b]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=151552,
        segments=(("attn", 40),),
        rope_theta=1e4, rope_fraction=0.5,
        gated_mlp=True, mlp_act="silu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=8,
    )
