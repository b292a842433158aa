"""minicpm3-4b [dense] — 62L d=2560 40H d_ff=6400 V=73448 — MLA.

MLA ranks per HF config: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
v_head=64.  [hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=6400, vocab_size=73448,
        segments=(("mla", 62),),
        q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64,
        rope_theta=1e4,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=4,
    )
