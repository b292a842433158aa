"""chameleon-34b [vlm] — 48L d=8192 64H (GQA kv=8) d_ff=22016 V=65536.

Early-fusion: VQ image tokens share the text vocabulary, so the modality
frontend is the tokenizer stub — inputs are plain token ids.  qk-norm per
the Chameleon recipe.  [arXiv:2405.09818]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("chameleon-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536,
        segments=(("attn", 48),),
        qk_norm=True, rope_theta=1e4,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=8,
    )
