"""deepseek-v2-236b [moe] — 60L d=5120 128H d_ff(expert)=1536 V=102400.

MLA kv_lora=512 (q_lora=1536, qk_nope=128, qk_rope=64, v_head=128);
MoE: 2 shared + 160 routed experts, top-6, first layer dense (d_ff=12288).
Expert parallelism: 160 experts over model=16 → 10 experts/chip.
[arXiv:2405.04434]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoECfg


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288, vocab_size=102400,
        segments=(("mla", 1), ("mla_moe", 59)),
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        moe=MoECfg(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                   capacity_factor=1.25, norm_topk=True),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=8,
    )
