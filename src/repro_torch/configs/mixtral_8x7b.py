"""mixtral-8x7b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=14336 V=32000.

8 experts top-2, sliding-window attention (4096).  Experts (8) don't divide
the model axis (16), so this config remaps expert parallelism to
TP-within-expert: experts replicated, each expert's d_ff sharded.
[arXiv:2401.04088]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoECfg


@register("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000,
        segments=(("attn_moe", 32),),
        sliding_window=4096, rope_theta=1e6,
        moe=MoECfg(n_experts=8, top_k=2, d_expert=14336, n_shared=0,
                   capacity_factor=1.25, norm_topk=True),
        sharding_overrides=(("experts", None), ("expert_mlp", "model")),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat="full", num_microbatches=4,
    )
