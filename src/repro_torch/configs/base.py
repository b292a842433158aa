"""Config schema for the architecture pool + shape suite.

Every assigned architecture is a :class:`ModelConfig` built by its
``src/repro_torch/configs/<id>.py`` factory; ``smoke()`` derives the reduced
variant used by CPU tests.  ``SHAPES`` defines the four assigned input
shapes; applicability (which shapes an arch runs) is resolved by
:func:`cells_for`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = False
    act: str = "silu"


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_inner: int
    n_heads: int
    headdim: int = 64
    d_state: int = 64
    d_conv: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer stack: ((kind, count), ...) — kinds: attn, attn_moe, mla,
    # mla_moe, rwkv, mamba, mamba_shared
    segments: Tuple[Tuple[str, int], ...]
    # attention options
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    gated_mlp: bool = True
    mlp_act: str = "silu"
    tie_embeddings: bool = False
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False
    # MoE / SSM / RWKV / zamba
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv_lora: int = 32
    rwkv_chunk: int = 64
    zamba_period: int = 6
    shared_n_heads: int = 0
    shared_d_ff: int = 0
    # modality frontend (musicgen: 4 EnCodec codebooks)
    n_codebooks: int = 1
    # execution policy.  Training reads remat (per-layer
    # torch.utils.checkpoint in models/model.py::forward while autograd
    # records) and num_microbatches (launch/steps.py::make_train_step);
    # serving reads neither.  scan_layers is kept so that a config equals
    # its reference field for field: layers always run in a Python loop
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"              # none | full | dots
    num_microbatches: int = 1
    scan_layers: bool = True
    # per-config logical-axis remapping (e.g. mixtral TP-in-expert)
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()

    def smoke(self, **kw) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        ratio = max(1, self.d_model // 64)
        moe = self.moe and dataclasses.replace(
            self.moe, n_experts=min(self.moe.n_experts, 8),
            top_k=min(self.top_k_safe(), 2), d_expert=64)
        ssm = self.ssm and dataclasses.replace(
            self.ssm, d_inner=128, n_heads=2, headdim=64, d_state=16,
            chunk=16)
        seg = tuple((kind, min(c, 2)) for kind, c in self.segments)
        repl = dict(
            n_layers=sum(c for _, c in seg), segments=seg, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab_size=256, moe=moe, ssm=ssm,
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            kv_lora_rank=(min(self.kv_lora_rank, 16)
                          if self.kv_lora_rank else 0),
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            rwkv_lora=8, rwkv_chunk=8, zamba_period=2,
            shared_n_heads=4 if self.shared_n_heads else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            sliding_window=(8 if self.sliding_window else None),
            param_dtype="float32", compute_dtype="float32",
            remat="none", num_microbatches=1,
        )
        repl.update(kw)
        return dataclasses.replace(self, **repl)

    def top_k_safe(self) -> int:
        return self.moe.top_k if self.moe else 0


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic archs (DESIGN.md §4)
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "zamba2-2.7b", "mixtral-8x7b")


def cells_for(arch: str):
    """Shapes applicable to ``arch`` (the dry-run cell list)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
