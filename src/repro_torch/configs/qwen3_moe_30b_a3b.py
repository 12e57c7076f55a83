"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 — 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3: RMSNorm, qk-norm, head_dim=128, rope_theta=1e6, no shared expert,
per-expert d_ff=768. Full attention -> long_500k skipped.

Port of ``repro/configs/qwen3_moe_30b_a3b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-30b-a3b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        # E/k capacity: no token drops -> exact prefill/decode equivalence
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=4.0))
