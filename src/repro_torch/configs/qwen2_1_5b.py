"""qwen2-1.5b — [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671; hf]

Qwen2: RMSNorm, full rotary, SwiGLU, qkv bias, tied embeddings,
rope_theta=1e6. Full attention -> long_500k skipped.

Port of ``repro/configs/qwen2_1_5b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    partial_rotary=1.0,
    rope_theta=1e6,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="qwen2-1.5b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
