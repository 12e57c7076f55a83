"""chatglm3-6b — [dense] 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA.  [arXiv:2406.12793; hf]

ChatGLM3: RMSNorm, 2d RoPE (rotary over half the head dim), SwiGLU,
qkv bias. Full attention -> long_500k skipped.

Port of ``repro/configs/chatglm3_6b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    partial_rotary=0.5,
    rope_theta=10000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="chatglm3-6b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
