"""glm4-9b — [dense] 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA.  [hf:THUDM/glm-4-9b; hf]

GLM style: RMSNorm, partial rotary (half the head dim — the "2d" GLM RoPE
acts on the first half of each head), SwiGLU, qkv bias. Full attention ->
long_500k skipped.

Port of ``repro/configs/glm4_9b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,
    partial_rotary=0.5,
    rope_theta=10000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="glm4-9b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256)
