"""stablelm-12b — [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-12b; hf]

StableLM-2 style: LayerNorm, partial rotary (25% of head dim), SwiGLU MLP,
qkv biases. Full attention -> long_500k skipped.

Port of ``repro/configs/stablelm_12b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    qkv_bias=True,
    partial_rotary=0.25,
    rope_theta=10000.0,
    mlp_style="swiglu",
    norm_style="layernorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="stablelm-12b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
