"""qwen2-vl-7b — [vlm] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only (assignment): the ViT frontend is a stub — the M-RoPE
(t, h, w) position triplets [3, B, S] arrive precomputed from the
frontend (``input_specs`` supplies them); patch embeddings enter the
token stream as ids. M-RoPE sections (16, 24, 24) over head_dim/2 = 64.
Full attention -> long_500k skipped.

Port of ``repro/configs/qwen2_vl_7b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    partial_rotary=1.0,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    mlp_style="swiglu",
    norm_style="rmsnorm",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-7b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        mrope_sections=(4, 2, 2))
