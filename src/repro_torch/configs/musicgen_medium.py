"""musicgen-medium — [audio] 48L d_model=1536 24H (GQA kv=24, i.e. MHA)
d_ff=6144 vocab=2048 — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

Backbone only (assignment): the EnCodec frontend is a stub — inputs are
codebook token ids [B, S, K=4] in the delay interleaving pattern; the
backbone embeds each codebook, sums, and predicts K parallel heads.
Sinusoidal positions, LayerNorm, GELU MLP, no RoPE. Full attention ->
long_500k skipped.

Port of ``repro/configs/musicgen_medium.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    partial_rotary=0.0,
    pos_embed="sinusoidal",
    mlp_style="gelu",
    norm_style="layernorm",
    n_codebooks=4,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="musicgen-medium-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64, n_codebooks=2)
