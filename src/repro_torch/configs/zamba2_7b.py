"""zamba2-7b — [hybrid] 81L d_model=3584 32H (GQA kv=32, i.e. MHA)
d_ff=14336 vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; unverified]

81 Mamba-2 layers with ONE shared transformer block (attn + MLP) applied
every ``attn_layer_period`` layers — the paper's time-multiplexed
centralized-unit pattern (DESIGN.md §4). SSM backbone -> sub-quadratic,
runs long_500k (the periodic shared attention attends over the full
context through its KV cache; noted in the roofline).

Port of ``repro/configs/zamba2_7b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", head_dim=64, d_state=64, d_conv=4,
                  expand=2),
    attn_layer_period=6,
    sub_quadratic=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="zamba2-7b-reduced", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256,
        ssm=SSMConfig(kind="mamba2", head_dim=16, d_state=16, d_conv=4,
                      expand=2),
        attn_layer_period=2)
