"""rwkv6-3b — [ssm] 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]

Attention-free linear recurrence: sub-quadratic, runs long_500k.

Port of ``repro/configs/rwkv6_3b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / head_dim (bookkeeping only)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora=64),
    sub_quadratic=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="rwkv6-3b-reduced", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256,
        ssm=SSMConfig(kind="rwkv6", head_dim=32, decay_lora=8))
