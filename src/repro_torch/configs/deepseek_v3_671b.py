"""deepseek-v3-671b — [moe] 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

MLA attention (latent KV cache + weight-absorbed decode), 3 leading dense
layers (d_ff 18432), 61-3 = 58 MoE layers with 256 routed experts (top-8)
plus 1 shared expert (d_ff 2048 each). The MTP head is omitted (training
objective variant, not a systems feature — DESIGN.md §8). Full attention
-> long_500k skipped.

Port of ``repro/configs/deepseek_v3_671b.py``, the same numbers.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    head_dim=128,
    rope_theta=10000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, d_ff_shared=2048,
                  n_dense_layers=3, d_ff_dense=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, name="deepseek-v3-671b-reduced", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=256, head_dim=16,
        # capacity_factor = E/k = no-drop bound, so reduced-config tests can
        # check prefill/decode vs teacher-forced equivalence exactly (with
        # drops, different batch shapes drop different tokens by design)
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, d_ff_shared=32,
                      n_dense_layers=1, d_ff_dense=128,
                      capacity_factor=4.0),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16))
