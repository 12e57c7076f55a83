"""Unified architecture configuration for the language models; port of
``repro/configs/base.py``.

The dataclasses are the reference's, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    n_dense_layers: int = 0        # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"            # "rwkv6" | "mamba2"
    head_dim: int = 64             # rwkv6 head size / mamba2 head dim
    d_state: int = 64              # mamba2 SSM state per head
    d_conv: int = 4                # mamba2 depthwise conv width
    expand: int = 2                # mamba2 inner expansion
    decay_lora: int = 64           # rwkv6 data-dependent-decay LoRA rank


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False                   # qwen3
    partial_rotary: float = 1.0             # fraction of head_dim rotated
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None  # qwen2-vl M-RoPE (t, h, w) pairs
    mlp_style: str = "swiglu"               # swiglu | gelu
    norm_style: str = "rmsnorm"             # rmsnorm | layernorm
    pos_embed: str = "rope"                 # rope | sinusoidal
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0              # zamba2: shared attn every k
    n_codebooks: int = 0                    # musicgen: EnCodec codebooks
    vision_patches: int = 0                 # qwen2-vl: stub patch count
    sub_quadratic: bool = False             # supports long_500k decode
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, l = self.d_model, self.n_layers
        v = self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb = self.n_codebooks * v * d * 2
        hd = self.resolved_head_dim
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        if self.mlp_style == "swiglu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        if self.family == "ssm":
            s = self.ssm
            inner = d * s.expand if s.kind == "mamba2" else d
            blk = (6 * d * inner if s.kind == "rwkv6"
                   else 2 * d * inner + inner * d) + 3 * d * self.d_ff
            return emb + l * blk
        if self.moe:
            mo = self.moe
            moe_mlp = (mo.n_experts * 3 * d * mo.d_ff_expert
                       + mo.n_shared_experts * 3 * d * mo.d_ff_shared
                       + d * mo.n_experts)
            dense_layers = mo.n_dense_layers
            moe_layers = l - dense_layers
            return (emb + moe_layers * (attn + moe_mlp)
                    + dense_layers * (attn + 3 * d * (mo.d_ff_dense or self.d_ff)))
        if self.family == "hybrid":
            s = self.ssm
            inner = d * s.expand
            mamba_blk = (2 * d * inner + inner * d
                         + inner * (2 * s.d_state) + inner)
            n_shared = 1
            shared_blk = attn + mlp_dense
            return emb + l * mamba_blk + n_shared * shared_blk
        return emb + l * (attn + mlp_dense)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.n_params()
        d, l, mo = self.d_model, self.n_layers, self.moe
        full = self.n_params()
        all_experts = (l - mo.n_dense_layers) * mo.n_experts * 3 * d * mo.d_ff_expert
        active = (l - mo.n_dense_layers) * mo.top_k * 3 * d * mo.d_ff_expert
        return full - all_experts + active
