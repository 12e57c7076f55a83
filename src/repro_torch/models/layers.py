"""Building blocks of the language models; port of
``repro/models/layers.py``, only what the ``ssm`` and ``hybrid``
families use.

Parameters are nested dicts of tensors, as the reference's pytrees are,
made by ``init_*`` functions from a ``torch.Generator`` on ``device``
(``generator=None`` with ``device="meta"`` makes the shapes alone). As
in the reference, everything computes in the parameters' dtype (bf16)
with float32 islands for norms, softmax and the recurrent states, and
attention over a long prompt is chunked (the online-softmax recurrence
over KV chunks, never the [S, S] score matrix).

Not ported (they raise ``NotImplementedError``): layernorm, M-RoPE,
attention's qkv bias and qk-norm, the gelu MLP and MLA (ROADMAP Queue A
item 8). The reference names a ``repro.kernels.flash_attention`` Pallas
kernel that does not exist, so attention has no kernel to port:
:func:`chunked_attention` is plain torch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = dict  # nested dict of tensors

NOT_PORTED = "not ported yet; see ROADMAP Queue A item 8"
NEG_INF = -1e30


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp``'s ``@`` takes mixed
    dtypes (bf16 @ float32 is a float32 product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _dense_init(gen: Optional[torch.Generator], shape: tuple,
                device: torch.device, dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    1/sqrt(fan_in), fan_in = shape[-2] (shape[0] for a vector)."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(fan_in))).to(dtype)


def _normal(gen: Optional[torch.Generator], shape: tuple,
            device: torch.device, std: float) -> torch.Tensor:
    """N(0, std^2) in float32."""
    return torch.randn(shape, generator=gen, device=device) * std


def _embed_init(gen: Optional[torch.Generator], shape: tuple,
                device: torch.device, dtype=torch.bfloat16) -> torch.Tensor:
    return _normal(gen, shape, device, 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "bias" in p:
        raise NotImplementedError(f"layernorm is {NOT_PORTED}")
    return rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings: standard and partial
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    """inv_freq [dim // 2] float32."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: Optional[int] = None,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by ``positions`` [..., S] (1-D RoPE).

    rotary_dim: rotate only the first ``rotary_dim`` features (partial
    RoPE); the rest passes through unchanged.
    """
    if mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE is {NOT_PORTED}")
    d = x.shape[-1]
    rd = rotary_dim or d
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    inv_freq = rope_frequencies(rd, theta, x.device)           # [rd/2]
    freqs = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(freqs)[..., None, :]                       # [..., S, 1, rd/2]
    sin = torch.sin(freqs)[..., None, :]
    x1, x2 = x_rot.to(torch.float32).chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin,
                     x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    return torch.cat([rot, x_pass], dim=-1) if rd < d else rot


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 1024,
                      scale: Optional[float] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention.

    q [B, Sq, H, Dh], k/v [B, Sk, Hkv, Dh] (GQA broadcast on the fly).
    Loops over KV chunks carrying (m, l, acc), the flash-attention
    recurrence, so peak memory is O(Sq * chunk), not O(Sq * Sk). The
    reference pads the last chunk and masks the pad; here it is shorter,
    which adds the same nothing. q_offset: absolute position of q[0].
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)

    qf = q.to(torch.float32) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, dv), device=q.device)
    for lo in range(0, sk, chunk):
        kb = k[:, lo:lo + chunk].repeat_interleave(rep, dim=2).to(torch.float32)
        vb = v[:, lo:lo + chunk].repeat_interleave(rep, dim=2).to(torch.float32)
        s = torch.einsum("bqhd,bchd->bhqc", qf, kb)          # [B, H, Sq, C]
        if causal:
            k_pos = lo + torch.arange(kb.shape[1], device=q.device)
            valid = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)               # [B, Sq, H, Dh]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def _check_attention(cfg: ArchConfig) -> None:
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(f"attention's qkv bias and qk-norm are "
                                  f"{NOT_PORTED}")


def init_attention(cfg: ArchConfig, gen: Optional[torch.Generator],
                   device: torch.device) -> Params:
    _check_attention(cfg)
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    return {"wq": _dense_init(gen, (d, h * dh), device),
            "wk": _dense_init(gen, (d, hkv * dh), device),
            "wv": _dense_init(gen, (d, hkv * dh), device),
            "wo": _dense_init(gen, (h * dh, d), device)}


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor,
              kv_cache: Optional[tuple] = None,
              cache_len: Optional[torch.Tensor] = None,
              chunk: int = 1024,
              return_kv: bool = False) -> tuple[torch.Tensor, Optional[tuple]]:
    """GQA attention. x [B, S, D].

    Prefill: kv_cache None -> causal self-attention over x; with
    ``return_kv`` the rotated (k, v) come back as a capacity-S bf16
    cache. Decode: kv_cache (k [B, Smax, Hkv, Dh], v) with ``cache_len``
    valid entries (a 0-dim integer tensor); x is the new token(s). The
    new entries are written into the cache IN PLACE (the reference's
    serve step donates the state for the same end) and the cache is
    returned; ``cache_len + S`` must not exceed Smax.
    """
    _check_attention(cfg)
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    q = dot(x, p["wq"]).reshape(b, s, h, dh)
    k = dot(x, p["wk"]).reshape(b, s, hkv, dh)
    v = dot(x, p["wv"]).reshape(b, s, hkv, dh)
    rd = int(dh * cfg.partial_rotary)
    if rd > 0:
        q = apply_rope(q, positions, cfg.rope_theta, rd, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, rd, cfg.mrope_sections)

    if kv_cache is None:
        out = chunked_attention(q, k, v, causal=True, chunk=chunk)
        new_cache = ((k.to(torch.bfloat16), v.to(torch.bfloat16))
                     if return_kv else None)
    else:
        ck, cv = kv_cache
        new_pos = cache_len + torch.arange(s, device=x.device)
        ck.index_copy_(1, new_pos, k.to(ck.dtype))
        cv.index_copy_(1, new_pos, v.to(cv.dtype))
        # grouped-query einsum: the cache is never repeated to the full
        # head count; the rep axis lives on q and the scores only
        smax = ck.shape[1]
        rep = h // hkv
        qg = q.reshape(b, s, hkv, rep, dh) * (1.0 / math.sqrt(dh))
        scores = torch.einsum("bsgrd,bkgd->bgrsk", qg.to(torch.float32),
                              ck.to(torch.float32))
        valid = torch.arange(smax, device=x.device)[None, :] <= new_pos[:, None]
        scores = torch.where(valid[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrsk,bkgd->bsgrd", probs, cv.to(torch.float32))
        out = out.reshape(b, s, h, dh).to(x.dtype)
        new_cache = (ck, cv)

    out = dot(out.reshape(b, s, h * dh), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(d: int, d_ff: int, style: str, gen: Optional[torch.Generator],
             device: torch.device) -> Params:
    if style != "swiglu":
        raise NotImplementedError(f"the {style!r} MLP is {NOT_PORTED}")
    return {"w_gate": _dense_init(gen, (d, d_ff), device),
            "w_up": _dense_init(gen, (d, d_ff), device),
            "w_down": _dense_init(gen, (d_ff, d), device)}


def mlp(p: Params, x: torch.Tensor, style: str) -> torch.Tensor:
    if style != "swiglu":
        raise NotImplementedError(f"the {style!r} MLP is {NOT_PORTED}")
    return dot(F.silu(dot(x, p["w_gate"])) * dot(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, d: int, gen: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
    return _embed_init(gen, (vocab, d), device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for integer ``tokens`` (in range: unlike
    ``jnp.take``, an index out of range is an error, not clamped)."""
    return F.embedding(tokens, table)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """Logits in float32."""
    w = table_or_head.T if tied else table_or_head
    return x.to(torch.float32) @ w.to(torch.float32)
