"""Building blocks of the language models; port of
``repro/models/layers.py``: norms, RoPE (partial, and M-RoPE's three
position streams), sinusoidal positions, chunked attention, GQA
attention, MLA (Multi-head Latent Attention), the MLPs and the heads.

Parameters are nested dicts of tensors, as the reference's pytrees are,
made by ``init_*`` functions from a ``torch.Generator`` on ``device``
(``generator=None`` with ``device="meta"`` makes the shapes alone). As
in the reference, everything computes in the parameters' dtype (bf16)
with float32 islands for norms, softmax and the recurrent states, and
attention over a long prompt is chunked (the online-softmax recurrence
over KV chunks, never the [S, S] score matrix).

The reference names a ``repro.kernels.flash_attention`` Pallas kernel
that does not exist, so attention has no kernel to port:
:func:`chunked_attention` is plain torch, and so are MLA, M-RoPE and the
sinusoidal positions, which the reference computes in plain ``jnp``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.tensor_parallel import (Group, capacity_rows,
                                                     copy_to, narrow_seq,
                                                     reduce_from, scatter_to,
                                                     seq_whole)
from repro_torch.kernels._build import needs_grad

Params = dict  # nested dict of tensors

NEG_INF = -1e30


def use_kernel(kernels: bool, *tensors: torch.Tensor) -> bool:
    """Whether a whole-sequence recurrence (``wkv6``, ``ssd``) on
    ``tensors`` runs its CUDA kernel: on the card, unless ``kernels`` is
    False or autograd records the call. The kernels have no backward; the
    chunked forms, which autograd differentiates, run instead."""
    return kernels and tensors[0].is_cuda and not needs_grad(*tensors)


def enter(x: torch.Tensor, tp: Optional[Group],
          sp: Optional[Group] = None) -> torch.Tensor:
    """The input of a region split over ``tp``: :func:`~repro_torch.
    distributed.tensor_parallel.copy_to`, or under sequence parallelism
    (``sp``) the segments gathered (``seq_whole``); ``x`` itself
    where nothing is split (a layer that runs on the segment alone)."""
    if tp is None:
        return x
    return copy_to(x, tp) if sp is None else seq_whole(x, sp)


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
    # scaled in place: one float32 copy of the leaf at a time (deepseek-v3's
    # [256, 7168, 2048] expert leaf is 15 GB in float32)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


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


def init_layernorm(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # as jnp.var
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings: standard, partial and M-RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    """inv_freq [dim // 2] float32."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: Optional[int] = None,
               mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by ``positions``: [..., S] integers
    for 1-D RoPE, or [3, ..., S] for M-RoPE (the (t, h, w) position
    streams of qwen2-vl, arXiv:2409.12191: ``mrope_sections`` splits the
    rd / 2 frequency slots, each section driven by its own stream).

    rotary_dim: rotate only the first ``rotary_dim`` features (partial
    RoPE); the rest passes through unchanged.
    """
    d = x.shape[-1]
    rd = rotary_dim or d
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    inv_freq = rope_frequencies(rd, theta, x.device)           # [rd/2]
    if mrope_sections is not None:
        if positions.shape[0] != 3:
            raise ValueError(f"M-RoPE needs [3, ...] positions, got "
                             f"{tuple(positions.shape)}")
        freqs, start = [], 0
        for sec, pos in zip(mrope_sections, positions):
            freqs.append(pos[..., None].to(torch.float32)
                         * inv_freq[start:start + sec])
            start += sec
        freqs = torch.cat(freqs, dim=-1)                       # [..., S, rd/2]
    else:
        freqs = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(freqs)[..., None, :]                       # [..., S, 1, rd/2]
    sin = torch.sin(freqs)[..., None, :]
    x1, x2 = x_rot.to(torch.float32).chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin,
                     x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    return torch.cat([rot, x_pass], dim=-1) if rd < d else rot


def sinusoidal_positions(seq_len: int, d: int,
                         device: torch.device | None = None) -> torch.Tensor:
    """MusicGen-style additive sinusoidal embedding [S, D] float32 (the
    reference's numpy table: sin on the even features, cos on the odd)."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq_len, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out).to(device)


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


def init_attention(cfg: ArchConfig, gen: Optional[torch.Generator],
                   device: torch.device) -> Params:
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    p = {"wq": _dense_init(gen, (d, h * dh), device),
         "wk": _dense_init(gen, (d, hkv * dh), device),
         "wv": _dense_init(gen, (d, hkv * dh), device),
         "wo": _dense_init(gen, (h * dh, d), device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), device=device)
        p["bk"] = torch.zeros((hkv * dh,), device=device)
        p["bv"] = torch.zeros((hkv * dh,), device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, device)
        p["k_norm"] = init_rmsnorm(dh, device)
    return p


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor,
              kv_cache: Optional[tuple] = None,
              cache_len: Optional[torch.Tensor] = None,
              chunk: int = 1024,
              return_kv: bool = False,
              tp: Optional[Group] = None,
              cap: Optional[Group] = None,
              seq: Optional[Group] = None,
              sp: Optional[Group] = None
              ) -> tuple[torch.Tensor, Optional[tuple]]:
    """GQA attention. x [B, S, D].

    Prefill: kv_cache None -> causal self-attention over x; with
    ``return_kv`` the rotated (k, v) come back as a capacity-S bf16
    cache. Decode: kv_cache (k [B, Smax, Hkv, Dh], v) with ``cache_len``
    valid entries (a 0-dim integer tensor); x is the new token(s). The
    new entries are written into the cache IN PLACE (the reference's
    serve step donates the state for the same end) and the cache is
    returned; ``cache_len + S`` must not exceed Smax.

    ``tp``: the heads split over a tensor-parallel group
    (``distributed/tensor_parallel.py``): ``p`` holds this rank's column
    blocks of ``wq`` / ``bq`` and row block of ``wo`` (and of the K/V
    projections where the K/V heads divide, else all of them), the cache
    the K/V heads the rank holds, and the partial output is summed over
    the group. Each rank attends with its own q heads, over their groups
    of K/V heads.

    ``cap``: the cache's capacity split over a group (every K/V head,
    this rank's rows [i c, (i + 1) c); the reference's placement where
    the K/V heads do not divide, ``launch/specs.py`` ``_state_sharding``):
    the prefill keeps this rank's rows (:func:`~repro_torch.distributed.
    tensor_parallel.capacity_rows`), and decode is :func:`_split_decode`.

    ``seq``: ``x`` is this rank's segment of sequences split over a group
    (``Plan.seq``, the training forward): the rank projects and rotates
    its own segment (``positions`` start at its offset), gathers the K/V
    of every segment (the gather's backward reduce-scatters their
    gradients) and attends causally over the keys up to its last query:
    the first segment scans its own keys, the last all of them.

    ``sp``: ``x`` is this rank's segment of sequences split over the
    tensor group (``Plan.sp``; train and prefill), ``positions`` the
    whole sequence's. With the heads split over ``tp`` the segments are
    gathered on entry and the output reduce-scattered onto the segment
    (sequence parallelism); else the segment attends alone, as over
    ``seq``, and a prefill's cache is its own rows: the capacity rows of
    a cache split over ``cap`` (the same group, C = S).
    """
    if sp is not None and tp is None:        # the segment alone
        seq, positions = sp, narrow_seq(positions, sp, -1)
    x = enter(x, tp, sp)
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q, k, v = dot(x, p["wq"]), dot(x, p["wk"]), dot(x, p["wv"])
    h, hkv = q.shape[-1] // dh, k.shape[-1] // dh    # this rank's heads
    if cfg.qkv_bias:    # the float32 bias cast first, as the reference does
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    rd = int(dh * cfg.partial_rotary)
    if rd > 0:
        q = apply_rope(q, positions, cfg.rope_theta, rd, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, rd, cfg.mrope_sections)

    groups = _kv_groups(cfg, tp, h, hkv)
    if kv_cache is None and seq is not None:
        first = seq.index * s
        kv = seq_whole(torch.stack([k, v], 2), seq)[:, :first + s]
        out = chunked_attention(q, kv[:, :, 0, groups], kv[:, :, 1, groups],
                                causal=True, chunk=chunk, q_offset=first)
        new_cache = (_own_rows(cap, seq, k, v) if return_kv else None)
    elif kv_cache is None:
        out = chunked_attention(q, k[:, :, groups], v[:, :, groups],
                                causal=True, chunk=chunk)
        new_cache = (tuple(capacity_rows(t.to(torch.bfloat16), cap)
                           for t in (k, v)) if return_kv else None)
    elif cap is not None:
        out = _split_decode(q, k, v, kv_cache, cache_len, tp,
                            cap).to(x.dtype)
        new_cache = kv_cache
    else:
        ck, cv = kv_cache
        new_pos = cache_len + torch.arange(s, device=x.device)
        ck.index_copy_(1, new_pos, k.to(ck.dtype))
        cv.index_copy_(1, new_pos, v.to(cv.dtype))
        # grouped-query einsum: the cache is never repeated to the full
        # head count; the rep axis lives on q and the scores only
        ka, va = ck[:, :, groups], cv[:, :, groups]
        smax, g = ka.shape[1], ka.shape[2]
        rep = h // g
        qg = q.reshape(b, s, g, rep, dh) * (1.0 / math.sqrt(dh))
        scores = torch.einsum("bsgrd,bkgd->bgrsk", qg.to(torch.float32),
                              ka.to(torch.float32))
        valid = torch.arange(smax, device=x.device)[None, :] <= new_pos[:, None]
        scores = torch.where(valid[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrsk,bkgd->bsgrd", probs, va.to(torch.float32))
        out = out.reshape(b, s, h, dh).to(x.dtype)
        new_cache = (ck, cv)

    return row_dot(out.reshape(b, s, h * dh), p["wo"], tp, sp), new_cache


def _own_rows(cap: Optional[Group], seq: Group, *ts: torch.Tensor) -> tuple:
    """A segment's cache entries ``ts`` [B, s, ...] as its capacity rows
    (bf16): the prefill of a sequence split over ``seq`` into a cache
    split over ``cap`` on its capacity, C = S (rank i's rows [i s, (i + 1)
    s) are its segment; no gather)."""
    if cap is None or cap.dim != seq.dim:
        raise ValueError(f"a segment's cache needs its capacity split over "
                         f"the segments' group {seq.dim!r}, not {cap}")
    return tuple(t.to(torch.bfloat16) for t in ts)


def _write_owned(caches: tuple, news: tuple, cache_len: torch.Tensor,
                 first: int) -> None:
    """Write row t of each of ``news`` [B, S, ...] into its capacity-split
    ``caches`` [B, c, ...] at position ``cache_len + t`` where this rank
    (rows [first, first + c)) owns it: a local index and a mask, no host
    read, no branch on ``cache_len``, so a CUDA graph captures it."""
    c = caches[0].shape[1]
    for t in range(news[0].shape[1]):
        local = cache_len.long() + (t - first)
        mine = (local >= 0) & (local < c)
        idx = local.clamp(0, c - 1).reshape(1)
        for cache, new in zip(caches, news):
            old = cache.index_select(1, idx)
            cache.index_copy_(1, idx, torch.where(
                mine, new[:, t:t + 1].to(cache.dtype), old))


def _merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    cap: Group) -> torch.Tensor:
    """Flash decoding's merge over ``cap`` of each rank's partial softmax:
    its max ``m``, l = sum exp(s - m) and o = sum exp(s - m) v (float32,
    ``o`` with one more trailing dim): M = max m, then the sums of l
    exp(m - M) and o exp(m - M), out = o / l. A rank with no valid row
    has m = NEG_INF, whose weight exp(m - M) is 0 (with -inf, s - m is
    NaN)."""
    m_all = cap.all_reduce(m, "max")
    w = torch.exp(m - m_all)
    l, o = cap.all_reduce(l * w), cap.all_reduce(o * w[..., None])
    return o / l[..., None]


def _all_heads(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """``x`` [B, S, h, d] of this rank's heads -> every rank's [B, S,
    n h, d], gathered over ``tp`` in rank order (``x`` itself without a
    group)."""
    if tp is None:
        return x
    b, s, h, d = x.shape
    return tp.all_gather(x).permute(1, 2, 0, 3, 4).reshape(b, s,
                                                           tp.size * h, d)


def _split_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_cache: tuple, cache_len: torch.Tensor,
                  tp: Optional[Group], cap: Group) -> torch.Tensor:
    """Decode over a cache split on its capacity over ``cap`` (flash
    decoding): this rank holds rows [i c, (i + 1) c) of every K/V head.
    The rank that owns position ``cache_len + t`` writes row t (a local
    index and a mask, :func:`_write_owned`). Every rank scores all q
    heads (gathered over ``tp`` where the heads are split) against its
    rows, masked by global position, keeping its max m, l = sum exp(s -
    m) and o = sum exp(s - m) v; the partials merge over ``cap``
    (:func:`_merge_partials`). Returns this rank's heads' output [B, S,
    h, Dh] in float32.
    Decode has no backward: the collectives are not autograd ops."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("the capacity-split decode has no backward; "
                           "call it under torch.no_grad()")
    ck, cv = kv_cache
    b, s, h, dh = q.shape
    c = ck.shape[1]
    first = cap.index * c                        # this rank's first row
    _write_owned((ck, cv), (k, v), cache_len, first)
    f32 = torch.float32
    # scaled in q's dtype, then cast: the plain decode's rounding; every
    # q head, in rank order
    qf = _all_heads((q * (1.0 / math.sqrt(dh))).to(f32), tp)
    heads, g = qf.shape[2], ck.shape[2]
    qg = qf.reshape(b, s, g, heads // g, dh)
    scores = torch.einsum("bsgrd,bkgd->bgrsk", qg, ck.to(f32))
    new_pos = cache_len + torch.arange(s, device=q.device)
    rows = first + torch.arange(c, device=q.device)
    valid = rows[None, :] <= new_pos[:, None]                 # [S, c]
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    m = scores.amax(-1)                                       # [B, g, r, S]
    p = torch.exp(scores - m[..., None])
    out = _merge_partials(m, p.sum(-1),
                          torch.einsum("bgrsk,bkgd->bgrsd", p, cv.to(f32)),
                          cap)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, heads, dh)
    if tp is not None:
        out = out[:, :, tp.index * h:(tp.index + 1) * h]
    return out


def _kv_groups(cfg: ArchConfig, tp: Optional[Group], h: int,
               hkv: int) -> slice:
    """The K/V heads this rank's ``h`` q heads attend with, of the
    ``hkv`` it holds: all of them, unless the q heads are split over
    ``tp`` and the K/V heads are not (each rank holds every K/V head and
    takes its own q heads' groups)."""
    if tp is None or hkv != cfg.n_kv_heads:
        return slice(None)
    rep = cfg.n_heads // cfg.n_kv_heads
    first = tp.index * h // rep
    return slice(first, first + max(1, h // rep))


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, gen: Optional[torch.Generator],
             device: torch.device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": _dense_init(gen, (d, m.q_lora_rank), device),
        "q_a_norm": init_rmsnorm(m.q_lora_rank, device),
        "wq_b": _dense_init(gen, (m.q_lora_rank, h * qk_dim), device),
        "wkv_a": _dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                             device),
        "kv_a_norm": init_rmsnorm(m.kv_lora_rank, device),
        "wkv_b": _dense_init(gen, (m.kv_lora_rank,
                                   h * (m.qk_nope_head_dim + m.v_head_dim)),
                             device),
        "wo": _dense_init(gen, (h * m.v_head_dim, d), device),
    }


def mla_attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                  positions: torch.Tensor,
                  kv_cache: Optional[tuple] = None,
                  cache_len: Optional[torch.Tensor] = None,
                  chunk: int = 1024,
                  return_kv: bool = False,
                  tp: Optional[Group] = None,
                  cap: Optional[Group] = None,
                  seq: Optional[Group] = None,
                  sp: Optional[Group] = None
                  ) -> tuple[torch.Tensor, Optional[tuple]]:
    """MLA. x [B, S, D]. Queries, keys and values pass through low-rank
    latents; the cache holds only the normed KV latent [B, C, r] and the
    decoupled RoPE key [B, C, rope_d], both bf16.

    Prefill: kv_cache None -> the latent expanded to per-head K/V once
    and causal chunked attention with scale 1/sqrt(nope + rope_d); with
    ``return_kv`` the (latent, k_rope) cache of capacity S. Decode: the
    WEIGHT-ABSORBED form over the latent cache, never expanded per head
    (``wkv_b`` folded into the query and output sides, arXiv:2412.19437
    §2.1); the new rows are written into the cache IN PLACE, as
    :func:`attention` writes its K/V. The scores and the weighted sum
    over the cache are the reference's bf16 products summed in float32,
    here as float32 einsums over the cache cast to float32.

    ``tp``: the heads split over a tensor-parallel group: ``p`` holds
    this rank's column blocks of ``wq_b`` / ``wkv_b`` (whole heads) and
    row block of ``wo``, and all of ``wq_a`` / ``wkv_a`` and the latent
    norms, computed whole on every rank. The normed latents and the RoPE
    key enter the per-head products through ``copy_to`` (their gradients
    summed over the group, so ``wq_a`` / ``wkv_a`` get whole gradients;
    ``x`` is not marked again), and the partial output is summed over
    the group.

    ``cap``: the cache's capacity split over a group (this rank's rows
    [i c, (i + 1) c) of the latent and the RoPE key; ``Plan.cap``): the
    prefill keeps this rank's rows (:func:`~repro_torch.distributed.
    tensor_parallel.capacity_rows`), and decode is
    :func:`_split_mla_decode`, whose latent-space output is rounded once
    to ``x``'s dtype before ``w_bv``, as the whole decode's is.

    ``seq``: ``x`` is this rank's segment of sequences split over a
    group (``Plan.seq``, the training forward): the rank projects its
    own segment and rotates ``q`` and the RoPE key at its positions (they
    start at its offset), gathers the normed latent and the RoPE key of
    the segments up to its last query (the gather's backward
    reduce-scatters their gradients; r + rope_d values a token, where the
    per-head K/V would be h (nope + v + rope_d)), expands them through
    ``wkv_b`` and attends causally from its offset.

    ``sp``: ``x`` is this rank's segment of sequences split over the
    tensor group (``Plan.sp``), ``positions`` the whole sequence's. With
    the heads split over ``tp``, the latent projections and norms run on
    the segment, and the normed latents and the RoPE key are gathered
    into the per-head products (``seq_whole``, in place of
    ``copy_to``), the output reduce-scattered onto the segment; the
    prefill's cache is the segment's latent rows, its capacity rows over
    ``cap`` (C = S). MLA has no segment path of its own: where its heads
    do not split (reduced configs only) the segments are gathered, the
    layer computed whole on every rank and its segment of the output
    kept.
    """
    if sp is not None and tp is None:        # gathered, whole, narrowed
        out, cache = mla_attention(p, seq_whole(x, sp), cfg,
                                   positions=positions, chunk=chunk,
                                   return_kv=return_kv, cap=cap)
        return narrow_seq(out, sp), cache
    m = cfg.mla
    b, s, _ = x.shape
    nope, rope_d, vdim, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                             m.v_head_dim, m.kv_lora_rank)
    h = p["wq_b"].shape[-1] // (nope + rope_d)          # this rank's heads
    whole = positions
    if sp is not None:            # the segment's own rows and positions
        positions = narrow_seq(positions, sp, -1)

    cq = enter(rmsnorm(p["q_a_norm"], dot(x, p["wq_a"]), cfg.norm_eps), tp,
               sp)
    s = cq.shape[1]                      # the gathered sequence under sp
    q = dot(cq, p["wq_b"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, whole, cfg.rope_theta)
    kv_a = dot(x, p["wkv_a"])                          # [B, S, r + rope_d]
    latent = rmsnorm(p["kv_a_norm"], kv_a[..., :r], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:][..., None, :], positions,
                        cfg.rope_theta)                # [B, S, 1, rope_d]
    scale = 1.0 / math.sqrt(nope + rope_d)

    if kv_cache is None:
        first, keys, rope_k = 0, latent, k_rope
        if seq is not None:       # the segments up to this rank's last query
            first = seq.index * s
            both = seq_whole(torch.cat([latent, k_rope[:, :, 0]], -1),
                             seq)[:, :first + s]
            keys, rope_k = both[..., :r], both[..., None, r:]
        keys = enter(keys, tp, sp)
        sk = keys.shape[1]
        kv = dot(keys, p["wkv_b"]).reshape(b, sk, h, nope + vdim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k_rope_h = enter(rope_k, tp, sp).to(k_nope.dtype).expand(b, sk, h,
                                                                 rope_d)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        out = chunked_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                causal=True, chunk=chunk, scale=scale,
                                q_offset=first)
        out = row_dot(out.reshape(b, s, h * vdim), p["wo"], tp, sp)
        if not return_kv:
            new_cache = None
        elif sp is not None:
            new_cache = _own_rows(cap, sp, latent, k_rope[:, :, 0])
        else:
            new_cache = tuple(capacity_rows(t.to(torch.bfloat16), cap)
                              for t in (latent, k_rope[:, :, 0]))
        return out, new_cache

    c_lat, c_kr = kv_cache
    w_b = p["wkv_b"].reshape(r, h, nope + vdim)
    w_bk, w_bv = w_b[..., :nope], w_b[..., nope:]
    dt = torch.promote_types(q_nope.dtype, w_bk.dtype)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(dt), w_bk.to(dt))
    f32 = torch.float32
    if cap is not None:
        lat_out = _split_mla_decode(q_abs, q_rope, latent, k_rope[:, :, 0],
                                    kv_cache, cache_len, scale, tp, cap)
    else:
        new_pos = cache_len + torch.arange(s, device=x.device)
        c_lat.index_copy_(1, new_pos, latent.to(c_lat.dtype))
        c_kr.index_copy_(1, new_pos, k_rope[:, :, 0].to(c_kr.dtype))
        scores = (torch.einsum("bshr,bkr->bhsk", q_abs.to(f32),
                               c_lat.to(f32))
                  + torch.einsum("bshd,bkd->bhsk", q_rope.to(f32),
                                 c_kr.to(f32))) * scale
        valid = (torch.arange(c_lat.shape[1], device=x.device)[None, :]
                 <= new_pos[:, None])
        scores = torch.where(valid[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        lat_out = torch.einsum("bhsk,bkr->bshr", probs, c_lat.to(f32))
    dt = torch.promote_types(x.dtype, w_bv.dtype)
    out = torch.einsum("bshr,rhv->bshv", lat_out.to(x.dtype).to(dt),
                       w_bv.to(dt))
    out = row_dot(out.reshape(b, s, h * vdim), p["wo"], tp)
    return out, (c_lat, c_kr)


def _split_mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor,
                      latent: torch.Tensor, k_rope: torch.Tensor,
                      kv_cache: tuple, cache_len: torch.Tensor,
                      scale: float, tp: Optional[Group],
                      cap: Group) -> torch.Tensor:
    """MLA's absorbed decode over a cache split on its capacity over
    ``cap`` (flash decoding in the latent space): this rank holds rows
    [i c, (i + 1) c) of the latent and the RoPE key. The owner of
    position ``cache_len + t`` writes the new ``latent`` [B, S, r] and
    ``k_rope`` [B, S, dr] rows (:func:`_write_owned`); every rank scores
    all heads' ``q_abs`` [B, S, h, r] and ``q_rope`` [B, S, h, dr]
    (gathered over ``tp`` where the heads are split) against its rows,
    masked by global position, and keeps (m, l, o) with o [.., r] in
    float32; the partials merge over ``cap`` (:func:`_merge_partials`).
    Returns this rank's heads' latent output [B, S, h, r] in float32.
    Decode has no backward: the collectives are not autograd ops."""
    if torch.is_grad_enabled() and q_abs.requires_grad:
        raise RuntimeError("the capacity-split decode has no backward; "
                           "call it under torch.no_grad()")
    c_lat, c_kr = kv_cache
    b, s, h, _ = q_abs.shape
    c = c_lat.shape[1]
    first = cap.index * c                        # this rank's first row
    _write_owned((c_lat, c_kr), (latent, k_rope), cache_len, first)
    f32 = torch.float32
    qa, qr = (_all_heads(q.to(f32), tp) for q in (q_abs, q_rope))
    lat = c_lat.to(f32)
    scores = (torch.einsum("bshr,bkr->bhsk", qa, lat)
              + torch.einsum("bshd,bkd->bhsk", qr, c_kr.to(f32))) * scale
    new_pos = cache_len + torch.arange(s, device=q_abs.device)
    rows = first + torch.arange(c, device=q_abs.device)
    valid = rows[None, :] <= new_pos[:, None]                 # [S, c]
    scores = torch.where(valid[None, None], scores, NEG_INF)
    m = scores.amax(-1)                                       # [B, H, S]
    p = torch.exp(scores - m[..., None])
    out = _merge_partials(m, p.sum(-1),
                          torch.einsum("bhsk,bkr->bhsr", p, lat), cap)
    out = out.permute(0, 2, 1, 3)                             # [B, S, H, r]
    if tp is not None:
        out = out[:, :, tp.index * h:(tp.index + 1) * h]
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d: int, d_ff: int, style: str, gen: Optional[torch.Generator],
             device: torch.device) -> Params:
    if style == "swiglu":
        return {"w_gate": _dense_init(gen, (d, d_ff), device),
                "w_up": _dense_init(gen, (d, d_ff), device),
                "w_down": _dense_init(gen, (d_ff, d), device)}
    return {"w_up": _dense_init(gen, (d, d_ff), device),
            "w_down": _dense_init(gen, (d_ff, d), device)}


def mlp(p: Params, x: torch.Tensor, style: str,
        tp: Optional[Group] = None, sp: Optional[Group] = None,
        gathered: bool = False) -> torch.Tensor:
    """``tp``: d_ff split over a tensor-parallel group (``p`` this
    rank's column blocks of ``w_gate`` / ``w_up`` and row block of
    ``w_down``), the partial output summed over the group. ``sp``: ``x``
    is this rank's segment; split over ``tp`` the MLP runs on the
    gathered sequence and returns its segment of the sum, else on the
    segment alone (token-wise: no collective). ``gathered``: ``x`` is
    the gathered sequence already (the MoE's shared experts), and the
    output is this rank's segment, of the sum or of the whole."""
    if not gathered:
        x = enter(x, tp, sp)
    if style == "swiglu":
        # silu(g) * u in float32 and rounded once, as XLA's fusion of the
        # reference computes it: rounding silu(g) to bf16 first made a
        # reduced glm4-9b's bf16 decode logits 1.6x as far from float32
        # as the reference's own
        g = dot(x, p["w_gate"])
        h = (F.silu(g.to(torch.float32)) * dot(x, p["w_up"])).to(g.dtype)
    else:          # jax.nn.gelu's default is the tanh form
        h = F.gelu(dot(x, p["w_up"]), approximate="tanh")
    out = row_dot(h, p["w_down"], tp, sp)
    return narrow_seq(out, sp) if gathered and tp is None else out


def row_dot(a: torch.Tensor, w: torch.Tensor,
            tp: Optional[Group] = None,
            sp: Optional[Group] = None) -> torch.Tensor:
    """``dot(a, w)``; over a tensor-parallel group (``a``'s last dim and
    ``w``'s rows this rank's block) the partial products are formed in
    float32, summed over the group and rounded once: the plain product's
    float32 accumulation, split (rounding each partial to bf16 first
    moved a reduced qwen3-moe's first loss by 2e-4 through flipped MoE
    routes). ``sp``: ``a`` [B, S, ...] spans the gathered sequence, and
    the float32 sum is reduce-scattered onto this rank's segment before
    the one rounding (``scatter_to``)."""
    if tp is None:
        return dot(a, w)
    dt = torch.promote_types(a.dtype, w.dtype)
    f32 = torch.float32
    part = a.to(f32) @ w.to(f32)
    return (reduce_from(part, tp) if sp is None
            else scatter_to(part, sp)).to(dt)


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
