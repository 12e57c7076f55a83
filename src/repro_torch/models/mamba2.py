"""Mamba-2 SSD block (arXiv:2405.21060), the state-space half of Zamba2
(arXiv:2411.15242), the ``hybrid`` family; port of
``repro/models/mamba2.py``.

The in/out projections are the "synaptic" half (dense products,
``torch.matmul``); the [H, P, N] recurrent state is the "neuronal" half,
small, stateful and sequential. Three ways to run the recurrence, as in
:mod:`repro_torch.models.rwkv`:

* ``kernels.ssd.ssd`` — the hand-written CUDA kernel, which the prefill
  runs on the card;
* :func:`ssd_chunked` — matrix-form SSD within chunks (quadratic in the
  chunk, linear across chunks through the carried state); what prefill
  runs on the CPU, as the reference's model does everywhere, and on the
  card when asked (``kernels=False``);
* :func:`ssd_step` — the exact single-token recurrence for decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd import ssd
from repro_torch.models.layers import (Params, _dense_init, _normal, dot,
                                       init_rmsnorm, rmsnorm)
from repro_torch.models.rwkv import _pad_seq


def init_mamba2_block(cfg: ArchConfig, gen: Optional[torch.Generator],
                      device: torch.device) -> Params:
    d = cfg.d_model
    s = cfg.ssm
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    n_conv = d_inner + 2 * s.d_state
    # single fused in-projection: [z, x, B, C, dt]
    d_in_proj = 2 * d_inner + 2 * s.d_state + n_heads
    return {
        "in_proj": _dense_init(gen, (d, d_in_proj), device),
        # depthwise conv over the (x, B, C) channels
        "conv_w": _normal(gen, (s.d_conv, n_conv), device, 0.1),
        "conv_b": torch.zeros((n_conv,), device=device),
        "dt_bias": torch.zeros((n_heads,), device=device),
        # A is a per-head scalar (SSD restriction), stored as log
        "a_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones((n_heads,), device=device),
        "norm": init_rmsnorm(d_inner, device),
        "out_proj": _dense_init(gen, (d_inner, d), device),
        "ln": init_rmsnorm(d, device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, a_log, b, c, state, chunk: int = 64):
    """Chunked SSD (Mamba-2 alg. 1, matrix form).

    x   [B, S, H, P]   inputs per head
    dt  [B, S, H]      softplus'd step sizes (>= 0)
    a_log [H]          log(-A) per head; decay = exp(-exp(a_log) * dt)
    b   [B, S, N]      input->state projection  (shared across heads, G=1)
    c   [B, S, N]      state->output projection
    state [B, H, P, N] carried SSM state.
    Returns (y [B, S, H, P] in x's dtype, state' float32).

    Discrete recurrence per head/channel:
      S_t = exp(a_t) S_{t-1} + dt_t * x_t b_t^T,   a_t = -exp(a_log) dt_t
      y_t = S_t c_t  (+ D x_t skip added by the caller)
    """
    s = x.shape[1]
    cs = chunk
    pad = -s % cs
    if pad:
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    neg_a = torch.exp(a_log.to(torch.float32))          # [H] = -A > 0
    st = state.to(torch.float32)
    idx = torch.arange(cs, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    ys = []
    for lo in range(0, s + pad, cs):
        xb, dtb, bb, cb = (t[:, lo:lo + cs].to(torch.float32)
                           for t in (x, dt, b, c))
        # log decays within the chunk
        la = -neg_a[None, None, :] * dtb                 # [B, C, H] (<= 0)
        cum = torch.cumsum(la, dim=1)                    # inclusive logA_t
        # inter-chunk contribution: y_t += (exp(cum_t) * c_t) . S_0
        y = torch.einsum("bch,bcn,bhpn->bchp", torch.exp(cum), cb, st)
        # intra-chunk, causal (t >= s): ratio exp(cum_t - cum_s)
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # [B, T, S, H]
        ratio = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
        att = torch.einsum("btn,bsn,btsh->btsh", cb, bb, ratio)
        y = y + torch.einsum("btsh,bsh,bshp->bthp", att, dtb, xb)
        # state: S' = exp(cum_C) S_0 + sum_s exp(cum_C - cum_s) dt_s x_s b_s^T
        la_end = cum[:, -1]                              # [B, H]
        k_dec = torch.exp(la_end[:, None] - cum) * dtb   # [B, C, H]
        st = st * torch.exp(la_end)[..., None, None] \
            + torch.einsum("bch,bchp,bcn->bhpn", k_dec, xb, bb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else x.new_zeros(x.shape)
    return y.to(x.dtype), st


def ssd_step(x, dt, a_log, b, c, state):
    """Single-token SSD recurrence.

    x [B, H, P]; dt [B, H]; b/c [B, N]; state [B, H, P, N].
    """
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf, cf = b.to(torch.float32), c.to(torch.float32)
    decay = torch.exp(-torch.exp(a_log.to(torch.float32))[None, :] * dtf)
    state = state * decay[..., None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dtf, xf, bf)
    y = torch.einsum("bhpn,bn->bhp", state, cf)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv1d. x [B, S, C]; w [K, C]; cache [B, K-1, C].

    Returns (y [B, S, C], new_cache [B, K-1, C]); the input and cache
    meet in their promoted dtype, as ``jnp.concatenate`` makes them.
    """
    k = w.shape[0]
    if cache is None:
        cache = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    dt = torch.promote_types(cache.dtype, x.dtype)
    xe = torch.cat([cache.to(dt), x.to(dt)], dim=1)      # [B, S+K-1, C]
    y = sum(xe[:, i:i + x.shape[1]] * w[i][None, None, :].to(x.dtype)
            for i in range(k))
    y = y + b.to(x.dtype)
    new_cache = xe[:, -(k - 1):].clone() if k > 1 else cache
    return y, new_cache


def mamba2_block(p: Params, x: torch.Tensor, cfg: ArchConfig, state: dict,
                 single_step: bool = False,
                 kernels: bool = True) -> tuple[torch.Tensor, dict]:
    """One Mamba-2 block (pre-norm residual).

    state = {"ssm": [B, H, P, N] f32, "conv": [B, K-1, C_conv]}. A
    prefill on the card runs the ``ssd`` kernel unless ``kernels`` is
    False; elsewhere, and then, it runs :func:`ssd_chunked`.
    """
    s = cfg.ssm
    bsz, seq, d = x.shape
    d_inner = s.expand * d
    h = d_inner // s.head_dim

    xn = rmsnorm(p["ln"], x, cfg.norm_eps)
    zxbcdt = dot(xn, p["in_proj"])
    # torch.split takes sizes where jnp.split takes indices
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * s.d_state, h],
                             dim=-1)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xbc = F.silu(xbc)
    xs, b, c = torch.split(xbc, [d_inner, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # [B, S, H]
    xh = xs.reshape(bsz, seq, h, s.head_dim)

    if single_step:
        y, ssm = ssd_step(xh[:, 0], dt[:, 0], p["a_log"], b[:, 0], c[:, 0],
                          state["ssm"])
        y = y[:, None]
    elif kernels and xh.is_cuda:
        y, ssm = ssd(xh.contiguous(), dt, p["a_log"], b.contiguous(),
                     c.contiguous(), state["ssm"])
    else:
        y, ssm = ssd_chunked(xh, dt, p["a_log"], b, c, state["ssm"])
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, seq, d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = dot(y, p["out_proj"])
    return x + out, {"ssm": ssm, "conv": conv_cache}


def init_mamba2_state(cfg: ArchConfig, batch: int,
                      device: torch.device | None = None) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    return {"ssm": torch.zeros((batch, h, s.head_dim, s.d_state),
                               device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, d_inner + 2 * s.d_state),
                                dtype=torch.bfloat16, device=device)}
