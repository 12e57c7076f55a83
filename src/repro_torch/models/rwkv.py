"""RWKV-6 "Finch" block (arXiv:2404.05892), data-dependent-decay linear
attention, the ``ssm`` family; port of ``repro/models/rwkv.py``.

The wide r/k/v/g projections are the "synaptic" half (large matrix
products, ``torch.matmul``); the WKV state recurrence is the "neuronal"
half, a small stateful update per head. Three ways to run the
recurrence:

* ``kernels.wkv6.wkv6`` — the hand-written CUDA kernel, which the
  prefill runs on the card (the reference's docstring: on the real chip
  the kernel replaces the chunked path);
* :func:`wkv6_chunked` — parallel within chunks of C tokens (einsum
  form, causal decay ratios in log space), a loop over the chunks
  carrying the [H, N, N] state; what prefill runs on the CPU, as the
  reference's model does everywhere, and on the card when asked
  (``kernels=False``);
* :func:`wkv6_step` — the exact recurrence for single-token decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import (Params, _dense_init, _normal, dot,
                                       init_rmsnorm, rmsnorm)

# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_rwkv_block(cfg: ArchConfig, gen: Optional[torch.Generator],
                    device: torch.device) -> Params:
    d = cfg.d_model
    s = cfg.ssm
    lora = s.decay_lora
    n_heads = d // s.head_dim
    f32 = torch.float32

    def dense(shape, dtype=torch.bfloat16):
        return _dense_init(gen, shape, device, dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    return {
        "time_mix": {
            # base lerp coefficients for the 5 ddlerp streams (w,k,v,r,g)
            "mu_base": full((d,), 0.0),
            "mu": full((5, d), 0.0),
            # ddlerp LoRA: tanh(x W1) W2 per stream
            "lora_w1": dense((d, 5 * 32), f32),
            "lora_w2": dense((5, 32, d), f32),
            # data-dependent decay LoRA
            "w0": full((d,), -6.0),                # exp(-exp(-6)) ~ .9975
            "w1": dense((d, lora), f32),
            "w2": dense((lora, d), f32),
            "wr": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "wg": dense((d, d)),
            "u": _normal(gen, (n_heads, s.head_dim), device, 0.1),
            "ln_x": {"scale": full((d,), 1.0), "bias": full((d,), 0.0)},
            "wo": dense((d, d)),
        },
        "channel_mix": {
            "mu_k": full((d,), 0.5),
            "mu_r": full((d,), 0.5),
            "wk": dense((d, cfg.d_ff)),
            "wv": dense((cfg.d_ff, d)),
            "wr": dense((d, d)),
        },
        "ln1": init_rmsnorm(d, device),
        "ln2": init_rmsnorm(d, device),
    }


# ---------------------------------------------------------------------------
# WKV-6 core
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) of a [B, S, ...] tensor by ``pad``."""
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def wkv6_chunked(r, k, v, w_log, u, state, chunk: int = 64):
    """Chunked WKV-6.

    r/k/v [B, S, H, N]; w_log [B, S, H, N] = log(decay) <= 0;
    u [H, N] bonus; state [B, H, N, N] (key-major: S[k_dim, v_dim]).
    Returns (y [B, S, H, N] in r's dtype, state' float32).

    Per head: S_t = diag(w_t) S_{t-1} + k_t v_t^T,
              y_t = S_{t-1}^T r_t + (r_t . (u*k_t)) v_t.
    ``chunk`` trades the O(S C H N) intra-chunk ratio tensor against
    O(S/C H N^2) state hops. The reference also reads it, and a bf16
    ratio switch, from the environment; the port takes the argument only.
    """
    b, s, h, n = r.shape
    c = chunk
    pad = -s % c
    if pad:
        r, k, v, w_log = (_pad_seq(x, pad) for x in (r, k, v, w_log))
    st = state.to(torch.float32)
    uf = u.to(torch.float32)
    idx = torch.arange(c, device=r.device)
    mask = idx[:, None] > idx[None, :]
    ys = []
    for lo in range(0, s + pad, c):
        rb, kb, vb, wb = (x[:, lo:lo + c].to(torch.float32)
                          for x in (r, k, v, w_log))        # [B, C, H, N]
        la = torch.cumsum(wb, dim=1)                # logA_t (inclusive)
        la_prev = la - wb                           # logA_{t-1} (exclusive)
        # inter-chunk: y_t += (r_t * A_{t-1})^T S_0
        y = torch.einsum("bchk,bhkn->bchn", rb * torch.exp(la_prev), st)
        # intra-chunk, strictly causal: ratio A_{t-1}/A_s, s < t, in log
        # space (diff <= 0 under the mask, so exp never overflows)
        diff = la_prev[:, :, None] - la[:, None, :]   # [B, T, S, H, N]
        ratio = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                      -1e30))
        att = torch.einsum("bthk,bshk,btshk->bths", rb, kb, ratio)
        y = y + torch.einsum("bths,bshn->bthn", att, vb)
        # current-token bonus: (r_t . (u * k_t)) v_t
        bonus = torch.einsum("bchk,hk,bchk->bch", rb, uf, kb)
        y = y + bonus[..., None] * vb
        # state: S' = diag(A_C) S_0 + sum_s diag(A_C/A_s) k_s v_s^T
        la_end = la[:, -1][:, None]                  # [B, 1, H, N]
        k_dec = kb * torch.exp(la_end - la)
        st = st * torch.exp(la_end[:, 0])[..., None] \
            + torch.einsum("bshk,bshn->bhkn", k_dec, vb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] if ys else r.new_zeros(r.shape)
    return y.to(r.dtype), st


def wkv6_step(r, k, v, w_log, u, state):
    """Single-token recurrence. r/k/v/w_log [B, H, N]; state [B, H, N, N]."""
    rf, kf, vf = (x.to(torch.float32) for x in (r, k, v))
    y = torch.einsum("bhk,bhkn->bhn", rf, state) \
        + torch.einsum("bhk,hk,bhk->bh", rf, u.to(torch.float32),
                       kf)[..., None] * vf
    state = state * torch.exp(w_log.to(torch.float32))[..., None] \
        + torch.einsum("bhk,bhn->bhkn", kf, vf)
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift (5 streams: w, k, v, r, g)."""
    delta = x_prev - x
    base = x + delta * p["mu_base"].to(x.dtype)
    lora = torch.tanh(dot(base.to(torch.float32), p["lora_w1"]))
    lora = lora.reshape(*base.shape[:-1], 5, 32)
    mix = p["mu"] + torch.einsum("...fk,fkd->...fd", lora, p["lora_w2"])
    return x[..., None, :] + delta[..., None, :] * mix.to(x.dtype)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x one token later: x_prev [B, D] first, then x[:, :-1]."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                  x_prev: torch.Tensor, state: torch.Tensor,
                  single_step: bool = False, kernels: bool = True):
    """x [B, S, D] (prefill) or [B, 1, D] (decode).

    x_prev [B, D]: last token of the previous call (token shift across
    boundaries); state [B, H, N, N]. A prefill on the card runs the
    ``wkv6`` kernel unless ``kernels`` is False; elsewhere, and then, it
    runs :func:`wkv6_chunked`.
    """
    b, s, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd

    streams = _ddlerp(p, x, _shift(x, x_prev))         # [B, S, 5, D]
    xw, xk, xv, xr, xg = streams.unbind(2)

    w_log = -torch.exp(p["w0"] + dot(torch.tanh(dot(xw.to(torch.float32),
                                                    p["w1"])), p["w2"]))
    r = dot(xr, p["wr"]).reshape(b, s, h, hd)
    k = dot(xk, p["wk"]).reshape(b, s, h, hd)
    v = dot(xv, p["wv"]).reshape(b, s, h, hd)
    g = F.silu(dot(xg, p["wg"]))
    w_log = w_log.reshape(b, s, h, hd)

    if single_step:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w_log[:, 0],
                             p["u"], state)
        y = y[:, None]
    elif kernels and r.is_cuda:
        y, state = wkv6(r, k, v, w_log, p["u"], state)
    else:
        y, state = wkv6_chunked(r, k, v, w_log, p["u"], state)

    # per-head groupnorm (ln_x; population variance) then gate
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = yf.reshape(b, s, d) * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    out = dot(yf.to(x.dtype) * g, p["wo"])
    return out, x[:, -1], state


def rwkv_channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    shifted = _shift(x, x_prev)
    xk = x + (shifted - x) * p["mu_k"].to(x.dtype)
    xr = x + (shifted - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(dot(xk, p["wk"])))
    return torch.sigmoid(dot(xr, p["wr"])) * dot(k, p["wv"]), x[:, -1]


def rwkv_block(p: Params, x: torch.Tensor, cfg: ArchConfig, state: dict,
               single_step: bool = False,
               kernels: bool = True) -> tuple[torch.Tensor, dict]:
    """One RWKV-6 block. state = {tm_x, cm_x [B,D], wkv [B,H,N,N]}."""
    a, tm_x, wkv = rwkv_time_mix(
        p["time_mix"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
        x_prev=state["tm_x"], state=state["wkv"], single_step=single_step,
        kernels=kernels)
    x = x + a
    c, cm_x = rwkv_channel_mix(
        p["channel_mix"], rmsnorm(p["ln2"], x, cfg.norm_eps),
        x_prev=state["cm_x"])
    x = x + c
    return x, {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv}


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                    device: torch.device | None = None) -> dict:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    h = d // hd
    return {"tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, hd, hd), device=device)}
