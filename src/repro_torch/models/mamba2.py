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

A training forward whose sequences are split over a group (``seq``,
``tensor_parallel.Plan.seq``) runs the SSD of each segment from a zero
state on every rank at once, gathers and folds the segments' final
states and total decays (``tensor_parallel.carry_in``) and adds what the
state entering the segment contributes (:func:`ssd_entering`); the
causal conv takes the previous segment's last K - 1 rows as its cache
(``tensor_parallel.prev_rows``).

Under sequence parallelism over the tensor group (``sp``,
``tensor_parallel.Plan.sp``; train and prefill) each rank holds its
segment of the residual stream. A block whose heads split gathers the
normed segments (``seq_whole``, in place of ``copy_to``), runs its
conv and SSD on the whole sequence on its heads, and reduce-scatters its
output onto the segment. One whose heads do not split runs its segment
as over ``seq`` above; a prefill's state is then the whole sequence's
(the carry folded past the last segment, the conv's last K - 1 rows), the
same on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd import ssd
from repro_torch.distributed.tensor_parallel import (Group, carry_in,
                                                     copy_to, last_rows,
                                                     prev_rows, reduce_from)
from repro_torch.models.layers import (Params, _dense_init, _normal, dot,
                                       enter, init_rmsnorm, rmsnorm, row_dot,
                                       use_kernel)
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


def ssd_entering(dt, a_log, c, s_in):
    """What a state ``s_in`` [B, H, P, N] entering a segment adds to its
    SSD output, the segment having run from a zero state: y_t +=
    exp(-exp(a_log) sum_{j<=t} dt_j) S_in c_t, float32 [B, S, H, P] (the
    chunked form's inter-chunk term over the whole segment; the sum is
    inclusive, and its exp at most 1). The state leaving the segment
    gains exp(-exp(a_log) sum_j dt_j) S_in."""
    la = -torch.exp(a_log.to(torch.float32)) * dt.to(torch.float32)
    cum = torch.cumsum(la, dim=1)                        # [B, S, H]
    return torch.einsum("bth,btn,bhpn->bthp", torch.exp(cum),
                        c.to(torch.float32), s_in)


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


def _columns(w: torch.Tensor, spans: list) -> torch.Tensor:
    """The columns (last dim) of ``w`` in ``spans`` [(start, width)], in
    order."""
    return torch.cat([w[..., a:a + n] for a, n in spans], dim=-1)


def head_spans(cfg: ArchConfig, tp: Optional[Group]) -> tuple:
    """(in_proj spans, conv spans) of this rank's heads over ``tp``:
    its z, x and dt columns of ``in_proj`` [z, x, B, C, dt] and all of B
    and C (shared by every head, G = 1); its x channels of the conv's (x,
    B, C) channels and all of B and C. None without a group."""
    if tp is None:
        return None, None
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim // tp.size
    di, n = h * s.head_dim, s.d_state
    i = tp.index
    return ([(i * di, di), (d_inner + i * di, di), (2 * d_inner, 2 * n),
             (2 * d_inner + 2 * n + i * h, h)],
            [(i * di, di), (d_inner, 2 * n)])


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig,
                d_inner: int, tp: Optional[Group]) -> torch.Tensor:
    """rmsnorm(y * silu(z)) over the whole d_inner: on a head shard the
    squares' sum is reduced over ``tp`` before the rsqrt, and the scale
    is this rank's slice. Each rank then uses the sum on its own
    channels, so its gradient is summed over ``tp`` too (``copy_to``
    after ``reduce_from``; ``reduce_from`` alone passes each rank only
    its own channels' share)."""
    if tp is None:
        return rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    yz = y * F.silu(z)
    xf = yz.to(torch.float32)
    di = xf.shape[-1]
    var = copy_to(reduce_from((xf * xf).sum(-1, keepdim=True), tp),
                  tp) / d_inner
    scale = p["norm"]["scale"][tp.index * di:(tp.index + 1) * di]
    return (xf * torch.rsqrt(var + cfg.norm_eps) * scale).to(yz.dtype)


def mamba2_block(p: Params, x: torch.Tensor, cfg: ArchConfig, state: dict,
                 single_step: bool = False, kernels: bool = True,
                 tp: Optional[Group] = None,
                 seq: Optional[Group] = None,
                 sp: Optional[Group] = None) -> tuple[torch.Tensor, dict]:
    """One Mamba-2 block (pre-norm residual).

    state = {"ssm": [B, H, P, N] f32, "conv": [B, K-1, C_conv]}. A
    prefill on the card runs the ``ssd`` kernel unless ``kernels`` is
    False or autograd records it
    (:func:`~repro_torch.models.layers.use_kernel`); elsewhere, and
    then, it runs :func:`ssd_chunked`.

    ``tp``: the heads split over a tensor-parallel group
    (``distributed/tensor_parallel.py``): ``p`` holds this rank's blocks
    of ``a_log`` / ``dt_bias`` / ``d_skip`` and rows of ``out_proj``
    (whole heads), and all of ``in_proj``, ``conv_w``, ``conv_b`` and
    ``norm`` (the rules' column blocks of these are not head-aligned),
    of which it takes its heads' columns (:func:`head_spans`). The normed
    input enters through ``copy_to``, the gated norm reduces its squares
    over the group, and the partial output is summed over it. The state
    holds this rank's heads ([B, H/n, P, N]) and conv channels ([B, K-1,
    x channels of its heads + 2N]).

    ``seq``: ``x`` is this rank's segment of sequences split over a group
    (a zero ``state``): the conv's cache is the previous segment's last
    K - 1 rows, and the state entering the segment is carried in after
    the SSD (:func:`ssd_entering`).

    ``sp``: ``x`` is this rank's segment of sequences split over the
    tensor group (a zero ``state``): over ``tp`` the segments are
    gathered and the output reduce-scattered; without it the segment
    runs as over ``seq``, and the state returned is the whole sequence's.
    """
    s = cfg.ssm
    d = x.shape[-1]
    d_inner = s.expand * d
    in_spans, conv_spans = head_spans(cfg, tp)
    h = d_inner // s.head_dim // (tp.size if tp is not None else 1)
    di = h * s.head_dim                           # this rank's x channels
    if sp is not None and tp is None:             # the segment alone
        seq = sp

    xn = enter(rmsnorm(p["ln"], x, cfg.norm_eps), tp, sp)
    bsz, length, _ = xn.shape
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    if tp is not None:
        w_in, conv_w, conv_b = (_columns(w_in, in_spans),
                                _columns(conv_w, conv_spans),
                                _columns(conv_b, conv_spans))
    zxbcdt = dot(xn, w_in)
    # torch.split takes sizes where jnp.split takes indices
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * s.d_state, h], dim=-1)
    cache = (state["conv"] if seq is None
             else prev_rows(xbc, s.d_conv - 1, seq))
    xbc, conv_cache = _causal_conv(xbc, conv_w, conv_b, cache)
    if seq is not None and sp is not None:        # the whole sequence's
        conv_cache = last_rows(conv_cache, s.d_conv - 1, sp)
    xbc = F.silu(xbc)
    xs, b, c = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # [B, S, H]
    xh = xs.reshape(bsz, length, h, s.head_dim)

    if single_step:
        y, ssm = ssd_step(xh[:, 0], dt[:, 0], p["a_log"], b[:, 0], c[:, 0],
                          state["ssm"])
        y = y[:, None]
    elif use_kernel(kernels, xh, dt, p["a_log"], b, c, state["ssm"]):
        y, ssm = ssd(xh.contiguous(), dt, p["a_log"], b.contiguous(),
                     c.contiguous(), state["ssm"])
    else:
        y, ssm = ssd_chunked(xh, dt, p["a_log"], b, c, state["ssm"])
    if seq is not None:
        decay = (-torch.exp(p["a_log"].to(torch.float32)) * dt).sum(1)
        decay = decay[..., None, None]                   # [B, H, 1, 1]
        # over sp, the state leaving the whole sequence
        s_in, ssm = carry_in(ssm, decay, seq, whole=sp is not None)
        y = (y.to(torch.float32)
             + ssd_entering(dt, p["a_log"], c, s_in)).to(y.dtype)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, length, di)
    y = _gated_norm(p, y, z, cfg, d_inner, tp)
    out = row_dot(y, p["out_proj"], tp, sp)
    return x + out, {"ssm": ssm, "conv": conv_cache}


def init_mamba2_state(cfg: ArchConfig, batch: int,
                      device: torch.device | None = None,
                      tp: Optional[Group] = None) -> dict:
    """A zero state; over ``tp``, this rank's heads and conv channels."""
    s = cfg.ssm
    n = tp.size if tp is not None else 1
    d_inner = s.expand * cfg.d_model // n
    h = d_inner // s.head_dim
    return {"ssm": torch.zeros((batch, h, s.head_dim, s.d_state),
                               device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, d_inner + 2 * s.d_state),
                                dtype=torch.bfloat16, device=device)}
