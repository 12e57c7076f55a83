"""The Mamba-2 SSD recurrence in one CUDA kernel; port of
``repro/kernels/ssd.py``.

zamba2's state-space half, the same design as
:mod:`repro_torch.kernels.wkv6`: the per-head state S [P, N] stays on
chip for the whole sequence, x/dt/b/c are read once and y written once.
:func:`ssd` launches ``csrc/ssd.cu`` for CUDA tensors and runs
:func:`~repro_torch.kernels.ref.ssd_ref`, its plain torch version, for
CPU tensors; its design and what bounds it on the H100 are noted in the
source. The reference's ``chunk`` argument has no counterpart: the
kernel's chunk is ``ssm_chunks.CHUNK``. :func:`ssd_emulated` replays the
kernel's chunked schedule and its bf16 roundings in plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import count_launch
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssm_chunks import (CHUNK, cumsum_seq, pad_chunks,
                                            split_terms, tc_dot,
                                            term_counts)
from repro_torch.kernels.wkv6 import HEAD_SIZES, check_args

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = HEAD_SIZES               # N: the kernel's register row
MAX_HEAD_DIM = 128                     # P: one thread per state row


def ssd_emulated(x, dt, a_log, b, c, state0):
    """``csrc/ssd.cu``'s schedule replayed in plain torch, for the tests.

    Same arguments and results as :func:`ssd`. Per chunk of ``CHUNK``
    tokens (the tail zero-filled): ``cum`` is the running sum of
    ``-exp(a_log) dt`` taken token by token; ``y = exp(cum_t) (c S0^T)``
    plus ``M x`` with ``M[t, s] = (c_t . b_s) exp(cum_t - cum_s) dt_s``
    for ``s <= t``; then ``S = exp(cum_end) S + (x coef)^T b`` with
    ``coef_s = dt_s exp(cum_end - cum_s)``. Every product takes its
    operands as the kernel rounds them: x, b, c as inputs, S0, M and
    ``x coef`` as derived terms (:func:`~repro_torch.kernels.ssm_chunks.
    term_counts`).
    """
    n_in, n_der = term_counts(x.dtype)
    bsz, s, h, p = x.shape
    xp, dtp, bp, cp = (pad_chunks(t.to(torch.float32)) for t in (x, dt, b, c))
    neg_a = torch.exp(a_log.to(torch.float32))
    st = state0.to(torch.float32)
    causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    causal = causal.to(x.device)[None, :, :, None]          # s <= t
    ys = []
    for t0 in range(0, xp.shape[1], CHUNK):
        xc, dtc = xp[:, t0:t0 + CHUNK], dtp[:, t0:t0 + CHUNK]
        bc, cc = bp[:, t0:t0 + CHUNK], cp[:, t0:t0 + CHUNK]
        cum = cumsum_seq(-neg_a * dtc, 1)                      # [B, C, H]
        b_in, c_in = split_terms(bc, n_in), split_terms(cc, n_in)
        y = tc_dot("btn,bhpn->bthp", c_in, split_terms(st, n_der))
        y = y * torch.exp(cum)[..., None]
        g = tc_dot("btn,bsn->bts", c_in, b_in)
        diff = cum[:, :, None] - cum[:, None]                  # [B, T, S, H]
        m = g[..., None] * torch.exp(diff.clamp(max=0.0)) * dtc[:, None]
        m = torch.where(causal, m, torch.zeros((), device=m.device))
        y = y + tc_dot("btsh,bshp->bthp", split_terms(m, n_der),
                       split_terms(xc, n_in))
        end = cum[:, -1]                                       # [B, H]
        coef = dtc * torch.exp(end[:, None] - cum)
        st = st * torch.exp(end)[..., None, None] + tc_dot(
            "bshp,bsn->bhpn", split_terms(xc * coef[..., None], n_der), b_in)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :s] if ys else x.new_zeros(x.shape)
    return y.to(x.dtype), st


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, state0: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over a whole sequence: ``(y, state)``.

    x [B, S, H, P] and b/c [B, S, N] of one dtype, float32 or bfloat16
    (b and c shared by the heads); dt [B, S, H] (softplus'd, >= 0) and
    a_log [H] float32; state0 [B, H, P, N] float32; all contiguous on one
    device; 1 <= P <= ``MAX_HEAD_DIM``, N in ``STATE_SIZES``. Returns y
    [B, S, H, P] in x's dtype (``y_t = S_t c_t``, without the D-skip) and
    the final state [B, H, P, N] float32. CUDA tensors launch
    ``csrc/ssd.cu`` (counted in ``ssd.launches``); CPU tensors run
    :func:`~repro_torch.kernels.ref.ssd_ref`. The kernel has no
    backward: on the card, an input that requires grad under grad mode
    raises ``RuntimeError``.
    """
    if x.ndim != 4 or b.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b.shape)}: want "
                         f"[B, S, H, P] and [B, S, N]")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if n not in STATE_SIZES or not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"P={p}, N={n}: the kernel takes 1 <= P <= "
                         f"{MAX_HEAD_DIM} and N in {STATE_SIZES}")
    io = tuple(_KERNEL_DTYPES)
    check_args({"x": x, "dt": dt, "a_log": a_log, "b": b, "c": c,
                "state0": state0},
               {"x": (bsz, s, h, p), "dt": (bsz, s, h), "a_log": (h,),
                "b": (bsz, s, n), "c": (bsz, s, n),
                "state0": (bsz, h, p, n)},
               {"x": io, "dt": (torch.float32,), "a_log": (torch.float32,),
                "b": (x.dtype,), "c": (x.dtype,),
                "state0": (torch.float32,)})
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a_log, b, c, state0)
    _build.refuse_grad("ssd", x, dt, a_log, b, c, state0)
    y = torch.empty_like(x)
    state = torch.empty_like(state0)
    if bsz * h:
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            err = lib.suprasnn_ssd(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), state0.data_ptr(), y.data_ptr(),
                state.data_ptr(), _KERNEL_DTYPES[x.dtype], bsz, s, h, p, n,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ssd")
        count_launch(ssd)
    return y, state


ssd.launches = 0
