"""The RWKV-6 WKV recurrence in one CUDA kernel; port of
``repro/kernels/wkv6.py``.

The per-head state S [N, N] is the "neuronal" half (small, stateful,
sequential) and the r/k/v/w streams the "synaptic" half (big,
streamed): the kernel keeps S on chip for the whole sequence and reads
each stream once and writes y once. :func:`wkv6` launches
``csrc/wkv6.cu`` for CUDA tensors and runs
:func:`~repro_torch.kernels.ref.wkv6_ref`, its plain torch version, for
CPU tensors; its design and what bounds it on the H100 are noted in the
source. The reference's ``chunk`` argument has no counterpart: the
kernel's chunk is ``ssm_chunks.CHUNK``, and any sequence length is taken
as it is. :func:`wkv6_emulated` replays the kernel's chunked schedule,
its route choice per sub-chunk (:func:`wkv6_routes`) and its bf16
roundings in plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launches import count_launch
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.kernels.ssm_chunks import (CHUNK, SPAN_MAX, SUB,
                                            cumsum_seq, pad_chunks,
                                            split_terms, tc_dot,
                                            term_counts)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (8, 16, 32, 64)           # N: the kernel's register columns


def check_args(named: dict[str, torch.Tensor],
               shapes: dict[str, tuple[int, ...]],
               dtypes: dict[str, tuple[torch.dtype, ...]]) -> None:
    """Raise ``ValueError`` unless every tensor has its shape and one of
    its dtypes, lies on the first one's device and is contiguous."""
    dev = next(iter(named.values())).device
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
        if t.dtype not in dtypes[name]:
            raise ValueError(f"{name} dtype {t.dtype}: want one of "
                             f"{dtypes[name]}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the kernels run on cuda or cpu, not {dev}")


def _chunk_logs(w_log: torch.Tensor) -> list[torch.Tensor]:
    """Per chunk, the running log-decay ``la`` [B, C, H, N]: the sum of
    w_log over the chunk up to each token (inclusive), token by token."""
    wp = pad_chunks(w_log.to(torch.float32))
    return [cumsum_seq(wp[:, t0:t0 + CHUNK], 1)
            for t0 in range(0, wp.shape[1], CHUNK)]


def _starts(la: torch.Tensor) -> list[torch.Tensor]:
    """E_i [B, H, N] for each sub-chunk i: the running log-decay just
    before its first token (0 for the first sub-chunk)."""
    return [la[:, i * SUB - 1] if i else torch.zeros_like(la[:, 0])
            for i in range(CHUNK // SUB)]


def _span(la: torch.Tensor, i: int) -> torch.Tensor:
    """Sub-chunk i's decay span [B, H]: ``max_k (E_i - la_last)``."""
    return (_starts(la)[i] - la[:, i * SUB + SUB - 1]).amax(-1)


def wkv6_routes(w_log: torch.Tensor) -> torch.Tensor:
    """The kernel's route for each diagonal block: bool [B, H, chunks,
    CHUNK // SUB], True where the sub-chunk's decay span is below
    ``SPAN_MAX`` (factorized, tensor cores), False where its scores are
    summed in log space (CUDA cores)."""
    return torch.stack([torch.stack([_span(la, i) < SPAN_MAX
                                     for i in range(CHUNK // SUB)], -1)
                        for la in _chunk_logs(w_log)], 2)


def wkv6_emulated(r, k, v, w_log, u, state0):
    """``csrc/wkv6.cu``'s schedule replayed in plain torch, for the tests.

    Same arguments and results as :func:`wkv6`. Per chunk of ``CHUNK``
    tokens (the tail zero-filled), with ``la`` the running log-decay,
    ``lp`` the same one token earlier (0 at the chunk's start), ``E_i``
    ``lp`` at sub-chunk i's first token and ``la_e(j)`` ``la`` at
    sub-chunk j's last:

    * ``Q_t = r_t exp(lp_t - E_i)`` (t in sub-chunk i) and ``K_s = k_s
      exp(la_e(j) - la_s)`` (s in sub-chunk j), both <= 1;
    * inter-chunk: ``y = (Q exp(E_i)) S0``;
    * scores ``att[t, s] = Q_t . (K_s rho_ij)``, ``rho_ij = exp(E_i -
      la_e(j))``, for s in a sub-chunk j < i, and for s < t in sub-chunk
      i where its span ``max_k (E_i - la_e(i))`` is below ``SPAN_MAX``;
      past it ``sum_k r_t k_s exp(lp_t - la_s)`` in float32;
    * ``att[t, t] = r_t . (u k_t)``, the bonus; ``y += att v``;
    * ``S = diag(exp(la_end)) S + (K exp(la_end - la_e(j)))^T v``.

    Every product takes its operands as the kernel rounds them: r, k, v
    as inputs, S0, the decayed factors and att as derived terms
    (:func:`~repro_torch.kernels.ssm_chunks.term_counts`).
    """
    n_in, n_der = term_counts(r.dtype)
    bsz, s, h, n = r.shape
    rp, kp, vp = (pad_chunks(t.to(torch.float32)) for t in (r, k, v))
    uf = u.to(torch.float32)
    st = state0.to(torch.float32)
    zero = torch.zeros((), device=r.device)
    ar = torch.arange(SUB, device=r.device)
    strict = (ar[:, None] > ar[None, :])                   # s < t
    sub_of = torch.arange(CHUNK, device=r.device) // SUB
    ys = []
    for c, la in enumerate(_chunk_logs(w_log)):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        rc, kc, vc = rp[:, sl], kp[:, sl], vp[:, sl]       # [B, C, H, N]
        lp = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], 1)
        starts = _starts(la)
        ends = [la[:, i * SUB + SUB - 1] for i in range(CHUNK // SUB)]
        start_t = torch.stack(starts, 1)[:, sub_of]        # [B, C, H, N]
        end_t = torch.stack(ends, 1)[:, sub_of]
        q = rc * torch.exp(lp - start_t)
        kq = kc * torch.exp(end_t - la)
        y = tc_dot("bthk,bhkn->bthn",
                   split_terms(q * torch.exp(start_t), n_der),
                   split_terms(st, n_der))
        att = rc.new_zeros(bsz, h, CHUNK, CHUNK)
        for i in range(CHUNK // SUB):
            ti = slice(i * SUB, (i + 1) * SUB)
            qi = split_terms(q[:, ti], n_der)
            tc = (_span(la, i) < SPAN_MAX)[:, None, :, None]   # [B,1,H,1]
            for j in range(i + 1):
                sj = slice(j * SUB, (j + 1) * SUB)
                arg = starts[i] - ends[j]
                if j == i:                                 # may not factor
                    arg = torch.where(tc[:, 0], arg, zero)
                kd = kq[:, sj] * torch.exp(arg)[:, None]
                a = tc_dot("bthk,bshk->bhts", qi, split_terms(kd, n_der))
                if j == i:
                    diff = lp[:, ti, None] - la[:, None, ti]   # [B,T,S,H,N]
                    a_log = torch.einsum("bthk,bshk,btshk->bhts", rc[:, ti],
                                         kc[:, ti],
                                         torch.exp(diff.clamp(max=0.0)))
                    a = torch.where(strict, torch.where(
                        tc[:, 0, :, :, None], a, a_log), zero)
                att[:, :, ti, sj] = a
        bonus = (rc * uf * kc).sum(-1)                     # [B, C, H]
        att = att + torch.diag_embed(bonus.transpose(1, 2))
        y = y + tc_dot("bhts,bshn->bthn", split_terms(att, n_der),
                       split_terms(vc, n_in))
        last = la[:, -1]                                   # [B, H, N]
        kd = kq * torch.exp(last[:, None] - end_t)
        st = st * torch.exp(last)[..., None] + tc_dot(
            "bshk,bshn->bhkn", split_terms(kd, n_der), split_terms(vc, n_in))
        ys.append(y)
    y = torch.cat(ys, 1)[:, :s] if ys else r.new_zeros(r.shape)
    return y.to(r.dtype), st


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over a whole sequence: ``(y, state)``.

    r/k/v [B, S, H, N] of one dtype, float32 or bfloat16; w_log [B, S,
    H, N] float32 (log-decay, <= 0); u [H, N] and state0 [B, H, N, N]
    float32; all contiguous on one device; N in ``HEAD_SIZES``. Returns
    y [B, S, H, N] in r's dtype and the final state [B, H, N, N] float32.
    CUDA tensors launch ``csrc/wkv6.cu`` (counted in ``wkv6.launches``);
    CPU tensors run :func:`~repro_torch.kernels.ref.wkv6_ref`. The
    kernel has no backward: on the card, an input that requires grad
    under grad mode raises ``RuntimeError``.
    """
    if r.ndim != 4:
        raise ValueError(f"r shape {tuple(r.shape)}: want [B, S, H, N]")
    b, s, h, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n}: the kernel takes {HEAD_SIZES}")
    seq = (b, s, h, n)
    io = tuple(_KERNEL_DTYPES)
    check_args({"r": r, "k": k, "v": v, "w_log": w_log, "u": u,
                "state0": state0},
               {"r": seq, "k": seq, "v": seq, "w_log": seq, "u": (h, n),
                "state0": (b, h, n, n)},
               {"r": io, "k": (r.dtype,), "v": (r.dtype,),
                "w_log": (torch.float32,), "u": (torch.float32,),
                "state0": (torch.float32,)})
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w_log, u, state0)
    _build.refuse_grad("wkv6", r, k, v, w_log, u, state0)
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    if b * h:
        lib = _build.load_library()
        with torch.cuda.device(r.device):
            err = lib.suprasnn_wkv6(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                u.data_ptr(), state0.data_ptr(), y.data_ptr(),
                state.data_ptr(), _KERNEL_DTYPES[r.dtype], b, s, h, n,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "wkv6")
        count_launch(wkv6)
    return y, state


wkv6.launches = 0
