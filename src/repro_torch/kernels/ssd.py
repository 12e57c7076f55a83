"""The Mamba-2 SSD recurrence in one CUDA kernel; port of
``repro/kernels/ssd.py``.

zamba2's state-space half, the same design as
:mod:`repro_torch.kernels.wkv6`: the per-head state S [P, N] stays on
chip for the whole sequence, x/dt/b/c are read once and y written once.
:func:`ssd` launches ``csrc/ssd.cu`` for CUDA tensors and runs
:func:`~repro_torch.kernels.ref.ssd_ref`, its plain torch version, for
CPU tensors; its design and what bounds it on the H100 are noted in the
source. The reference's ``chunk`` argument has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.wkv6 import HEAD_SIZES, check_args

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = HEAD_SIZES               # N: the kernel's register row
MAX_HEAD_DIM = 128                     # P: one thread per state row


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
    :func:`~repro_torch.kernels.ref.ssd_ref`.
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
        ssd.launches += 1
    return y, state


ssd.launches = 0
