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
kernel stages its own tiles, and any sequence length is taken as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_ref

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


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over a whole sequence: ``(y, state)``.

    r/k/v [B, S, H, N] of one dtype, float32 or bfloat16; w_log [B, S,
    H, N] float32 (log-decay, <= 0); u [H, N] and state0 [B, H, N, N]
    float32; all contiguous on one device; N in ``HEAD_SIZES``. Returns
    y [B, S, H, N] in r's dtype and the final state [B, H, N, N] float32.
    CUDA tensors launch ``csrc/wkv6.cu`` (counted in ``wkv6.launches``);
    CPU tensors run :func:`~repro_torch.kernels.ref.wkv6_ref`.
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
        wkv6.launches += 1
    return y, state


wkv6.launches = 0
