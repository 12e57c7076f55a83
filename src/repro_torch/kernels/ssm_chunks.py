"""The host side of ``csrc/ssm_sm90.cuh``, the chunked tensor-core design
that ``csrc/ssd.cu`` and ``csrc/wkv6.cu`` share, for the emulations.

Both kernels walk a (batch, head)'s sequence in chunks of ``CHUNK``
tokens, one warp per ``SUB``-token sub-chunk, and run their products on
the bf16 tensor cores with float32 sums. An operand that is an input of
bf16 type enters as itself (one term); every other operand, an input of
float32 type or a float32 value the kernel derived (a decayed factor,
the state, a masked score), enters as a sum of bf16 terms
(:func:`term_counts`, :func:`split_terms`), and a product of two split
operands keeps the cross terms whose orders add up to less than the
larger count (:func:`tc_dot`). ``SPAN_MAX`` is ``wkv6``'s threshold on
a sub-chunk's decay span: below it the diagonal block is factorized and
goes to the tensor cores, at or above it it is summed in log space on
the CUDA cores.
"""
from __future__ import annotations

import torch

CHUNK = 64          # tokens a CTA takes per step of its state
SUB = 16            # tokens a warp owns: one m16 tile of rows
SPAN_MAX = 60.0     # wkv6: e^60 ~ 1e26, far from the bf16/float32 max


def term_counts(dtype: torch.dtype) -> tuple[int, int]:
    """The bf16 terms of an input operand and of a float32 operand the
    kernel derives: bf16 inputs are exact (1) and derived values take
    hi + lo (2, about 16 significant bits); float32 inputs take
    hi + mid + lo (3) for both, which holds a float32 value whole."""
    return (1, 2) if dtype == torch.bfloat16 else (3, 3)


def split_terms(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``v`` (float32) as ``n`` bf16 terms, each rounded to nearest even
    from what the terms before it left (every difference is exact in
    float32), returned as float32 tensors; ``n = 3`` is
    :func:`repro_torch.kernels.spike_accum.split_bf16x3`."""
    terms = []
    for i in range(n):
        t = v.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        if i + 1 < n:
            v = v - t
    return terms


def tc_dot(eq: str, a: list[torch.Tensor], b: list[torch.Tensor]
           ) -> torch.Tensor:
    """``einsum(eq)`` of two split operands as the tensor cores form it:
    the products ``a[i] b[j]`` with ``i + j < max(len(a), len(b))``,
    the smallest orders first, summed in float32."""
    nmax = max(len(a), len(b))
    out = None
    for order in reversed(range(nmax)):
        for i in reversed(range(len(a))):
            j = order - i
            if 0 <= j < len(b):
                p = torch.einsum(eq, a[i], b[j])
                out = p if out is None else out + p
    return out


def cumsum_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` taken one float32 addition at a
    time in order, as one thread of the kernel takes it (``torch.cumsum``
    on the CPU sums in double)."""
    x = x.to(torch.float32)
    out = x.clone()
    for i in range(1, x.shape[dim]):
        out.select(dim, i).add_(out.select(dim, i - 1))
    return out


def pad_chunks(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to a whole number of chunks, as
    the kernels' staging zero-fills the tail of the last chunk."""
    pad = -t.shape[dim] % CHUNK
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim)
