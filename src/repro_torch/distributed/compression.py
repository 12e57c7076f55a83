"""Gradient compression for the cross-pod all-reduce; port of
``repro/distributed/compression.py``.

int8 block quantization with ERROR FEEDBACK: the quantization residual of
step t is added back into the gradient at step t+1, so the compression
error does not accumulate (EF-SGD / 1-bit-Adam family). Meant for the
'pod' axis only: the in-pod reduction stays full precision, and the
8x-smaller payload rides the slow inter-pod links (DESIGN.md §5).

Blocks run over each leaf's GLOBAL flattening: a DTensor leaf is
gathered first (``full_tensor``), so the payload does not depend on the
leaf's placement. ``torch.round`` rounds half to even, as ``jnp.round``
does, and the quantizer's float32 operations are the reference's, so
``q`` and ``scale`` are the reference's bits, on the card as on the
CPU.
:func:`compressed_allreduce` sends the int8 payloads over a mesh axis
and sums their dequantized values (the reference's docstring describes
this reduction inside its train step; none of its steps calls it, and
neither does the port's: wiring it into the ruled step is a lever of
ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import _is_dtensor, tree_map


class CompressedGrads(NamedTuple):
    q: Any          # int8 payload tree
    scale: Any      # float32 per-block scales tree


def _global(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if _is_dtensor(x) else x


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened, zero-padded to a whole number of blocks: [n, block]."""
    pad = (-x.numel()) % block
    return F.pad(x.reshape(-1), (0, pad)).reshape(-1, block)


def compress_int8(tree, *, block: int = 1024) -> CompressedGrads:
    """Blockwise symmetric int8 quantization of every leaf."""
    def one(x):
        xb = _blocks(_global(x).to(torch.float32), block)
        # a divisor on the tensor's device: the card divides by a host
        # scalar as a product with its reciprocal, which rounds otherwise
        scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / \
            xb.new_tensor(127.0)
        scale = torch.clamp(scale, min=1e-20)
        q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
        return q, scale
    both = tree_map(one, tree)
    return CompressedGrads(tree_map(lambda _, p: p[0], tree, both),
                           tree_map(lambda _, p: p[1], tree, both))


def decompress_int8(c: CompressedGrads, like) -> Any:
    """Dequantize back to the global shapes of ``like``, float32."""
    def one(q, scale, ref):
        flat = (q.to(torch.float32) * scale).reshape(-1)[:ref.numel()]
        return flat.reshape(ref.shape)
    return tree_map(one, c.q, c.scale, like)


def compress_error_feedback(grads, error, *, block: int = 1024):
    """Quantize (grads + carried error); return (compressed, dequantized,
    new_error).

    new_error = input - dequantized(quantized(input)) stays on the device
    and is added to the NEXT step's gradient: unbiased in the long run.
    """
    corrected = tree_map(lambda g, e: _global(g).to(torch.float32) + e,
                         grads, error)
    comp = compress_int8(corrected, block=block)
    deq = decompress_int8(comp, corrected)
    new_error = tree_map(lambda c, d: c - d, corrected, deq)
    return comp, deq, new_error


def init_error(grads_like):
    """Zero float32 errors of the leaves' global shapes."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=_global(g).device),
                    grads_like)


def compressed_allreduce(grads, error, mesh, axis: str = "pod", *,
                         block: int = 1024):
    """The all-reduce the reference's docstring describes, over the
    ``axis`` ranks of ``mesh`` (a ``DeviceMesh``): each rank's ``grads``
    (plain tensors, global shapes) quantized with error feedback, the
    int8 payloads and their float32 block scales all-gathered (1 byte a
    value and 4 a block on the wire, where a float32 all-reduce moves 4
    a value), and the dequantized payloads summed in rank order on every
    rank. Returns (summed float32 tree, this rank's new error)."""
    import torch.distributed as dist
    comp, _, new_error = compress_error_feedback(grads, error, block=block)
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def gather(t):
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t.contiguous(), group=group)
        return out

    def one(q, scale, ref):
        parts = [decompress_int8(CompressedGrads(qr, sr), ref)
                 for qr, sr in zip(gather(q), gather(scale))]
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        return total
    return tree_map(one, comp.q, comp.scale, new_error), new_error


def compressed_allreduce_spec(n_params: int, pods: int = 2,
                              link_gbps: float = 50.0) -> dict:
    """Napkin model of the cross-pod traffic saved."""
    full = n_params * 4          # f32 all-reduce payload per step
    comp = n_params * 1 + n_params / 1024 * 4
    return {"full_bytes": full, "compressed_bytes": comp,
            "ratio": full / comp,
            "seconds_full": full / (link_gbps * 1e9),
            "seconds_compressed": comp / (link_gbps * 1e9)}
