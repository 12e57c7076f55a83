"""Adam/AdamW on trees of tensors (nested dicts: the SNN's flat dict of
weights, the LM's parameter tree), with optional int8-quantized moments;
port of ``repro/optimizer/adam.py``. The moments mirror the tree of the
parameters, as the reference's do.

The int8 variant ("Adam-8bit") stores m and v block-quantized to int8
with a per-block float32 absmax scale, blocks formed by splitting the
LAST axis ([..., F] -> [..., F/B, B]), as the reference lays them out.
Entries whose last axis the block size does not divide stay in float32;
a zero-size scale marks them.

Functional, as the reference is: :func:`adam_update` returns new params
and a new state and changes neither argument. It updates each leaf with
:func:`adam_leaf`, elementwise in the moments' block view, which the
ruled train step (``train/steps.py``) also runs on each rank's
block-aligned pieces of a leaf. It updates every entry of
``params`` it is given; a caller passes the trainable entries only (the
SNN's masks are buffers and take no update, where the reference gets the
same result by zeroing their gradients).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import flat_tree


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    quantized_state: bool = False   # int8 m/v
    block: int = 256                # quantization block size (last axis)


class AdamState(NamedTuple):
    step: int
    m: dict
    v: dict
    m_scale: dict | None = None     # only for quantized_state
    v_scale: dict | None = None


def _quantizable(p: torch.Tensor, block: int) -> bool:
    return p.ndim >= 1 and p.shape[-1] % block == 0 and p.numel() >= block


def _q_init(p: torch.Tensor, block: int) -> torch.Tensor:
    if not _quantizable(p, block):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return torch.zeros((*p.shape[:-1], p.shape[-1] // block, block),
                       dtype=torch.int8, device=p.device)


def _q_scale_init(p: torch.Tensor, block: int) -> torch.Tensor:
    if not _quantizable(p, block):
        # sentinel: unquantized
        return torch.zeros((0,), dtype=torch.float32, device=p.device)
    return torch.zeros((*p.shape[:-1], p.shape[-1] // block, 1),
                       dtype=torch.float32, device=p.device)


def _quantize(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocks [..., B] f32 -> (int8 [..., B], f32 absmax scales [..., 1])."""
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _deq(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 blocks [..., B] and their scales [..., 1] -> float32."""
    return q.to(torch.float32) * scale


def _nest(flat: dict) -> dict:
    """:func:`~repro_torch.distributed.sharding.flat_tree`'s inverse
    for nested dicts."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def adam_init(params: dict, cfg: AdamConfig) -> AdamState:
    flat = flat_tree(params)

    def each(fn):
        return _nest({k: fn(p) for k, p in flat.items()})

    if cfg.quantized_state:
        b = cfg.block
        return AdamState(0, each(lambda p: _q_init(p, b)),
                         each(lambda p: _q_init(p, b)),
                         each(lambda p: _q_scale_init(p, b)),
                         each(lambda p: _q_scale_init(p, b)))
    return AdamState(0, each(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32)),
                     each(lambda p: torch.zeros_like(p, dtype=torch.float32)))


def blocked_shape(shape, block: int) -> tuple:
    """A quantized leaf's block view: [..., F] -> [..., F/B, B] (the
    moments' own shape)."""
    return (*shape[:-1], shape[-1] // block, block)


def bias_corrections(step: int, cfg: AdamConfig) -> tuple:
    """(1 - b1^t, 1 - b2^t) for the step after ``step``, float32."""
    tf = torch.tensor(float(step + 1), dtype=torch.float32)
    return 1.0 - cfg.b1 ** tf, 1.0 - cfg.b2 ** tf


@torch.no_grad()
def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, m_scale, v_scale, bc1, bc2, cfg: AdamConfig,
              quantized: bool) -> tuple:
    """One leaf's update, elementwise: (new p, m, v, m_scale, v_scale).
    For a ``quantized`` leaf, ``p`` and ``g`` come in the moments' block
    view ([..., F/B, B], :func:`blocked_shape`), so that any block-aligned
    piece of a leaf updates as the whole leaf does; otherwise the scales
    pass through."""
    g = g.to(torch.float32)
    if quantized:
        m, v = _deq(m, m_scale), _deq(v, v_scale)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    if cfg.weight_decay:
        update = update + cfg.weight_decay * p.to(torch.float32)
    p_new = (p.to(torch.float32) - cfg.lr * update).to(p.dtype)
    if quantized:
        (m, m_scale), (v, v_scale) = _quantize(m), _quantize(v)
    return p_new, m, v, m_scale, v_scale


@torch.no_grad()
def adam_update(grads: dict, state: AdamState, params: dict,
                cfg: AdamConfig) -> tuple[dict, AdamState]:
    """Returns (new_params, new_state), trees like ``params``; ``grads``
    holds a leaf for each of them (and may hold more)."""
    bc1, bc2 = bias_corrections(state.step, cfg)
    grads = flat_tree(grads)
    state = AdamState(state.step, *(None if x is None else flat_tree(x)
                                    for x in state[1:]))
    q = cfg.quantized_state
    new_p, new_m, new_v = {}, {}, {}
    new_ms, new_vs = {}, {}
    for k, p in flat_tree(params).items():
        quantized = q and state.m_scale[k].numel() > 0
        view = blocked_shape(p.shape, cfg.block) if quantized else p.shape
        out = adam_leaf(p.reshape(view), grads[k].reshape(view),
                        state.m[k], state.v[k],
                        state.m_scale[k] if q else None,
                        state.v_scale[k] if q else None, bc1, bc2, cfg,
                        quantized)
        new_p[k] = out[0].reshape(p.shape)
        new_m[k], new_v[k], new_ms[k], new_vs[k] = out[1:]
    t = state.step + 1
    if q:
        return _nest(new_p), AdamState(t, _nest(new_m), _nest(new_v),
                                       _nest(new_ms), _nest(new_vs))
    return _nest(new_p), AdamState(t, _nest(new_m), _nest(new_v))
