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
and a new state and changes neither argument. It updates every entry of
``params`` it is given; a caller passes the trainable entries only (the
SNN's masks are buffers and take no update, where the reference gets the
same result by zeroing their gradients).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


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


def _quantize(x: torch.Tensor, block: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., F] f32 -> ([..., F/B, B] int8, [..., F/B, 1] f32 scales)."""
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _deq(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def _flat(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dicts -> {path tuple: leaf}, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest(flat: dict) -> dict:
    """:func:`_flat`'s inverse."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def adam_init(params: dict, cfg: AdamConfig) -> AdamState:
    flat = _flat(params)

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


@torch.no_grad()
def adam_update(grads: dict, state: AdamState, params: dict,
                cfg: AdamConfig) -> tuple[dict, AdamState]:
    """Returns (new_params, new_state), trees like ``params``; ``grads``
    holds a leaf for each of them (and may hold more)."""
    t = state.step + 1
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = 1.0 - cfg.b1 ** tf
    bc2 = 1.0 - cfg.b2 ** tf

    grads = _flat(grads)
    state = AdamState(state.step, *(None if x is None else _flat(x)
                                    for x in state[1:]))
    new_p, new_m, new_v = {}, {}, {}
    new_ms, new_vs = {}, {}
    for k, p in _flat(params).items():
        g = grads[k].to(torch.float32)
        m, v = state.m[k], state.v[k]
        quantized = cfg.quantized_state and state.m_scale[k].numel() > 0
        if quantized:
            m = _deq(m, state.m_scale[k], p.shape)
            v = _deq(v, state.v_scale[k], p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - cfg.lr * update).to(p.dtype)
        if quantized:
            (new_m[k], new_ms[k]), (new_v[k], new_vs[k]) = (
                _quantize(m, cfg.block), _quantize(v, cfg.block))
        else:
            new_m[k], new_v[k] = m, v
            if cfg.quantized_state:
                new_ms[k], new_vs[k] = state.m_scale[k], state.v_scale[k]
    if cfg.quantized_state:
        return _nest(new_p), AdamState(t, _nest(new_m), _nest(new_v),
                                       _nest(new_ms), _nest(new_vs))
    return _nest(new_p), AdamState(t, _nest(new_m), _nest(new_v))
