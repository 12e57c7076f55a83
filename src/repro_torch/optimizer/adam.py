"""Adam/AdamW on dicts of tensors, with optional int8-quantized moments;
port of ``repro/optimizer/adam.py``.

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


def adam_init(params: dict[str, torch.Tensor], cfg: AdamConfig) -> AdamState:
    if cfg.quantized_state:
        b = cfg.block
        return AdamState(0, {k: _q_init(p, b) for k, p in params.items()},
                         {k: _q_init(p, b) for k, p in params.items()},
                         {k: _q_scale_init(p, b) for k, p in params.items()},
                         {k: _q_scale_init(p, b) for k, p in params.items()})
    return AdamState(
        0, {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()})


@torch.no_grad()
def adam_update(grads: dict[str, torch.Tensor], state: AdamState,
                params: dict[str, torch.Tensor], cfg: AdamConfig
                ) -> tuple[dict[str, torch.Tensor], AdamState]:
    """Returns (new_params, new_state)."""
    t = state.step + 1
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = 1.0 - cfg.b1 ** tf
    bc2 = 1.0 - cfg.b2 ** tf

    new_p, new_m, new_v = {}, {}, {}
    new_ms, new_vs = {}, {}
    for k, p in params.items():
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
        return new_p, AdamState(t, new_m, new_v, new_ms, new_vs)
    return new_p, AdamState(t, new_m, new_v)
