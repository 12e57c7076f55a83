"""BPTT training for SNNs (paper §7.1): surrogate-gradient backprop
through the loop over timesteps, Adam, rate encoding for images; port of
``repro/snn/train.py``.

``train`` and ``evaluate`` run on the card unless given
``device="cpu"``; without a card they raise. Random numbers come from
``torch.Generator``s seeded from ``seed``: init from a CPU generator
(``seed``), rate encoding from one on the run's device (``seed + 1``),
so the bits differ from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.optimizer.adam import AdamConfig, adam_init, adam_update
from repro_torch.snn.models import SNNConfig, forward, init_params, is_mask


def rate_encode(images: torch.Tensor, timesteps: int,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Rate coding: pixel intensity -> Bernoulli spike probability per step.

    images: [B, n_pixels] in [0, 1].  Returns [T, B, n_pixels] binary
    float32, drawn from ``generator`` (on the images' device).
    """
    p = images.to(torch.float32).expand(timesteps, *images.shape)
    return torch.bernoulli(p, generator=generator)


def spike_count_loss(counts: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Cross-entropy over accumulated output-spike counts."""
    logp = torch.log_softmax(counts, dim=-1)
    return -torch.mean(logp.gather(1, labels[:, None].long()))


@dataclasses.dataclass
class TrainResult:
    params: dict
    accuracy: float
    loss_history: list
    wall_seconds: float


def loss_and_grads(params: dict[str, torch.Tensor], spikes: torch.Tensor,
                   labels: torch.Tensor, cfg: SNNConfig
                   ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The reference's ``value_and_grad(loss_fn)``: ``(loss, counts,
    grads)``, with grads of the trainable entries only (masks take none)."""
    trained = {k: v.detach().requires_grad_() for k, v in params.items()
               if not is_mask(k)}
    counts, _ = forward({**params, **trained}, spikes, cfg)
    loss = spike_count_loss(counts, labels)
    grads = torch.autograd.grad(loss, list(trained.values()))
    return loss.detach(), counts.detach(), dict(zip(trained, grads))


def make_train_step(cfg: SNNConfig, opt: AdamConfig, encode: bool):
    """Returns ``(params, opt_state, x, y, generator) -> (params,
    opt_state, loss, acc)``; ``opt_state`` covers the trainable entries."""

    def step(params, opt_state, x, y, generator=None):
        spikes = rate_encode(x, cfg.timesteps, generator) if encode else x
        loss, counts, grads = loss_and_grads(params, spikes, y, cfg)
        new, opt_state = adam_update(grads, opt_state,
                                     {k: params[k] for k in grads}, opt)
        acc = torch.mean((torch.argmax(counts, -1) == y).to(torch.float32))
        return {**params, **new}, opt_state, loss, acc

    return step


@torch.no_grad()
def evaluate(params: dict[str, torch.Tensor], cfg: SNNConfig,
             xs: np.ndarray, ys: np.ndarray, seed: int = 0,
             encode: bool = True, batch: int = 256,
             device: str | torch.device | None = None) -> float:
    """Full-set accuracy.

    xs: [N, n_pixels] images (``encode=True``) or [N, T, n_in] spike
    trains (``encode=False``, as :func:`~repro_torch.data.synthetic_shd`
    returns them; each batch is made time-major here).
    """
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    correct = 0
    for i in range(0, len(xs), batch):
        x = torch.as_tensor(np.asarray(xs[i:i + batch]), dtype=torch.float32,
                            device=dev)
        spikes = (rate_encode(x, cfg.timesteps, gen) if encode
                  else x.transpose(0, 1).contiguous())
        counts, _ = forward(params, spikes, cfg)
        pred = torch.argmax(counts, -1).cpu().numpy()
        correct += int((pred == np.asarray(ys[i:i + batch])).sum())
    return correct / len(xs)


def train(cfg: SNNConfig, data: Iterator, steps: int, lr: float,
          seed: int = 0, encode: bool = True, log_every: int = 50,
          verbose: bool = False, device: str | torch.device | None = None,
          params: dict[str, torch.Tensor] | None = None) -> TrainResult:
    """data yields (x [B, n_in] float or [T, B, n_in] spikes, y [B] int).

    ``params`` is where training starts, e.g. params carried across with
    :func:`~repro_torch.snn.models.params_from_numpy`; ``None`` draws
    them with :func:`init_params` from ``seed``.
    """
    dev = resolve_device(device)
    opt = AdamConfig(lr=lr)
    params = (init_params(cfg, torch.Generator().manual_seed(seed), dev)
              if params is None
              else {k: v.to(dev) for k, v in params.items()})
    opt_state = adam_init({k: v for k, v in params.items() if not is_mask(k)},
                          opt)
    step_fn = make_train_step(cfg, opt, encode)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    t0 = time.time()
    losses, last_acc = [], 0.0
    for i in range(steps):
        x, y = next(data)
        params, opt_state, loss, acc = step_fn(
            params, opt_state,
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.int64, device=dev), gen)
        losses.append(float(loss))
        last_acc = float(acc)
        if verbose and (i % log_every == 0):
            print(f"  step {i:4d}  loss {float(loss):.4f}  acc {last_acc:.3f}")
    return TrainResult(params, last_acc, losses, time.time() - t0)
