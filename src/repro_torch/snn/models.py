"""SNN model definitions: SFNN (feedforward) and SRNN (recurrent), with
unstructured-sparsity masks (paper §2, Fig. 2; Table 2 architectures);
port of ``repro/snn/models.py``.

Parameters are plain dicts of tensors (``w{i}``, ``mask{i}`` and, for a
recurrent net, ``wr{i}``, ``maskr{i}``), as the reference's pytrees are.
:func:`forward` runs the spike train with a Python loop over time, which
autograd unrolls for BPTT. Every timestep of every layer goes through
the two CUDA kernels under autograd: ``src @ w`` through
:class:`~repro_torch.kernels.spike_accum.SpikeAccumFn` and the LIF step
through :class:`~repro_torch.kernels.lif_update.LIFUpdateFn` (their
plain torch versions for CPU tensors).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.snn.lif import LIFParams


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    layer_sizes: tuple[int, ...] = (784, 116, 10)   # MNIST config, Table 2
    recurrent: bool = False                          # SRNN: hidden layers recur
    sparsity: float = 0.5189                         # fraction of PRUNED synapses
    lif: LIFParams = LIFParams()
    surrogate: str = "relu"
    timesteps: int = 10
    # SupraSNN hardware semantics: spikes generated at t-1 are distributed at
    # t (paper §4.2), i.e. one-timestep delay on every internal synapse.
    # External input spikes at t reach first-layer currents at t.
    delayed: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1


def param_shapes(cfg: SNNConfig) -> dict[str, tuple[int, int]]:
    """Every entry of a params dict for ``cfg`` with its shape."""
    shapes = {}
    for i in range(cfg.n_layers):
        fan_in, fan_out = cfg.layer_sizes[i], cfg.layer_sizes[i + 1]
        shapes[f"w{i}"] = shapes[f"mask{i}"] = (fan_in, fan_out)
        if cfg.recurrent and i < cfg.n_layers - 1:
            shapes[f"wr{i}"] = shapes[f"maskr{i}"] = (fan_out, fan_out)
    return shapes


def is_mask(name: str) -> bool:
    return name.startswith("mask")


def init_params(cfg: SNNConfig, generator: torch.Generator,
                device: torch.device | str | None = None
                ) -> dict[str, torch.Tensor]:
    """Weights and fixed binary sparsity masks (pruned BEFORE training),
    drawn as the reference draws them (normal / sqrt(fan_in), x3 for the
    feed-forward planes; uniform >= sparsity for the masks, no recurrent
    self-loops) from ``generator``, a CPU ``torch.Generator``, then moved
    to ``device`` (``None``: the card; see
    :func:`~repro_torch.core.execution.resolve_device`)."""
    # imported here: repro_torch.core imports the kernels, which import
    # snn.lif, and this package's __init__ imports this module
    from repro_torch.core.execution import resolve_device
    device = resolve_device(device)
    params: dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        fan_in, fan_out = cfg.layer_sizes[i], cfg.layer_sizes[i + 1]
        w = torch.randn((fan_in, fan_out), generator=generator) \
            / np.sqrt(fan_in)
        mask = (torch.rand((fan_in, fan_out), generator=generator)
                >= cfg.sparsity).to(torch.float32)
        params[f"w{i}"] = w * 3.0  # scale up: sparse fan-in needs larger drive
        params[f"mask{i}"] = mask
        if cfg.recurrent and i < cfg.n_layers - 1:
            wr = torch.randn((fan_out, fan_out), generator=generator) \
                / np.sqrt(fan_out)
            mr = torch.rand((fan_out, fan_out), generator=generator) \
                >= cfg.sparsity
            mr &= ~torch.eye(fan_out, dtype=torch.bool)     # no self-loops
            params[f"wr{i}"] = wr
            params[f"maskr{i}"] = mr.to(torch.float32)
    return {k: v.to(device) for k, v in params.items()}


def params_from_numpy(np_params: dict, cfg: SNNConfig,
                      device: torch.device | str | None = None
                      ) -> dict[str, torch.Tensor]:
    """Carry the JAX package's params (``{k: np.asarray(v)}``) across:
    float32 tensors on ``device`` (``None``: the card), every key and
    shape checked."""
    want = param_shapes(cfg)
    if set(np_params) != set(want):
        raise ValueError(f"params keys {sorted(np_params)} != "
                         f"{sorted(want)} for {cfg.layer_sizes}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(np_params[k])
        if a.shape != shape:
            raise ValueError(f"{k} shape {a.shape} != {shape}")
        out[k] = torch.from_numpy(np.array(a, np.float32))
    from repro_torch.core.execution import resolve_device
    device = resolve_device(device)
    return {k: v.to(device) for k, v in out.items()}


def masked_weights(params: dict[str, torch.Tensor], cfg: SNNConfig
                   ) -> dict[str, torch.Tensor]:
    """Effective (pruned) weights; zero-weight synapses simply don't exist."""
    out = {}
    for i in range(cfg.n_layers):
        out[f"w{i}"] = params[f"w{i}"] * params[f"mask{i}"]
        if cfg.recurrent and i < cfg.n_layers - 1:
            out[f"wr{i}"] = params[f"wr{i}"] * params[f"maskr{i}"]
    return out


def layer_spikes(params: dict[str, torch.Tensor], spikes_in: torch.Tensor,
                 cfg: SNNConfig) -> list[torch.Tensor]:
    """Run the network over a spike train; every layer's spikes.

    spikes_in: [T, B, n_in] binary, taken as float32 (the reference
    promotes it so in ``src @ w``). Returns one [T, B, n_i]
    spike train per layer, the output layer last. Each timestep launches
    ``spike_accum`` once per weight plane and ``lif_update`` once per
    layer.
    """
    # imported here: the kernel modules import snn.lif, whose package
    # imports this module, so a module-level import would be circular
    from repro_torch.kernels.lif_update import LIFUpdateFn
    from repro_torch.kernels.spike_accum import SpikeAccumFn

    w = masked_weights(params, cfg)
    # the kernels take one dtype and rows as laid out
    spikes_in = spikes_in.to(torch.float32).contiguous()
    b = spikes_in.shape[1]
    dev = spikes_in.device
    vs = [torch.zeros((b, n), device=dev) for n in cfg.layer_sizes[1:]]
    prev = [torch.zeros((b, n), device=dev) for n in cfg.layer_sizes[1:]]
    trains: list[list[torch.Tensor]] = [[] for _ in range(cfg.n_layers)]
    for t in range(spikes_in.shape[0]):
        layer_in = spikes_in[t]
        new_vs, new_spikes = [], []
        for i in range(cfg.n_layers):
            # delayed (hardware) semantics: internal synapses carry spikes
            # from the PREVIOUS timestep; external inputs arrive same-step.
            src = layer_in if i == 0 else (prev[i - 1] if cfg.delayed
                                           else layer_in)
            cur = SpikeAccumFn.apply(src, w[f"w{i}"])
            if cfg.recurrent and i < cfg.n_layers - 1:
                cur = cur + SpikeAccumFn.apply(prev[i], w[f"wr{i}"])
            v_next, s = LIFUpdateFn.apply(vs[i], cur, cfg.lif, cfg.surrogate)
            new_vs.append(v_next)
            new_spikes.append(s)
            trains[i].append(s)
            layer_in = s
        vs, prev = new_vs, new_spikes
    return [torch.stack(tr) for tr in trains]


def forward(params: dict[str, torch.Tensor], spikes_in: torch.Tensor,
            cfg: SNNConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the network over a spike train.

    spikes_in: [T, B, n_in] binary.
    Returns (spike_counts [B, n_out], out_spikes [T, B, n_out]).
    Classification = argmax of accumulated output spikes (paper §7.1).
    """
    out_spikes = layer_spikes(params, spikes_in, cfg)[-1]
    return out_spikes.sum(dim=0), out_spikes


class SNN(nn.Module):
    """A params dict as a module: the weights ``w*``/``wr*`` are
    parameters, the masks buffers (fixed, so an optimizer never sees
    them). ``forward(spikes_in)`` is :func:`forward`."""

    def __init__(self, cfg: SNNConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for k in param_shapes(cfg):
            if is_mask(k):
                self.register_buffer(k, params[k])
            else:
                self.register_parameter(k, nn.Parameter(params[k]))

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in param_shapes(self.cfg)}

    def forward(self, spikes_in: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self.params(), spikes_in, self.cfg)


MNIST_CONFIG = SNNConfig(layer_sizes=(784, 116, 10), recurrent=False,
                         sparsity=0.5189, lif=LIFParams(alpha=0.25),
                         surrogate="relu", timesteps=10)

SHD_CONFIG = SNNConfig(layer_sizes=(700, 300, 20), recurrent=True,
                       sparsity=0.8704, lif=LIFParams(alpha=0.03125),
                       surrogate="sigmoid", timesteps=100)
