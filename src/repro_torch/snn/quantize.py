"""Post-training quantization to the SupraSNN fixed-point hardware formats
(paper Table 2: 4-bit weights / 5-bit potential for MNIST; §7.3/7.4
sweeps); port of ``repro/snn/quantize.py``.

Weights -> signed ints of width W_W (symmetric, per-network scale).
Threshold/reset -> same fixed-point scale as the accumulated currents.
Leak alpha -> nearest power-of-two shift (paper §5).

Zero-quantized synapses are dropped from the operation tables entirely —
that is the "post-quantization sparsity" row of Table 2. The arithmetic
after masking is the reference's numpy, so the same float params give
the same integer network.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.snn.lif import LIFIntParams, alpha_to_shift
from repro_torch.snn.models import SNNConfig, masked_weights


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    weight_bits: int = 4
    potential_bits: int = 5    # informational: membrane register width


@dataclasses.dataclass
class QuantizedSNN:
    """Integer network ready for mapping onto the engine."""
    layer_sizes: tuple
    weights: list              # list of int32 [fan_in, fan_out]
    rec_weights: list          # per hidden layer or None
    scale: float               # float weight = int * scale
    lif: LIFIntParams
    recurrent: bool

    @property
    def n_nonzero_synapses(self) -> int:
        n = sum(int((w != 0).sum()) for w in self.weights)
        n += sum(int((w != 0).sum()) for w in self.rec_weights if w is not None)
        return n

    @property
    def n_total_synapses(self) -> int:
        n = sum(w.size for w in self.weights)
        n += sum(w.size for w in self.rec_weights if w is not None)
        return n

    @property
    def sparsity(self) -> float:
        return 1.0 - self.n_nonzero_synapses / self.n_total_synapses

    @property
    def n_unique_weights(self) -> int:
        vals = np.concatenate(
            [w[w != 0].ravel() for w in self.weights]
            + [w[w != 0].ravel() for w in self.rec_weights if w is not None])
        return len(np.unique(vals)) if vals.size else 0


def quantize(params: dict, cfg: SNNConfig, q: QuantConfig) -> QuantizedSNN:
    """``params``: the port's params (tensors on any device)."""
    w = {k: v.detach().cpu().numpy()
         for k, v in masked_weights(params, cfg).items()}
    ws = [w[f"w{i}"] for i in range(cfg.n_layers)]
    wrs = [w[f"wr{i}"] if (cfg.recurrent and i < cfg.n_layers - 1)
           else None for i in range(cfg.n_layers)]

    absmax = max(float(np.abs(x).max()) for x in ws + [r for r in wrs
                                                       if r is not None])
    qmax = 2 ** (q.weight_bits - 1) - 1
    scale = absmax / qmax if absmax > 0 else 1.0

    def qz(x):
        return np.clip(np.round(x / scale), -qmax - 1, qmax).astype(np.int32)

    wq = [qz(x) for x in ws]
    wrq = [qz(x) if x is not None else None for x in wrs]

    # threshold / reset in the same fixed-point domain as currents
    vth = int(round(cfg.lif.v_threshold / scale))
    vreset = int(round(cfg.lif.v_reset / scale))
    lif = LIFIntParams(leak_shift=alpha_to_shift(cfg.lif.alpha),
                       v_threshold=max(vth, 1), v_reset=vreset)
    return QuantizedSNN(cfg.layer_sizes, wq, wrq, scale, lif, cfg.recurrent)
