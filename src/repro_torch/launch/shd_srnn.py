"""Recurrent SNN on (synthetic) SHD — the paper's second benchmark: a
700-300-20 SRNN at 87 % sparsity trained with BPTT, quantized to 7-bit
weights / 12-bit potentials, compiled into a ``Program`` artifact on the
64-SPU XC7Z030 config and run mapped; port of ``examples/shd_srnn.py``.

    PYTHONPATH=src python -m repro_torch.launch.shd_srnn [--steps 200]
        [--hidden 300] [--timesteps 100] [--batch 32]
        [--engine {torch,python}] [--kernel {fused,lif,reference}]
        [--device cpu]

Factored as :mod:`repro_torch.launch.mnist_end_to_end`, whose
:func:`train_stage` and :func:`deploy` it uses: mapped inference runs
the first ``--batch`` test samples in one call of the batched engine,
and reports sample 0's modeled latency and energy (the reference's one
sample) beside the batch's mean and the mapped accuracy. Everything runs
on the card unless ``--device cpu`` is given; without a card it raises.
Latency and energy are the ``CycleModel``'s figures for the paper's
FPGA at 100 MHz, not times on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.snn_paper import SHD_HW
from repro_torch.core.execution import resolve_device
from repro_torch.data import shd_batches, synthetic_shd
from repro_torch.launch.mnist_end_to_end import (add_engine_args, deploy,
                                                 engine_spec, row_of,
                                                 train_stage)
from repro_torch.snn import LIFParams, QuantConfig, SNNConfig

__all__ = ["PAPER_SHD", "shd_config", "train_stage", "deploy", "main"]

# the paper's Table 3 row for SHD (its FPGA at 100 MHz)
PAPER_SHD = {"ot_depth": 742, "latency_us": 1410.0, "energy_mj": 0.77}


def shd_config(hidden: int = 300, timesteps: int = 100) -> SNNConfig:
    """The paper's SRNN: 700-hidden-20, recurrent, sparsity 0.8704,
    alpha 1/32, sigmoid surrogate."""
    return SNNConfig(layer_sizes=(700, hidden, 20), recurrent=True,
                     sparsity=0.8704, lif=LIFParams(alpha=0.03125),
                     surrogate="sigmoid", timesteps=timesteps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=300)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32,
                    help="test samples run mapped in one call")
    add_engine_args(ap, "torch")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    spec = engine_spec(args.engine, args.kernel, device)

    cfg = shd_config(args.hidden, args.timesteps)
    xtr, ytr, xte, yte = synthetic_shd(n_train=512, n_test=128,
                                       timesteps=args.timesteps)
    print(f"== training SRNN {cfg.layer_sizes}, sparsity {cfg.sparsity} ==")
    t0 = time.perf_counter()
    params, acc_float, losses = train_stage(
        cfg, shd_batches(xtr, ytr, 32), args.steps, lr=1e-3, encode=False,
        test=(xte, yte), device=device, verbose=True, log_every=50)
    t_train = time.perf_counter() - t0
    print(f"float accuracy: {acc_float:.4f}")

    print("== quantize (7-bit weights / 12-bit potential, Table 2), compile "
          f"onto the 64-SPU XC7Z030 config, mapped inference on "
          f"{args.batch} samples (engine={spec.engine}) ==")
    ext = np.ascontiguousarray(xte[:args.batch], np.int32)
    dep = deploy(params, cfg, SHD_HW, QuantConfig(7, 12), ext,
                 labels=yte[:args.batch], spec=spec, max_iters=60000)
    first = dep["profile"].per_sample[0]
    print(f"nonzero synapses: {dep['n_synapses']}")
    print(f"feasible={dep['feasible']} OT depth={dep['ot_depth']} "
          f"(paper: 742)")
    print(f"sample 0: latency {first.latency_us / 1e3:.3f} ms/sample "
          f"(paper: 1.41 ms), energy {first.energy_mj:.3f} mJ (paper: 0.77)")
    print(f"mean over {dep['n_samples']}: latency "
          f"{dep['latency_us'] / 1e3:.3f} ms/sample, energy "
          f"{dep['energy_mj']:.3f} mJ; mapped-engine accuracy "
          f"{dep['accuracy']:.3f}")
    sec = {"train": t_train, **dep["seconds"]}
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
          + f" (on {device}; latency and energy are modeled for the "
            f"paper's FPGA)")
    return {**row_of(dep), "seconds": sec, "float_accuracy": acc_float,
            "losses": losses, "sample0_latency_us": float(first.latency_us),
            "sample0_energy_mj": float(first.energy_mj), "device": device,
            "engine": spec.engine}


if __name__ == "__main__":
    main()
