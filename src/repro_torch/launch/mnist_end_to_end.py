"""End-to-end flow (paper §7.1/§7.2): train the 784-116-10 SFNN with
surrogate-gradient BPTT, quantize it to the 4-bit hardware format,
compile it into a ``Program`` artifact on the Table-2 hardware (16
SPUs), run mapped inference and report the Table-3 row, mapped-engine
accuracy included; port of ``examples/mnist_end_to_end.py``.

    PYTHONPATH=src python -m repro_torch.launch.mnist_end_to_end
        [--steps 300] [--test-images 20] [--engine {torch,python}]
        [--kernel {fused,lif,reference}] [--save PATH] [--device cpu]

Training runs the card's ``spike_accum`` / ``lif_update`` kernels, and
``--engine torch`` (the default) serves every test image in ONE call of
the batched engine (``--kernel`` picks its tier: by default the fused
kernel, one launch a timestep); ``--engine python`` is the host
simulator (on the CPU, image by image), the reference's default. Every
engine and tier gives the same bits, so the row is the same. Everything
runs on the card unless ``--device cpu`` is given; without a card it
raises. Latency and energy are the ``CycleModel``'s figures for the
paper's FPGA at 100 MHz, not times on the card.

:func:`train_stage` and :func:`deploy` are the two halves, which the
tests and ``chip_smoke.py`` call directly; ``deploy`` takes the spike
trains as int32 numpy, so two packages can be given the same spikes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.snn_paper import MNIST_HW
from repro_torch.core import ExecutionSpec, compile, from_quantized
from repro_torch.core.execution import resolve_device
from repro_torch.data import load_mnist, mnist_batches
from repro_torch.snn import MNIST_CONFIG, QuantConfig, quantize
from repro_torch.snn.train import evaluate, rate_encode, train

# the paper's Table 3 row for MNIST (its FPGA at 100 MHz)
PAPER_MNIST = {"ot_depth": 661, "brams": 33.5, "latency_us": 149.0,
               "energy_mj": 0.02563, "nj_per_synapse": 0.27675}
# deploy's row: what a Table-3 line reports of a deployed net
ROW_KEYS = ("n_synapses", "n_total_synapses", "sparsity", "feasible",
            "iterations", "ot_depth", "brams", "n_samples", "accuracy",
            "latency_us", "energy_mj", "nj_per_synapse")


def engine_spec(engine: str, kernel: str | None, device: str | None
                ) -> ExecutionSpec:
    """The examples' ``--engine`` / ``--kernel`` / ``--device``: ``"torch"``
    (``"jax"`` is its alias) on ``device`` at tier ``kernel``, or the
    ``"python"`` host simulator, which runs on the CPU."""
    if engine == "python":
        if kernel is not None:
            raise ValueError("--kernel selects the torch engine's tier; it "
                             "does not apply to --engine python")
        return ExecutionSpec(engine="python", device="cpu")
    return ExecutionSpec(kernel=kernel, device=device)


def add_engine_args(ap: argparse.ArgumentParser, default: str) -> None:
    ap.add_argument("--engine", choices=("torch", "python", "jax"),
                    default=default,
                    help="mapped executor: the batched torch engine ('jax' "
                         "is its alias) or the host simulator")
    ap.add_argument("--kernel", choices=("fused", "lif", "reference"),
                    default=None, help="the torch engine's tier "
                                       "(default: fused)")
    ap.add_argument("--device", default=None,
                    help="where training and the torch engine run "
                         "(default: the card)")


def encode_images(images: np.ndarray, timesteps: int, seed: int
                  ) -> np.ndarray:
    """Rate-code ``images`` [B, n_pixels] on the CPU from
    ``torch.Generator().manual_seed(seed)``: [B, T, n_pixels] int32."""
    gen = torch.Generator().manual_seed(seed)
    spikes = rate_encode(torch.from_numpy(np.asarray(images, np.float32)),
                         timesteps, gen)
    return np.ascontiguousarray(
        spikes.to(torch.int32).permute(1, 0, 2).numpy())


def train_stage(cfg, data, steps: int, *, lr: float, encode: bool,
                test: tuple, seed: int = 0, device=None,
                verbose: bool = False, log_every: int = 100
                ) -> tuple[dict, float, list]:
    """BPTT training (:func:`~repro_torch.snn.train.train`) from ``seed``
    on ``data``, then the float net's accuracy on ``test`` = ``(xs,
    ys)``. Returns ``(params, float accuracy, loss history)``."""
    res = train(cfg, data, steps, lr=lr, seed=seed, encode=encode,
                verbose=verbose, log_every=log_every, device=device)
    xs, ys = test
    acc = evaluate(res.params, cfg, xs, ys, seed=seed + 1, encode=encode,
                   device=device)
    return res.params, acc, res.loss_history


def deploy(params: dict, cfg, hw, qcfg: QuantConfig, ext: np.ndarray, *,
           labels: np.ndarray, spec: ExecutionSpec | str | None = None,
           max_iters: int = 20000) -> dict:
    """Quantize ``params`` to ``qcfg``, compile onto ``hw``, run the
    spike trains ``ext`` [B, T, n_inputs] (int32) through ``spec``'s
    engine in one call and profile the packet counts.

    Returns the Table-3 row (:data:`ROW_KEYS`: nonzero and total
    synapses, post-quantization sparsity, feasible, iterations, OT
    depth, BRAMs, samples, mapped accuracy against ``labels``, mean
    modeled latency µs, energy mJ, nJ per synapse) and ``seconds``
    (quantize, compile, run: the run with its copies), ``program``,
    ``quantized``, ``outputs`` (the run's ``(spikes, v_final, stats)``)
    and ``profile``.
    """
    ext = np.asarray(ext)
    if ext.ndim != 3 or ext.dtype != np.int32:
        raise ValueError(f"ext must be int32 [B, T, n_inputs], got "
                         f"{ext.dtype} {ext.shape}")
    t0 = time.perf_counter()
    q = quantize(params, cfg, qcfg)
    g = from_quantized(q)
    t1 = time.perf_counter()
    program = compile(g, hw, max_iters=max_iters)
    t2 = time.perf_counter()
    s_all, v_all, stats = program.run(ext, spec)
    t3 = time.perf_counter()
    prof = program.profile(stats, n_synapses=q.n_total_synapses)
    out_lo, out_hi = (i - g.n_inputs for i in g.output_slice)
    pred = np.argmax(s_all.sum(1)[:, out_lo:out_hi], axis=-1)
    lat = np.mean([r.latency_us for r in prof.per_sample])
    en = np.mean([r.energy_mj for r in prof.per_sample])
    rep = program.report
    row = {"n_synapses": int(g.n_synapses),
           "n_total_synapses": int(q.n_total_synapses),
           "sparsity": float(q.sparsity),
           "feasible": bool(program.feasible),
           "iterations": int(rep.iterations),
           "ot_depth": int(program.ot_depth),
           "brams": float(rep.resources.brams),
           "n_samples": int(len(ext)),
           "accuracy": float(np.mean(pred == np.asarray(labels))),
           "latency_us": float(lat), "energy_mj": float(en),
           "nj_per_synapse": float(en * 1e6 / q.n_total_synapses)}
    return {**row, "seconds": {"quantize": t1 - t0, "compile": t2 - t1,
                               "run": t3 - t2},
            "program": program, "quantized": q,
            "outputs": (s_all, v_all, stats), "profile": prof}


def row_of(dep: dict) -> dict:
    """The row and the stage seconds of :func:`deploy`'s result."""
    return {**{k: dep[k] for k in ROW_KEYS}, "seconds": dep["seconds"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--test-images", type=int, default=20)
    add_engine_args(ap, "torch")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="persist the compiled Program artifact to PATH")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    spec = engine_spec(args.engine, args.kernel, device)
    cfg = MNIST_CONFIG

    print("== 1. data (real MNIST if present, else synthetic) ==")
    xtr, ytr, xte, yte = load_mnist(n_train=2048, n_test=512)

    print(f"== 2. BPTT training, {args.steps} steps "
          f"(paper: 20 epochs, Adam, lr 5e-4, ReLU surrogate) ==")
    t0 = time.perf_counter()
    params, acc_float, losses = train_stage(
        cfg, mnist_batches(xtr, ytr, 64), args.steps, lr=5e-4, encode=True,
        test=(xte[:256], yte[:256]), device=device, verbose=True,
        log_every=100)
    t_train = time.perf_counter() - t0
    print(f"float accuracy: {acc_float:.4f}")

    print("== 3. quantize to 4-bit weights / 5-bit potential, "
          "4. compile to a Program artifact (16 SPUs, UM 128), "
          f"5. mapped inference (engine={spec.engine}) ==")
    n_img = args.test_images
    ext = encode_images(xte[:n_img], cfg.timesteps, seed=2)
    dep = deploy(params, cfg, MNIST_HW, QuantConfig(4, 5), ext,
                 labels=yte[:n_img], spec=spec, max_iters=40000)
    print(f"nonzero synapses: {dep['n_synapses']} "
          f"(post-quantization sparsity {dep['sparsity']:.4f})")
    print(f"feasible={dep['feasible']} iters={dep['iterations']} "
          f"OT depth={dep['ot_depth']} (paper: 661) "
          f"BRAMs={dep['brams']} (paper: 33.5)")
    if args.save:
        print(f"saved artifact: {dep['program'].save(args.save)}")
    print(f"mapped-engine accuracy: {dep['accuracy']:.3f} "
          f"over {n_img} images")
    print(f"latency: {dep['latency_us']:.1f} us/image   (paper: 149 us)")
    print(f"energy : {dep['energy_mj']:.5f} mJ/image (paper: 0.02563 mJ)")
    print(f"        {dep['nj_per_synapse']:.4f} nJ/synapse "
          f"(paper: 0.27675)")
    sec = {"train": t_train, **dep["seconds"]}
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
          + f" (on {device}; latency and energy are modeled for the "
            f"paper's FPGA)")
    return {**row_of(dep), "seconds": sec, "float_accuracy": acc_float,
            "losses": losses, "device": device, "engine": spec.engine}


if __name__ == "__main__":
    main()
