#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path on the card and fails (exit code 1) on any
error or mismatch; it imports neither jax nor the JAX package. Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, started together) and print ptxas' report;
3. each kernel against its plain torch version on the card:
   ``fused_step`` on int8 (910 x 126), int16 and int32 (1020 x 320)
   planes at B in {1, 3, 8, 9, 17, 64} with negative potentials and
   recurrent inputs, with 0/1 and with non-binary external spikes
   (``ODD_SPIKES``), each twice (repeatability),
   ``lif_update_int`` at leak_shift in {1, 2, 4}, the float
   ``lif_update`` at alpha in {0.25, 0.03125, 0.5} with a non-zero
   reset and potentials sitting on the threshold, all bit-exact
   (``torch.equal``, tolerance 0) in and out of place; ``spike_accum``
   on float32, bf16 and int32 at the shapes of ``tests/test_kernels.py``
   and of the SHD and MNIST nets, float32 within rtol = atol = 1e-5,
   bf16 within rtol 2e-2 / atol 1e-2 (another summation order than
   ``torch.matmul``; TF32 off), int32 and an all-zero-but-one tile
   exact, every case repeated bit for bit, float32 also with non-binary
   spikes and with weights the bf16 split cannot hold; ``wkv6`` and
   ``ssd`` on float32 and bf16 inputs with a non-zero initial state at
   the shapes of ``tests/test_wkv6_kernel.py`` and
   ``tests/test_ssd_kernel.py``, ragged lengths (37, 129) and the
   prefill shapes of rwkv6-3b and zamba2-7b, against their
   token-by-token plain versions within ``recurrence_tol``. Cases are
   timed (per call on the card's clock, the host's enqueue time, the
   card's time alone with the enqueue hidden; for ``fused_step`` and
   ``spike_accum`` also their unchecked launch path) beside the plain
   version's, one PyTorch library call's and the card's bound; then each
   kernel's record at the shape its path gives it;
4. the golden artifacts (``tests/golden``), all three tiers on the
   card, against their recorded outputs;
5. serve 32 seeded Poisson requests (T = 100) of the SHD-scale artifact
   through ``ProgramRegistry`` and ``MicroBatcher`` in measured mode,
   once on the default ``"fused"`` tier and once on ``"lif"``, each run
   with the launch counts set to 0 just before and read just after, and
   every request's outputs checked against the ``"reference"`` tier,
   then each tier's engine time per timestep at B = 8;
6. train the paper's SHD SRNN (``SHD_CONFIG``, 700-300-20 recurrent,
   T = 100) at full width for 5 steps at B = 32 with
   ``repro_torch.snn.train.train`` and score it with ``evaluate``, then
   the MNIST SFNN (784-116-10, T = 10, rate-coded) the same way at
   B = 64, the launch counts set to 0 just before and read just after:
   exactly T x 3 (SHD; T x 2 MNIST) ``spike_accum`` and T x 2
   ``lif_update`` per forward, none in the backward. The first SHD step
   is also run on the CPU through the plain versions from the same
   params and batch, and held to it: loss within relative
   ``LOSS_RTOL``, at most ``SPIKE_FLIP_FRAC`` of hidden and output
   spikes differing, gradients within relative norm ``GRAD_RTOL``.
7. serve the language models at their full published widths on random
   seeded weights made on the card (``init_model``): rwkv6-3b at B = 8
   and zamba2-7b at B = 4 (the first freed before the second is made),
   each prefilling 1024-token seeded prompts through
   ``make_prefill_step``, growing the cache and decoding 32 tokens
   greedily through ``make_serve_step``, the launch counts set to 0 just
   before and read just after: exactly one ``wkv6`` (rwkv6-3b) or
   ``ssd`` (zamba2-7b) per layer in the prefill, none in the decode. Each
   layer of the kernel prefill (its output and every state leaf) and the
   last-position logits are held to the chunked einsum path on the same
   input within ``LM_TOL``; the whole prefill is also run through the
   chunked path and its divergence and the share of greedy tokens
   agreeing are reported; prefill and decode times, tokens/s, peak
   memory and the card's time by kernel are printed.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT_OPS_PER_S = 1979e12          # H100 SXM int8 tensor-core peak: the
#                                  card's top integer rate, so ops / it is
#                                  a lower bound for any integer work
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor-core dense peak
F32_OPS_PER_S = 67e12            # H100 SXM float32 peak outside the tensor
#                                  cores: TF32 would not hold the float32
#                                  tolerance, so this is the top rate for
#                                  float32 work done as float32
TIMESTEPS = 100
FUSED_BATCHES = (1, 3, 8, 9, 17, 64)
ODD_SPIKES = (2, -1, 300, 2 ** 20)   # external spike values outside {0, 1}
N_REQUESTS = 32
SERVE_BATCH = 8
TRAIN_STEPS = 5
SHD_BATCH, MNIST_BATCH = 32, 64
# the training path on the card against the plain versions on the CPU;
# measured on an H100 at 700 W: loss 6.9e-8, no spike differing,
# gradients 1.8e-7 (PERF.md, PR 12)
LOSS_RTOL = 1e-5                 # relative difference of the first loss
SPIKE_FLIP_FRAC = 1e-4           # share of hidden/output spikes differing
GRAD_RTOL = 1e-3                 # |g_card - g_cpu| / |g_cpu| per plane


def recurrence_tol(dtype: torch.dtype, want: torch.Tensor) -> dict:
    """The state-space kernels against their token-by-token plain
    versions. Both run the recurrence in order but sum over the state in
    another order: in float32 each output errs by a few ulps of the
    largest terms, not of itself, so the absolute part scales with the
    largest output (with a model's decay near 1 the state sums ~400
    tokens and y reaches ~500: two float32 orders differ by 3e-4 there).
    bf16 inputs round y to bf16 after those sums (one ulp is 2^-7)."""
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))
    return dict(rtol=5e-2, atol=5e-2)
# LM serving (phase 7): (arch, batch); prompt and generated tokens
LM_RUNS = (("rwkv6-3b", 8), ("zamba2-7b", 4))
LM_PROMPT, LM_GEN = 1024, 32
# each layer of the kernel prefill against the chunked path on the same
# input (its output and every state leaf), and the last-position logits:
# the bound the JAX package holds its own prefill to (tests/test_lm_archs.py);
# the two differ by bf16 roundings (y of each recurrence leaves two
# differently ordered float32 sums through a bf16 rounding). Not the
# whole prefill against the whole chunked prefill: a randomly initialised
# model at full depth amplifies such a difference layer by layer until
# two bf16 runs decorrelate (the drift of the recurrent state by layer is
# printed); that divergence is reported, not gated
LM_TOL = dict(rtol=5e-2, atol=5e-2)


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 100, repeats: int = 7) -> float:
    """Median over ``repeats`` CUDA-event timings of ``iters`` calls
    back to back: the time per call on the card's clock, which is the
    host's enqueue time wherever the host is the slower of the two."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn, iters: int = 300) -> float:
    """Host time per call to enqueue ``fn`` (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_us(fn, iters: int = 50, repeats: int = 5) -> float:
    """The card's own time per call of ``fn``, with the host's enqueue
    time hidden: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, which then run back to back between two events.
    Fails if the host took longer to enqueue than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(40_000_000)          # ~20 ms at 2 GHz
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        expect(enqueue_ms < ev[0].elapsed_time(ev[1]),
               f"enqueue took {enqueue_ms:.2f} ms, longer than the spin")
        times.append(ev[1].elapsed_time(ev[2]) / iters * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int,
             ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
               if a.numel() else 0)


def max_err_f(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max().item()
                 if a.numel() else 0.0)


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            print("  ptxas:", line.strip())


def time_fused(ext, prev, v, w, p) -> dict:
    """``fused_step``'s times on these inputs beside its plain version's,
    a float32 ``torch.matmul`` of the contraction alone (exact: every
    sum is below 2**24) and the card's bound. The public call gets the
    plane packed once, as the engine holds it; ``engine_*`` times the
    engine's unchecked launch (``fused_launcher``) on the same buffers."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_step import (fused_launcher, fused_step,
                                                fused_step_ref, pack_plane)
    b, n_int = v.shape
    s_all = torch.cat([ext, prev], 1)
    s_f, w_f = s_all.float(), w.float()
    packed = pack_plane(w)
    v_k = v.clone()
    s_out = torch.empty_like(v)
    pkt_out = torch.empty((b,), dtype=torch.int32, device=v.device)

    def call():
        fused_step(ext, prev, v_k, packed, p, spikes_out=s_out,
                   pkt_out=pkt_out)

    launch = fused_launcher(packed, p, ext.shape[1])
    ptrs = (ext.data_ptr(), prev.data_ptr(), v_k.data_ptr(), s_out.data_ptr(),
            pkt_out.data_ptr(), b, _build.stream_handle(v.device))
    rec = {
        "ms": median_ms(call),
        "host_us": host_us(call),
        "device_us": device_us(call),
        "engine_ms": median_ms(lambda: launch(*ptrs)),
        "engine_host_us": host_us(lambda: launch(*ptrs)),
        "plain_ms": median_ms(lambda: fused_step_ref(ext, prev, v, w, p)),
        "library_ms": median_ms(lambda: torch.matmul(s_f, w_f)),
    }
    # bytes: the W rows of the neurons that fired (a row no batch row
    # fired is never read), the spike plane, v read and written, spikes
    # and packets written; operations: a multiply and an add for each
    # (fired pre neuron, post neuron) pair of each batch row
    rows_fired = int((s_all != 0).any(0).sum().item())
    nnz = int((s_all != 0).sum().item())
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        rows_fired * n_int * w.element_size() + s_all.numel() * 4
        + b * n_int * 4 * 3 + b * 4, 2 * nnz * n_int)
    return rec


def time_lif(v, cur, p) -> dict:
    """``lif_update_int``'s times (in place, as the engine calls it)
    beside its plain version's and the card's bound; no single PyTorch
    call computes the LIF step."""
    from repro_torch.kernels.lif_update import (lif_update_int,
                                                lif_update_int_ref)
    v_k, s_out = v.clone(), torch.empty_like(v)
    rec = {
        "ms": median_ms(lambda: lif_update_int(v_k, cur, p,
                                               out=(v_k, s_out))),
        "host_us": host_us(lambda: lif_update_int(v_k, cur, p,
                                                  out=(v_k, s_out))),
        "device_us": device_us(lambda: lif_update_int(v_k, cur, p,
                                                      out=(v_k, s_out))),
        "plain_ms": median_ms(lambda: lif_update_int_ref(v, cur, p)),
        "library_ms": None,
    }
    # v and current read, v and spikes written; about 5 integer
    # operations per element (shift, two adds, compare, select)
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * v.numel() * 4,
                                                5 * v.numel())
    return rec


def time_spike_accum(s, w) -> dict:
    """``spike_accum``'s times beside its plain version's, one
    ``torch.matmul`` of the same dtype and the card's bound;
    ``engine_*`` times its unchecked launch (``launch_spike_accum``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spike_accum import (launch_spike_accum,
                                                 spike_accum,
                                                 spike_accum_ref)
    b, n_post = s.shape[0], w.shape[1]
    out = spike_accum(s, w)
    stream = _build.stream_handle(s.device)
    rec = {
        "ms": median_ms(lambda: spike_accum(s, w)),
        "host_us": host_us(lambda: spike_accum(s, w)),
        "device_us": device_us(lambda: spike_accum(s, w)),
        "engine_ms": median_ms(lambda: launch_spike_accum(s, w, out,
                                                          stream)),
        "engine_host_us": host_us(lambda: launch_spike_accum(s, w, out,
                                                             stream)),
        "plain_ms": median_ms(lambda: spike_accum_ref(s, w)),
        "library_ms": (median_ms(lambda: torch.matmul(s, w))
                       if s.is_floating_point() else None),
    }
    # bytes: the W rows of the pre neurons that fired in some batch row
    # (a dead row is never needed), the spikes, the output written;
    # operations: a multiply and an add per (spike, post neuron) pair
    rows_fired = int((s != 0).any(0).sum().item())
    nnz = int((s != 0).sum().item())
    rate = {torch.float32: F32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S,
            torch.int32: INT_OPS_PER_S}[s.dtype]
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        rows_fired * n_post * w.element_size() + s.numel() * s.element_size()
        + b * n_post * 4, 2 * nnz * n_post, rate)
    return rec


def time_lif_float(v, cur, p) -> dict:
    """The float ``lif_update``'s times (out of place, as training calls
    it) beside its plain version's and the card's bound; no single
    PyTorch call computes the LIF step."""
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    kw = dict(alpha=p.alpha, v_th=p.v_threshold, v_reset=p.v_reset)
    rec = {
        "ms": median_ms(lambda: lif_update(v, cur, **kw)),
        "host_us": host_us(lambda: lif_update(v, cur, **kw)),
        "device_us": device_us(lambda: lif_update(v, cur, **kw)),
        "plain_ms": median_ms(lambda: lif_update_ref(v, cur, p.alpha,
                                                     p.v_threshold,
                                                     p.v_reset)),
        "library_ms": None,
    }
    # v and current read, v and spikes written; a multiply, an add, a
    # compare and two selects per element
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * v.numel() * 4,
                                                5 * v.numel(), F32_OPS_PER_S)
    return rec


def print_times(what: str, rec: dict) -> None:
    lib = ("n/a" if rec["library_ms"] is None
           else f"{rec['library_ms'] * 1e3:.2f} us")
    lean = (f", unchecked launch {rec['engine_ms'] * 1e3:.2f} us (host "
            f"{rec['engine_host_us']:.2f} us/call)" if "engine_ms" in rec
            else "")
    print(f"  {what}: kernel {rec['ms'] * 1e3:.2f} us (host "
          f"{rec['host_us']:.2f} us/call, device {rec['device_us']:.2f} "
          f"us/launch){lean}, plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
          f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']})")


def phase_kernels(dev: torch.device) -> dict:
    """Kernels vs plain versions (bit-exact) and their times, then each
    kernel's record at the serving shape on the SHD-scale artifact."""
    from repro_torch.core import Program
    from repro_torch.kernels.fused_step import (fused_step, fused_step_ref,
                                                pack_dense)
    from repro_torch.kernels.lif_update import (lif_update_int,
                                                lif_update_int_ref)
    from repro_torch.snn.lif import LIFIntParams

    rng = np.random.default_rng(0)
    fused_step.launches = lif_update_int.launches = 0

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    planes = {"int8 910x126": (784, 126, torch.int8, 127),
              "int16 1020x320": (700, 320, torch.int16, 1000),
              "int32 1020x320": (700, 320, torch.int32, 100_000)}
    err = {"fused_step": 0, "lif_update_int": 0}
    for name, (n_ext, n_int, wdt, wmax) in planes.items():
        w = t(rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)), wdt)
        for i, b in enumerate(FUSED_BATCHES):
            p = LIFIntParams(leak_shift=(1, 2, 4)[i % 3],
                             v_threshold=(15, 40, 0, 7, -3, 20)[i],
                             v_reset=(0, -5, 0, 1, 2, -1)[i])
            ext = t(rng.random((b, n_ext)) < 0.15)
            prev = t(rng.random((b, n_int)) < 0.35)   # recurrent input
            v0 = t(rng.integers(-3000, 3000, (b, n_int)))
            # external spikes are any int32: the K-steps holding one of
            # these take the kernel's exact CUDA-core products
            odd = torch.from_numpy(rng.choice(ODD_SPIKES, (b, n_ext))).to(
                dev, torch.int32)
            ext_odd = torch.where(t(rng.random((b, n_ext)) < 0.05) != 0,
                                  odd, ext)
            for kind, e_in in (("0/1", ext), ("non-binary", ext_odd)):
                v_r, s_r, pkt_r = fused_step_ref(e_in, prev, v0, w, p)
                runs = []
                for _ in range(2):                 # twice: repeatability
                    v_k = v0.clone()
                    runs.append((v_k, *fused_step(e_in, prev, v_k, w, p)[1:]))
                torch.cuda.synchronize()
                for got in runs:
                    for what, a, r in zip(("v", "spikes", "packets"), got,
                                          (v_r, s_r, pkt_r)):
                        e = max_err(a, r)
                        err["fused_step"] = max(err["fused_step"], e)
                        expect(torch.equal(a, r), f"fused_step {name} B={b} "
                               f"{kind} spikes: {what} differs from "
                               f"fused_step_ref (max |err| {e})")
            print(f"fused_step {name} B={b} {p}: bit-exact with 0/1 and "
                  f"non-binary external spikes, twice each (spike rate "
                  f"{s_r.float().mean().item():.3f})")
            if name != "int32 1020x320" or b == SERVE_BATCH:
                print_times("times", time_fused(ext, prev, v0, w, p))
    for shape in ((8, 320), (17, 126), (320,)):
        for ls in (1, 2, 4):
            p = LIFIntParams(leak_shift=ls, v_threshold=20, v_reset=-4)
            v0 = t(rng.integers(-5000, 5000, shape))
            cur = t(rng.integers(-300, 300, shape))
            v_r, s_r = lif_update_int_ref(v0, cur, p)
            v_k, s_k = lif_update_int(v0, cur, p)
            v_i = v0.clone()                           # the in-place form
            lif_update_int(v_i, cur, p, out=(v_i, torch.empty_like(v_i)))
            torch.cuda.synchronize()
            for what, a, r in (("v", v_k, v_r), ("spikes", s_k, s_r),
                               ("v in place", v_i, v_r)):
                e = max_err(a, r)
                err["lif_update_int"] = max(err["lif_update_int"], e)
                expect(torch.equal(a, r), f"lif_update_int {shape} ls={ls}: "
                       f"{what} differs (max |err| {e})")
            print(f"lif_update_int {shape} leak_shift={ls}: bit-exact")
        print_times("times", time_lif(v0, cur, p))
    print(f"comparison launches (not counted below): fused_step "
          f"{fused_step.launches}, lif_update_int {lif_update_int.launches}")

    # each kernel's record: the SHD-scale artifact's own int16 plane and
    # LIF parameters at the serving batch, spikes at the recorded rates
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    p = program.graph.lif
    b, n_ext, n_int = SERVE_BATCH, program.n_inputs, program.lowered.n_internal
    w = t(pack_dense(program.lowered).weight, torch.int16)
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        ext_rate, int_rate = io["ext"].mean(), io["spikes"].mean()
    ext = t(rng.random((b, n_ext)) < ext_rate)
    prev = t(rng.random((b, n_int)) < int_rate)
    v = t(rng.integers(-3000, p.v_threshold, (b, n_int)))
    cur = t(rng.integers(-300, 300, (b, n_int)))
    recs = {"fused_step": time_fused(ext, prev, v, w, p),
            "lif_update_int": time_lif(v, cur, p)}
    for name, rec in recs.items():
        print_times(f"{name} B={b} on the SHD-scale artifact", rec)
        rec["max_abs_err"] = err[name]
    return recs


def phase_snn_kernels(dev: torch.device) -> dict:
    """``spike_accum`` and the float ``lif_update`` against their plain
    versions, with times; then each one's record at the SHD training
    shape, on the synthetic SHD data and ``init_params`` weights."""
    from repro_torch.data import synthetic_shd
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    from repro_torch.kernels.spike_accum import spike_accum, spike_accum_ref
    from repro_torch.snn.lif import LIFParams
    from repro_torch.snn.models import SHD_CONFIG, init_params, masked_weights

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 yardsticks
    rng = np.random.default_rng(2)
    err = {"spike_accum": 0.0, "lif_update": 0.0}
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}
    groups = {"test_kernels": ([(1, 7, 5), (3, 128, 128), (5, 300, 70),
                                (8, 513, 257), (16, 1024, 116),
                                (2, 784, 116)], 0.25),
              "SHD": ([(32, 700, 300), (32, 300, 300), (32, 300, 20)], 0.08),
              "MNIST": ([(64, 784, 116), (64, 116, 10)], 0.2),
              "long pre axis": ([(3, 2049, 33)], 0.1)}
    for group, (cases, rate) in groups.items():
        for b, n_pre, n_post in cases:
            s_np = rng.random((b, n_pre)) < rate
            w_f = rng.standard_normal((n_pre, n_post)).astype(np.float32)
            w_i = rng.integers(-7, 8, (n_pre, n_post)).astype(np.int32)
            for dt in (torch.float32, torch.bfloat16, torch.int32):
                s = torch.from_numpy(s_np).to(dev, dt)
                w = torch.from_numpy(w_i if dt == torch.int32 else w_f
                                     ).to(dev, dt)
                got, want = spike_accum(s, w), spike_accum_ref(s, w)
                again = spike_accum(s, w)
                torch.cuda.synchronize()
                expect(torch.equal(got, again), f"spike_accum {dt} {b}x"
                       f"{n_pre}x{n_post}: two calls differ")
                e = max_err_f(got, want)
                err["spike_accum"] = max(err["spike_accum"], e)
                what = f"spike_accum {dt} {b}x{n_pre}x{n_post}"
                expect(got.dtype == want.dtype and got.shape == want.shape,
                       f"{what}: {got.dtype} {tuple(got.shape)}")
                expect(torch.equal(got, want) if dt == torch.int32
                       else torch.allclose(got, want, **tol[dt]),
                       f"{what}: differs from spike_accum_ref "
                       f"(max |err| {e})")
        print(f"spike_accum {group} shapes {cases} (spike rate {rate}): "
              f"float32 and bf16 within tolerance, int32 exact, each "
              f"repeated bit for bit; max |err| so far "
              f"{err['spike_accum']:.3g}")
    # float32 K-steps the bf16 split cannot hold take FFMA products:
    # spikes outside {0, 1}, weights below 2^-100
    for case in ("non-binary spikes", "weights below 2^-100"):
        s = (torch.from_numpy(rng.random((32, 700)) < 0.1)).to(dev,
                                                              torch.float32)
        w = torch.from_numpy(rng.standard_normal((700, 300)).astype(
            np.float32)).to(dev)
        if case == "non-binary spikes":
            s = s * torch.from_numpy(rng.choice([0.5, -2.0, 3.0], s.shape)
                                     ).to(dev, torch.float32)
        else:
            w[::5] *= 2.0 ** -110
        got, again, want = spike_accum(s, w), spike_accum(s, w), \
            spike_accum_ref(s, w)
        torch.cuda.synchronize()
        e = max_err_f(got, want)
        err["spike_accum"] = max(err["spike_accum"], e)
        expect(torch.equal(got, again)
               and torch.allclose(got, want, **tol[torch.float32]),
               f"spike_accum float32 {case}: max |err| {e}, or not repeated")
        print(f"spike_accum float32 32x700x300 with {case}: within "
              f"tolerance (max |err| {e:.3g}), repeated bit for bit")
    for dt in (torch.float32, torch.int32):     # one live tile, then none
        s = torch.zeros((8, 512), device=dev, dtype=dt)
        s[0, 300] = 1
        w = torch.from_numpy(rng.integers(-7, 8, (512, 128))).to(dev, dt) \
            if dt == torch.int32 else torch.randn((512, 128), device=dev)
        got = spike_accum(s, w)
        torch.cuda.synchronize()
        expect(torch.equal(got[0], w[300].to(got.dtype))
               and not got[1:].any(), f"zero tiles {dt}: not exact")
        expect(not spike_accum(torch.zeros_like(s), w).any(),
               f"all-zero spikes {dt}: not exact zeros")
    print("spike_accum all-zero-but-one tile and all-zero spikes: exact")

    for shape in ((32, 300), (64, 116), (7,), (13, 300)):
        for alpha in (0.25, 0.03125, 0.5):
            v = torch.randn(shape, device=dev)
            cur = torch.randn(shape, device=dev) * 2.0
            # half the neurons sit on the threshold: a contracted FMA
            # would round some of them to the other side
            on = torch.rand(shape, device=dev) < 0.5
            cur = torch.where(on, 1.0 - (1.0 - alpha) * v, cur)
            for reset in (0.0, -0.25):
                p = LIFParams(alpha, 1.0, reset)
                want = lif_update_ref(v, cur, alpha, 1.0, reset)
                got = lif_update(v, cur, alpha=alpha, v_th=1.0, v_reset=reset)
                v_i = v.clone()                          # the in-place form
                lif_update(v_i, cur, alpha=alpha, v_th=1.0, v_reset=reset,
                           out=(v_i, torch.empty_like(v_i)))
                torch.cuda.synchronize()
                for what, a, r in (("v", got[0], want[0]),
                                   ("spikes", got[1], want[1]),
                                   ("v in place", v_i, want[0])):
                    e = max_err_f(a, r)
                    err["lif_update"] = max(err["lif_update"], e)
                    expect(torch.equal(a, r), f"lif_update {shape} "
                           f"alpha={alpha} reset={reset}: {what} differs "
                           f"(max |err| {e})")
            print(f"lif_update {shape} alpha={alpha} reset 0 and -0.25: "
                  f"bit-exact (spike rate {want[1].mean().item():.3f})")
        print_times("times", time_lif_float(v, cur, p))

    # each kernel's record: SHD layer 0 at B = 32, its input spikes at
    # t = 50 of the synthetic set and its masked init_params weights
    xtr = synthetic_shd(n_train=SHD_BATCH, n_test=1, seed=0)[0]
    w = {k: v.to(dev) for k, v in masked_weights(
        init_params(SHD_CONFIG, torch.Generator().manual_seed(0), dev),
        SHD_CONFIG).items()}
    s0 = torch.from_numpy(xtr[:, 50, :]).to(dev, torch.float32)
    hidden = (torch.rand((SHD_BATCH, 300), device=dev) < 0.05).float()
    for what, s, wk in (("300x300", hidden, w["wr0"]),
                        ("300x20", hidden, w["w1"])):
        print_times(f"spike_accum B={SHD_BATCH} {what} (spike rate "
                    f"{s.mean().item():.3f})", time_spike_accum(s, wk))
    p = SHD_CONFIG.lif
    v = torch.randn((SHD_BATCH, 300), device=dev) * 0.5
    cur = spike_accum(s0, w["w0"])
    recs = {"spike_accum": time_spike_accum(s0, w["w0"]),
            "lif_update": time_lif_float(v, cur, p)}
    for name, rec in recs.items():
        print_times(f"{name} record, SHD layer 0 at B={SHD_BATCH}", rec)
        rec["max_abs_err"] = err[name]
    return recs


def ssm_inputs(kind: str, shape: tuple, dtype, dev, seed: int,
               model_decay: bool = False) -> tuple:
    """Seeded inputs of ``wkv6`` ((b, s, h, n): r, k, v, w_log, u,
    state0) or ``ssd`` ((b, s, h, p, n): x, dt, a_log, b, c, state0),
    with a non-zero initial state. ``model_decay``: the decays an
    initialised model gives (w_log near -exp(-6); a_log = log(1..H))."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sz):
        return torch.randn(sz, device=dev, generator=g)

    if kind == "wkv6":
        b, s, h, n = shape
        w = -torch.exp(rnd(b, s, h, n) * 0.5 - (6.0 if model_decay else 1.0))
        return (*(rnd(b, s, h, n).to(dtype) for _ in range(3)), w,
                rnd(h, n) * 0.1, rnd(b, h, n, n) * 0.1)
    b, s, h, p, n = shape
    return (rnd(b, s, h, p).to(dtype),
            torch.nn.functional.softplus(rnd(b, s, h)),
            torch.log(torch.arange(1, h + 1, device=dev,
                                   dtype=torch.float32)),
            rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype),
            rnd(b, h, p, n) * 0.1)


def time_ssm(kind: str, args: tuple) -> dict:
    """``wkv6``'s or ``ssd``'s times beside its plain version's (one
    Python loop over the tokens, a few ms per hundred tokens, so timed
    over few calls) and the card's bound; no single PyTorch call computes
    either recurrence."""
    from repro_torch.kernels.ref import ssd_ref, wkv6_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    fn, ref = (wkv6, wkv6_ref) if kind == "wkv6" else (ssd, ssd_ref)
    rec = {"ms": median_ms(lambda: fn(*args), iters=20, repeats=5),
           "host_us": host_us(lambda: fn(*args), iters=50),
           "device_us": device_us(lambda: fn(*args), iters=20),
           "plain_ms": median_ms(lambda: ref(*args), iters=1, repeats=3),
           "library_ms": None}
    if kind == "wkv6":
        # bytes: r, k, v read and y written in their dtype, w_log read in
        # float32, u once, the state read and written; operations per
        # token and head: y = r S (2 N^2), S = diag(e^w) S + k v^T (3 N^2)
        r, w = args[0], args[3]
        b, s, h, n = r.shape
        n_bytes = (4 * r.numel() * r.element_size() + w.numel() * 4
                   + h * n * 4 + 2 * b * h * n * n * 4)
        n_ops = b * s * h * 5 * n * n
    else:
        # bytes: x read and y written in their dtype, dt, b and c read
        # once (b and c are shared by the heads), the state read and
        # written; operations per token and head: the update (3 P N) and
        # y = S c (2 P N)
        x, dt, bm = args[0], args[1], args[3]
        b, s, h, p = x.shape
        n = bm.shape[-1]
        n_bytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
                   + 2 * bm.numel() * bm.element_size() + h * 4
                   + 2 * b * h * p * n * 4)
        n_ops = b * s * h * 5 * p * n
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops, F32_OPS_PER_S)
    return rec


def phase_ssm_kernels(dev: torch.device) -> dict:
    """``wkv6`` and ``ssd`` against ``wkv6_ref`` / ``ssd_ref`` on the
    card, float32 and bf16, with a non-zero initial state and ragged
    sequence lengths; then each one's record at the prefill shape of its
    model (rwkv6-3b: B = 8, S = 1024, H = 40, N = 64; zamba2-7b: B = 4,
    S = 1024, H = 112, P = N = 64), bf16 as the model runs it."""
    from repro_torch.kernels.ref import ssd_ref, wkv6_ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6

    paths = {"wkv6": (8, LM_PROMPT, 40, 64),
             "ssd": (4, LM_PROMPT, 112, 64, 64)}
    shapes = {"wkv6": [(1, 8, 1, 8), (2, 37, 3, 8), (2, 64, 2, 16),
                       (1, 129, 4, 32), paths["wkv6"]],
              "ssd": [(1, 8, 1, 4, 8), (2, 29, 3, 4, 8), (1, 64, 2, 16, 16),
                      (2, 37, 3, 64, 64), (1, 129, 2, 128, 32),
                      paths["ssd"]]}
    err = {"wkv6": 0.0, "ssd": 0.0}
    for kind, fn, ref in (("wkv6", wkv6, wkv6_ref), ("ssd", ssd, ssd_ref)):
        for i, shape in enumerate(shapes[kind]):
            for dt in (torch.float32, torch.bfloat16):
                args = ssm_inputs(kind, shape, dt, dev, seed=i,
                                  model_decay=shape == paths[kind])
                got, want = fn(*args), ref(*args)
                torch.cuda.synchronize()
                what = f"{kind} {dt} {shape}"
                expect(got[0].dtype == dt and got[1].dtype == torch.float32
                       and all(g.shape == w.shape for g, w in zip(got, want)),
                       f"{what}: {[(g.dtype, tuple(g.shape)) for g in got]}")
                for name, g, w in zip(("y", "state"), got, want):
                    e = max_err_f(g, w)
                    err[kind] = max(err[kind], e)
                    expect(torch.allclose(g.float(), w.float(),
                                          **recurrence_tol(dt, w)),
                           f"{what}: {name} differs from {kind}_ref (max "
                           f"|err| {e})")
            print(f"{kind} {shape}: float32 and bf16 within recurrence_tol "
                  f"of {kind}_ref (non-zero initial state); max |err| so "
                  f"far {err[kind]:.3g}")
    print(f"comparison launches (not counted below): wkv6 {wkv6.launches}, "
          f"ssd {ssd.launches}")
    recs = {}
    for kind in ("wkv6", "ssd"):
        args = ssm_inputs(kind, paths[kind], torch.bfloat16, dev, seed=99,
                          model_decay=True)
        recs[kind] = time_ssm(kind, args)
        recs[kind]["max_abs_err"] = err[kind]
        print_times(f"{kind} record, bf16 {paths[kind]} (the prefill shape)",
                    recs[kind])
    return recs


def first_step(params, x, y, cfg) -> dict:
    """One training step's forward and gradients: the loss, every
    layer's spikes, the gradients, the launches (spike_accum,
    lif_update) and the seconds (each part ended by a sync on the card)
    of the forward and of the backward."""
    from repro_torch.kernels.lif_update import lif_update
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.snn.models import is_mask, layer_spikes
    from repro_torch.snn.train import spike_count_loss

    def mark():
        if x.is_cuda:
            torch.cuda.synchronize()
        return (spike_accum.launches, lif_update.launches), time.perf_counter()

    trained = {k: v.detach().requires_grad_() for k, v in params.items()
               if not is_mask(k)}
    c0, t0 = mark()
    trains = layer_spikes({**params, **trained}, x, cfg)
    loss = spike_count_loss(trains[-1].sum(0), y)
    c1, t1 = mark()
    grads = torch.autograd.grad(loss, list(trained.values()))
    c2, t2 = mark()
    return {"loss": loss.item(), "trains": [t.detach() for t in trains],
            "grads": dict(zip(trained, grads)),
            "fwd_launches": tuple(b - a for a, b in zip(c0, c1)),
            "bwd_launches": tuple(b - a for a, b in zip(c1, c2)),
            "fwd_s": t1 - t0, "bwd_s": t2 - t1}


def step_breakdown(params, x, y, cfg) -> None:
    """Where a warm SHD step's time goes: the forward and the backward on
    the host's clock, then one step under ``torch.profiler``: the card's
    time by kernel and its busy share of the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    first_step(params, x, y, cfg)                  # warm
    warm = first_step(params, x, y, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first_step(params, x, y, cfg)
    by_name = {}                # the card's own events: kernels, copies
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(by_name.values()) / 1e3
    step_ms = (warm["fwd_s"] + warm["bwd_s"]) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"train SHD warm step (forward + backward, no optimizer): "
          f"forward {warm['fwd_s'] * 1e3:.2f} ms, backward "
          f"{warm['bwd_s'] * 1e3:.2f} ms; card time under the profiler "
          f"{busy_ms:.2f} ms, "
          + (f"busy {busy_ms / step_ms:.3f} of the unprofiled step"
             if busy_ms else "not measured (no device events)"))
    for name, us in top:
        print(f"  {us / 1e3:8.3f} ms  {name[:90]}")


def phase_train(dev: torch.device) -> dict[str, int]:
    """Train and score the SHD SRNN and the MNIST SFNN on the card; hold
    the first SHD step against the plain versions on the CPU; return
    each kernel's launches in the counted runs."""
    from repro_torch.data import (mnist_batches, shd_batches,
                                  synthetic_mnist, synthetic_shd)
    from repro_torch.kernels.lif_update import lif_update
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.snn.models import MNIST_CONFIG, SHD_CONFIG, init_params
    from repro_torch.snn.train import evaluate, train

    cfg, t_steps = SHD_CONFIG, SHD_CONFIG.timesteps
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = synthetic_shd(n_train=2 * SHD_BATCH,
                                       n_test=SHD_BATCH,
                                       timesteps=t_steps, seed=0)
    print(f"train SHD: synthetic set {xtr.shape} + {xte.shape} in "
          f"{time.perf_counter() - t0:.2f} s, input spike rate "
          f"{xtr.mean():.4f}")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x_np, y_np = next(shd_batches(xtr, ytr, SHD_BATCH, seed=0))
    x, y = torch.from_numpy(x_np), torch.from_numpy(y_np).long()
    per_fwd = (t_steps * 3, t_steps * 2)        # 2 planes + 1 recurrent; 2 LIF

    card_params = {k: v.to(dev) for k, v in params.items()}
    card = first_step(card_params, x.to(dev), y.to(dev), cfg)
    cpu = first_step(params, x, y, cfg)
    expect(card["fwd_launches"] == per_fwd, f"SHD forward launched "
           f"{card['fwd_launches']} (spike_accum, lif_update), want {per_fwd}")
    expect(card["bwd_launches"] == (0, 0),
           f"SHD backward launched {card['bwd_launches']}")
    expect(cpu["fwd_launches"] == cpu["bwd_launches"] == (0, 0),
           "the CPU step launched a kernel")
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    flips = [float((a.cpu() != b).float().mean())
             for a, b in zip(card["trains"], cpu["trains"])]
    grad_rel = {k: float((card["grads"][k].cpu() - g).norm() / g.norm())
                for k, g in cpu["grads"].items()}
    print(f"train SHD first step, card vs plain versions on the CPU: loss "
          f"{card['loss']:.6f} vs {cpu['loss']:.6f} (relative "
          f"{loss_rel:.3g}, limit {LOSS_RTOL}); spikes differing hidden "
          f"{flips[0]:.3g} output {flips[1]:.3g} (limit {SPIKE_FLIP_FRAC}); "
          f"gradient relative norms "
          f"{', '.join(f'{k} {e:.3g}' for k, e in grad_rel.items())} "
          f"(limit {GRAD_RTOL}); hidden spike rate "
          f"{cpu['trains'][0].mean().item():.4f}; launches per forward "
          f"{card['fwd_launches']}, backward {card['bwd_launches']}; "
          f"forward + backward {card['fwd_s'] + card['bwd_s']:.3f} s on the "
          f"card (first step), {cpu['fwd_s'] + cpu['bwd_s']:.3f} s on the "
          f"CPU")
    expect(np.isfinite(card["loss"]) and loss_rel <= LOSS_RTOL,
           f"SHD first loss differs: relative {loss_rel}")
    expect(max(flips) <= SPIKE_FLIP_FRAC, f"SHD spikes differ: {flips}")
    expect(max(grad_rel.values()) <= GRAD_RTOL,
           f"SHD gradients differ: {grad_rel}")

    step_breakdown(card_params, x.to(dev), y.to(dev), cfg)

    spike_accum.launches = lif_update.launches = 0
    res = train(cfg, shd_batches(xtr, ytr, SHD_BATCH, seed=0), TRAIN_STEPS,
                lr=1e-3, encode=False, params=params)
    trained = (spike_accum.launches, lif_update.launches)
    acc = evaluate(res.params, cfg, xte, yte, encode=False)
    shd = (spike_accum.launches, lif_update.launches)
    expect(trained == tuple(TRAIN_STEPS * n for n in per_fwd),
           f"SHD training launched {trained}, want {TRAIN_STEPS} x {per_fwd}"
           f" (forward only: the backward launches none)")
    expect(shd == tuple((TRAIN_STEPS + 1) * n for n in per_fwd),
           f"SHD training + evaluate launched {shd}")
    expect(all(np.isfinite(res.loss_history))
           and all(bool(v.isfinite().all()) for v in res.params.values())
           and all(v.is_cuda for v in res.params.values()),
           "SHD training: non-finite loss or params, or params off the card")
    expect(abs(res.loss_history[0] - card["loss"])
           <= LOSS_RTOL * abs(card["loss"]),
           f"SHD training's first loss {res.loss_history[0]} != "
           f"{card['loss']}")
    print(f"train SHD {cfg.layer_sizes} recurrent T={t_steps} B={SHD_BATCH}:"
          f" {TRAIN_STEPS} steps, {res.wall_seconds / TRAIN_STEPS * 1e3:.1f} "
          f"ms per step (host clock, each step ends in a sync), forward "
          f"launches per step spike_accum {per_fwd[0]} lif_update "
          f"{per_fwd[1]}, losses {[round(v, 4) for v in res.loss_history]}; "
          f"evaluate on {len(xte)} test samples: accuracy {acc:.3f} after "
          f"{TRAIN_STEPS} steps (not a claim: five steps train nothing)")

    cfg, t_steps = MNIST_CONFIG, MNIST_CONFIG.timesteps
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = synthetic_mnist(n_train=2 * MNIST_BATCH,
                                         n_test=MNIST_BATCH, seed=0)
    print(f"train MNIST: synthetic set {xtr.shape} + {xte.shape} in "
          f"{time.perf_counter() - t0:.2f} s")
    per_fwd = (t_steps * 2, t_steps * 2)
    res = train(cfg, mnist_batches(xtr, ytr, MNIST_BATCH, seed=0),
                TRAIN_STEPS, lr=1e-3, seed=0, encode=True)
    trained = tuple(a - b for a, b in zip((spike_accum.launches,
                                           lif_update.launches), shd))
    acc = evaluate(res.params, cfg, xte, yte, encode=True)
    launches = {"spike_accum": spike_accum.launches,
                "lif_update": lif_update.launches}
    mnist = tuple(a - b for a, b in zip(launches.values(), shd))
    expect(trained == tuple(TRAIN_STEPS * n for n in per_fwd),
           f"MNIST training launched {trained}, want {TRAIN_STEPS} x "
           f"{per_fwd}")
    expect(mnist == tuple((TRAIN_STEPS + 1) * n for n in per_fwd),
           f"MNIST training + evaluate launched {mnist}")
    expect(all(np.isfinite(res.loss_history)), "MNIST: non-finite loss")
    print(f"train MNIST {cfg.layer_sizes} T={t_steps} B={MNIST_BATCH} "
          f"rate-coded: {TRAIN_STEPS} steps, "
          f"{res.wall_seconds / TRAIN_STEPS * 1e3:.1f} ms per step, forward "
          f"launches per step spike_accum {per_fwd[0]} lif_update "
          f"{per_fwd[1]}, losses {[round(v, 4) for v in res.loss_history]}; "
          f"evaluate on {len(xte)} test images: accuracy {acc:.3f} (not a "
          f"claim)")
    print(f"training phase launches (SHD + MNIST, train + evaluate): "
          f"{launches}")
    return launches


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update, lif_update_int
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return {"fused_step": fused_step, "lif_update_int": lif_update_int,
            "lif_update": lif_update, "spike_accum": spike_accum,
            "wkv6": wkv6, "ssd": ssd}


def leaves(tree: dict, path: str = "") -> list:
    """(path, tensor) for every leaf of a nested dict of tensors."""
    out = []
    for k, v in tree.items():
        out += (leaves(v, f"{path}/{k}") if isinstance(v, dict)
                else [(f"{path}/{k}", v)])
    return out


def decode(serve, params, logits, state, batch: int) -> tuple[list, float]:
    """Greedy decode of LM_GEN tokens; returns them and the seconds."""
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_GEN):
        tok, state = serve(params, tok.reshape(batch, 1), state)
        toks.append(tok)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def layerwise_prefill(params, cfg, batch_in) -> tuple[dict, torch.Tensor,
                                                     torch.Tensor]:
    """One more kernel prefill in which every recurrent layer also runs
    through the chunked path on the same input (the kernel side carries
    on). Returns, per leaf (the layer's output and each state leaf), the
    largest |err| over the layers and whether every layer was within
    LM_TOL; the prefill's last-position logits; and those of the last
    layer's chunked output."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as M
    from repro_torch.models import rwkv as RW
    from repro_torch.train.steps import make_prefill_step

    mod, attr = (RW, "rwkv_block") if cfg.family == "ssm" \
        else (M2, "mamba2_block")
    block = getattr(mod, attr)
    worst, last = {}, {}

    def both(p, x, cfg, state, single_step=False, kernels=True):
        out, st = block(p, x, cfg, state, single_step, kernels=True)
        out_c, st_c = block(p, x, cfg, state, single_step, kernels=False)
        for k, a, b in [("out", out, out_c)] + [(k, st[k], st_c[k])
                                               for k in st]:
            e, ok = worst.get(k, (0.0, True))
            worst[k] = (max(e, max_err_f(a, b)),
                        ok and torch.allclose(a.float(), b.float(), **LM_TOL))
        last["x"] = out_c
        return out, st

    setattr(mod, attr, both)
    try:
        logits, _ = make_prefill_step(cfg)(params, batch_in)
    finally:
        setattr(mod, attr, block)
    x = L.apply_norm(params["final_norm"], last["x"][:, -1:], cfg.norm_eps)
    return worst, logits, M.unembed_hidden(params, cfg, x)


def device_breakdown(fn, host_s: float) -> str:
    """The card's time under ``torch.profiler`` for one call of ``fn``,
    by kernel (top 5) and its busy share of ``host_s``, the unprofiled
    call's host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(by_name.values()) / 1e3
    if not busy_ms:
        return "card time not measured (no device events)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"card busy {busy_ms:.2f} ms, {busy_ms / (host_s * 1e3):.3f} of "
            f"the unprofiled {host_s * 1e3:.2f} ms; top: " + "; ".join(
                f"{us / 1e3:.3f} ms {name[:70]}" for name, us in top))


def serve_lm(name: str, batch: int, dev: torch.device) -> int:
    """Serve one full-width LM: prefill LM_PROMPT tokens of ``batch``
    seeded prompts, grow the cache, decode LM_GEN tokens greedily; the
    counts set to 0 just before and read just after. Then hold every
    layer of the kernel prefill to the chunked path on the same input
    (``layerwise_prefill``), run the whole prefill through the chunked
    path (its divergence and greedy tokens reported, not gated: a
    randomly initialised model at this depth amplifies a one-ulp
    difference layer by layer) and break the times down. Returns the
    kernel's launches in the counted run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config(name)
    kernel = "wkv6" if cfg.family == "ssm" else "ssd"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in leaves(params))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, LM_PROMPT))).to(dev)
    batch_in = {"tokens": prompts}
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    capacity = LM_PROMPT + LM_GEN

    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    logits, st_kernel = prefill(params, batch_in)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    at_prefill = {k: f.launches for k, f in fns.items()}
    state = _grow_cache(cfg, st_kernel, batch, capacity, dev)
    toks, t_decode = decode(serve, params, logits, state, batch)
    at_decode = {k: f.launches for k, f in fns.items()}
    want = {k: (cfg.n_layers if k == kernel else 0) for k in fns}
    expect(at_prefill == want, f"{name} prefill launched {at_prefill}, want "
           f"{want}")
    expect(at_decode == at_prefill, f"{name} decode launched "
           f"{ {k: at_decode[k] - at_prefill[k] for k in fns} }")
    expect(all(bool(t.isfinite().all()) for t in (logits, *toks))
           and all(((t >= 0) & (t < cfg.vocab_size)).all() for t in toks),
           f"{name}: non-finite logits or tokens out of range")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, batch_in)                 # warm: not counted, timed
    torch.cuda.synchronize()
    t_prefill_warm = time.perf_counter() - t0

    worst, logits_k, logits_c = layerwise_prefill(params, cfg, batch_in)
    worst["last logits"] = (max_err_f(logits_k, logits_c), torch.allclose(
        logits_k, logits_c, **LM_TOL))
    expect(torch.equal(logits_k, logits), f"{name}: the checked prefill's "
           f"logits differ from the served prefill's")
    print(f"{name} every layer of the kernel prefill vs the chunked path on "
          f"the same input (limit rtol = atol = {LM_TOL['rtol']}, largest "
          f"over {cfg.n_layers} layers): " + ", ".join(
              f"{k} max |err| {e:.3g}{'' if ok else ' FAIL'}"
              for k, (e, ok) in worst.items()))
    expect(all(ok for _, ok in worst.values()),
           f"{name}: a layer of the kernel prefill differs from the chunked "
           f"path")

    t0 = time.perf_counter()
    plain, st_plain = make_prefill_step(cfg, kernels=False)(params, batch_in)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    expect(fns[kernel].launches == cfg.n_layers * 3,
           f"{name}: the chunked prefill launched {kernel}")
    got, ref = dict(leaves(st_kernel)), dict(leaves(st_plain))
    expect(got.keys() == ref.keys() and all(
        got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        for k in got), f"{name}: the two prefills' states differ in layout")
    plain_state = _grow_cache(cfg, st_plain, batch, capacity, dev)
    plain_toks, _ = decode(serve, params, plain, plain_state, batch)
    agree = float((torch.stack(toks) == torch.stack(plain_toks))
                  .float().mean())
    # how the two whole prefills drift apart with depth: the recurrent
    # state of layer i is a function of that layer's input alone
    rec = "/rwkv/wkv" if cfg.family == "ssm" else "/mamba/ssm"
    drift = {i: float((got[rec][i] - ref[rec][i]).norm() / ref[rec][i].norm())
             for i in sorted({min(j, cfg.n_layers - 1) for j in (
                 0, 1, 2, cfg.n_layers // 4, cfg.n_layers // 2,
                 3 * cfg.n_layers // 4, cfg.n_layers - 1)})}
    print(f"{name} whole kernel prefill vs whole chunked prefill (not "
          f"gated): logits max |err| {max_err_f(logits, plain):.3g}, "
          + ", ".join(f"{k} {max_err_f(g, ref[k]):.3g}"
                      for k, g in got.items())
          + f"; {rec} relative difference by layer "
          + ", ".join(f"{i}: {d:.2g}" for i, d in drift.items())
          + f"; greedy tokens agreeing {agree:.3f}")
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"serve {name} (full width, {n_params / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers) B={batch} prompt {LM_PROMPT} gen "
          f"{LM_GEN}: init {t_init:.2f} s on the card; prefill "
          f"{t_prefill * 1e3:.1f} ms (first), {t_prefill_warm * 1e3:.1f} ms "
          f"(warm), chunked prefill {t_plain * 1e3:.1f} ms; decode "
          f"{t_decode / LM_GEN * 1e3:.2f} ms per token step "
          f"({LM_GEN * batch / t_decode:.1f} tokens/s); launches: prefill "
          f"{at_prefill[kernel]} {kernel}, decode 0; max memory allocated "
          f"{mem / 2**30:.2f} GiB")
    print(f"  first sequence: {torch.stack(toks)[:16, 0].tolist()}")

    print(f"  {name} warm prefill: " + device_breakdown(
        lambda: prefill(params, batch_in), t_prefill_warm))
    state = _grow_cache(cfg, st_kernel, batch, capacity, dev)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    serve(params, tok, state)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(params, tok, state)
    torch.cuda.synchronize()
    print(f"  {name} one decode step: " + device_breakdown(
        lambda: serve(params, tok, state), time.perf_counter() - t0))
    return at_prefill[kernel]


def phase_lm(dev: torch.device) -> dict[str, int]:
    """Serve rwkv6-3b, then zamba2-7b (the first freed before the second
    is made); return each kernel's launches in its model's counted run."""
    launches = {}
    for name, batch in LM_RUNS:
        n = serve_lm(name, batch, dev)
        launches["wkv6" if name.startswith("rwkv") else "ssd"] = n
        torch.cuda.empty_cache()
    return launches


def phase_golden() -> None:
    from repro_torch.core import ExecutionSpec, Program
    for name in ("tiny", "shd"):
        program = Program.load(GOLDEN / f"{name}_program_v1.npz")
        with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
            for tier in ("fused", "lif", "reference"):
                s, v, st = program.run(io["ext"], ExecutionSpec(kernel=tier))
                for what, a, r in (("spikes", s, io["spikes"]),
                                   ("v_final", v, io["v_final"]),
                                   ("packet_counts", st["packet_counts"],
                                    io["packet_counts"])):
                    expect(a.dtype == r.dtype and np.array_equal(a, r),
                           f"golden {name} tier {tier}: {what} differs")
            print(f"golden {name} (ext {io['ext'].shape}): fused, lif, "
                  f"reference match the recorded outputs on the card")


def phase_serve() -> dict[str, int]:
    """Serve the SHD-scale artifact on the fused and lif tiers; return
    each kernel's launches in the run of its tier."""
    from repro_torch.core import ExecutionSpec
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.serve import BatchPolicy, MicroBatcher, ProgramRegistry

    policy = BatchPolicy(max_batch=SERVE_BATCH)
    registry = ProgramRegistry()
    program = registry.load("shd", GOLDEN / "shd_program_v1.npz",
                            precompile=policy, timesteps=TIMESTEPS)
    rng = np.random.default_rng(1)
    requests = (rng.random((N_REQUESTS, TIMESTEPS, program.n_inputs))
                < 0.1).astype(np.int32)
    arrivals = np.cumsum(rng.exponential(1000.0, N_REQUESTS))
    s_ref, v_ref, st_ref = program.run(requests,
                                       ExecutionSpec(kernel="reference"))
    launches = {}
    for tier, runner in (("fused", registry.runner("shd")),
                         ("lif", registry.runner(
                             "shd", ExecutionSpec(kernel="lif")))):
        if tier == "lif":                  # warm before the counted run
            runner.precompile(policy.buckets, TIMESTEPS)
        batcher = MicroBatcher(policy, runner=runner, service_model=None)
        fused_step.launches = lif_update_int.launches = 0
        t0 = time.perf_counter()
        res = batcher.drain(arrivals, requests)
        wall = time.perf_counter() - t0
        counts = {"fused_step": fused_step.launches,
                  "lif_update_int": lif_update_int.launches}
        kernel = "fused_step" if tier == "fused" else "lif_update_int"
        other = "lif_update_int" if tier == "fused" else "fused_step"
        steps = len(res.batches) * TIMESTEPS
        expect(res.n_served == N_REQUESTS, f"{tier}: {res.n_shed} shed")
        expect(counts[kernel] == steps,
               f"{tier}: {kernel} launched {counts[kernel]} times, want "
               f"{len(res.batches)} batches x {TIMESTEPS} = {steps}")
        expect(counts[other] == 0, f"{tier}: {other} launched too")
        s, v, pk = res.outputs
        expect(np.array_equal(s, s_ref) and np.array_equal(v, v_ref)
               and np.array_equal(pk, st_ref["packet_counts"]),
               f"{tier}: served outputs differ from the reference tier")
        m = res.metrics()
        print(f"serve {tier}: {N_REQUESTS} requests in {len(res.batches)} "
              f"batches {m['buckets']}, {counts[kernel]} {kernel} launches "
              f"({counts[kernel] / N_REQUESTS:.1f} per request); "
              f"p50 {m['p50_ms']:.3f} ms p99 {m['p99_ms']:.3f} ms "
              f"throughput {m['throughput_rps']:.1f} req/s "
              f"(simulated arrivals, measured service); wall {wall:.3f} s; "
              f"outputs match the reference tier")
        launches[kernel] = counts[kernel]
        # the engine's time per timestep at the serving batch, warm: a
        # run ends in the copy of its outputs to the host
        runner(requests[:SERVE_BATCH])
        t0 = time.perf_counter()
        for _ in range(5):
            runner(requests[:SERVE_BATCH])
        per_step = (time.perf_counter() - t0) / (5 * TIMESTEPS)
        print(f"serve {tier}: engine run B={SERVE_BATCH} T={TIMESTEPS} "
              f"(warm, 5 runs): {per_step * 1e6:.2f} us per timestep")
    return launches


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core  # noqa: F401  (fails outside the repo)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_card()
    phase_build()
    recs = phase_kernels(dev)
    recs.update(phase_snn_kernels(dev))
    recs.update(phase_ssm_kernels(dev))
    phase_golden()
    launches = phase_serve()
    launches.update(phase_train(dev))
    launches.update(phase_lm(dev))
    meta = {
        "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                       "src/repro/kernels/fused_step.py:122"),
        "lif_update_int": ("src/repro_torch/kernels/csrc/lif_update.cu",
                           "src/repro/kernels/lif_update.py:76"),
        "spike_accum": ("src/repro_torch/kernels/csrc/spike_accum.cu",
                        "src/repro/kernels/spike_accum.py:33"),
        "lif_update": ("src/repro_torch/kernels/csrc/lif_update.cu",
                       "src/repro/kernels/lif_update.py:58"),
        "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/wkv6.py:40"),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                "src/repro/kernels/ssd.py:28"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
