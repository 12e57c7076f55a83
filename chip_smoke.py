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
   ``lif_update_int`` at leak_shift in {1, 2, 4} (also through the
   ``"lif"`` tier's unchecked launch, which drains its current plane),
   the float ``lif_update`` at alpha in {0.25, 0.03125, 0.5} with a
   non-zero reset and potentials sitting on the threshold, with one
   current and with the recurrent layer's two (``LIFUpdateFn`` and the
   unchecked launch), all bit-exact (``torch.equal``, tolerance 0) in
   and out of place; the float step's gradient kernel
   ``lif_update_bwd`` on the same inputs for every surrogate, one and
   two currents, either incoming gradient absent, within ``BWD_TOL`` of
   ``lif_update_bwd_ref``, with its own record; ``spike_accum``
   on float32, bf16 and int32 at the shapes of ``tests/test_kernels.py``
   and of the SHD and MNIST nets, float32 within rtol = atol = 1e-5,
   bf16 within rtol 2e-2 / atol 1e-2 (another summation order than
   ``torch.matmul``; TF32 off), int32 and an all-zero-but-one tile
   exact, every case repeated bit for bit, float32 also with non-binary
   spikes and with weights the bf16 split cannot hold; ``wkv6`` and
   ``ssd`` on float32 and bf16 inputs with a non-zero initial state at
   the shapes of ``tests/test_wkv6_kernel.py`` and
   ``tests/test_ssd_kernel.py``, one token, a chunk's sub-chunk
   boundaries (16, 17), ragged lengths (37, 129), strong decays
   (``wkv6`` on both of its routes) and the prefill shapes of rwkv6-3b
   and zamba2-7b, against their token-by-token plain versions and their
   emulations within ``recurrence_tol``, finite, twice with the same
   bits; their bound recounted for the chunked form they compute. Cases are
   timed (per call on the card's clock, the host's enqueue time, the
   card's time alone with the enqueue hidden; for every kernel of the
   SNN paths also its unchecked launch path) beside the plain
   version's, one PyTorch library call's and the card's bound; then each
   kernel's record at the shape its path gives it;
4. the golden artifacts (``tests/golden``), all three tiers on the
   card, against their recorded outputs; then the compiler's back end
   and the static verifier: the SHD golden's graph rebuilt by the port's
   ``random_graph`` and its hw from ``SHD_HW`` (9-bit weights, 18-bit
   potentials), its assignment scheduled with ``"slack"``, lowered,
   reported and saved, equal to the golden (tables, lowering, report,
   npz arrays, ``content_hash``); the same assignment scheduled with
   ``"consecutive"`` and ``"load_balance"``, each program verified clean
   and run at B = 8, T = 100 on the fused and lif tiers (counts set to 0
   just before each run and read just after: exactly T launches of the
   tier's kernel), bit-exact with the reference tier and the recorded
   io, OT depths printed; ``verify()`` clean on both goldens, its wall
   time at SHD scale per checker and ``schedule``'s per strategy
   printed (host time of the card's machine) with the card's name and
   power limit; a MEM002 and a SCHED006 mutant refused by
   ``register(verify=True, precompile=...)`` with no engine built, the
   verifier CLI's exit codes 0 (goldens), 1 (a mutant saved to a
   temporary directory) and 2 (an unreadable file); and the golden on
   4 chips (a 2 x 2 mesh): ``chip_span``, ``mesh_hops`` and
   ``inter_chip_counts`` of the card's served spikes, and the cycle
   model's latency and energy beside the single-chip figures (modeled
   FPGA figures, not card times); then the compiler (``compile``) on the
   card machine's host with the port alone: the SHD golden's graph
   compiled from scratch equal to the golden (arrays, header but for
   wall times, ``content_hash``) and run at B = 8, T = 100 on both
   kernel tiers against the recorded io; the portfolio
   (``search=SearchConfig()``) inline and over a spawn pool of 4 while
   this process holds CUDA, each trace the reference's pinned one, the
   pooled trace equal to the inline ``early_exit=False`` one but for
   ``seconds``, the winner run on both tiers; the compiler-scale shape
   (``benchmarks/compiler_scale.py``'s 10^5 synapses, multilevel, 4
   chips) compiled in a subprocess that never starts CUDA, its OT depth
   and ``content_hash`` the reference's, verified, run on the fused tier
   (2000 x 1500 int8) with its modeled 4-chip figures; and the serving
   CLI on a missing artifact, which compiles, saves and serves it;
5. serve 32 seeded Poisson requests (T = 100) of the SHD-scale artifact
   (registered with ``verify=True``) through ``ProgramRegistry`` and
   ``MicroBatcher`` in measured mode,
   once on the default ``"fused"`` tier and once on ``"lif"``, each run
   with the launch counts set to 0 just before and read just after, and
   every request's outputs checked against the ``"reference"`` tier
   and ``Program.profile`` of the served stats equal to the reference
   tier's field by field (the cycle model's latency, power and energy
   per request printed: modeled FPGA figures, not card times), then
   each tier's engine time per timestep at B = 8; then a program
   with no internal neuron on both tiers and ``fused_step``: each
   step's packet count is its non-zero external spikes. The registry's
   ``precompile`` captures each bucket's T-step loop as a CUDA graph,
   so the drain replays graphs and the launch counts are the graphs'
   recorded launches. Then the three engines on both goldens
   (``"oracle"`` on the card, ``"python"`` on the CPU with its wall
   time, both bit-exact with the recorded io and the fused tier), the
   SHD artifact saved and re-loaded (header and arrays equal to the
   golden file's, ``content_hash`` the reference's ``SHD_HASH``), and
   each kernel tier graphed against eager and the reference tier at
   every bucket and at T in {100, ``ODD_T``}, with T launches per
   replay, an uncaptured shape run eagerly, and the warm time per
   timestep at B = 8, graphed and eager in turns, beside the card's
   name and power limit. The rest of serving (before the engines): a
   ``ShardedRunner`` of two shards on the one card (``min_shard=0``)
   and ``ExecutionSpec(mesh="auto")`` at B in ``SHARD_BATCHES``, both
   tiers, bit-exact with one engine and the reference tier, T launches
   per shard; an ``AsyncServer`` in engine mode serving 32 concurrent
   SHD requests on the registry's graphed fused engine, every output
   bit-exact with ``program.run`` and every stage sum equal to the
   latency (p50 / p99 / req/s printed); ``replay`` of a Poisson and a
   bursty trace at ``REPLAY_LOADS`` of the top bucket's capacity with
   the card's measured graphed engine time per bucket as the service
   model (p50 / p99 / shed printed);
6. train the paper's SHD SRNN (``SHD_CONFIG``, 700-300-20 recurrent,
   T = 100) at full width for 5 steps at B = 32 with
   ``repro_torch.snn.train.train`` and score it with ``evaluate``, then
   the MNIST SFNN (784-116-10, T = 10, rate-coded) the same way at
   B = 64, the launch counts set to 0 just before and read just after:
   exactly T x 3 (SHD; T x 2 MNIST) ``spike_accum`` and T x 2
   ``lif_update`` per forward, and in the backward only
   ``lif_update_bwd``, once per step and layer the loss depends on
   (``bwd_per_step``: 2 T - 1). A warm SHD step is broken down by the
   profiler (its forward holds no elementwise add). The first SHD step
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
   memory and the card's time by kernel are printed. Then the decode
   step as one CUDA graph (``make_graphed_serve_step``, captured after
   ``_grow_cache``, its capture time printed): 32 tokens graphed and 32
   eager from two copies of the grown state, tokens, every state leaf
   and the last logits equal bit for bit, no kernel-wrapper launch; a
   step past the capacity and one over another params tree raise; ms
   per token step graphed against eager in 3 interleaved pairs, tokens/s
   and the graphed step's card busy share.

Last, a capture that fails (a loop that copies to the host) must raise
and leave no graph. The last two lines are the kernels' JSON record (a
kernel's ``launches`` summed over the counted runs of the paths that
launch it: phases 4 (the back end's and the compiler's programs) and 5
for ``fused_step`` and ``lif_update_int``)
and ``{"ok": true, "device": {...}}``.
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
ODD_T = 37                       # a T no serving policy uses
SHARD_BATCHES = (1, 3, 5, 8)     # the sharded runner's ragged batches
REPLAY_REPS = 15                 # engine runs per bucket for the service model
REPLAY_S = 2.0                   # simulated seconds of each replayed trace
REPLAY_LOADS = (0.5, 0.9)        # offered rate / the top bucket's capacity
TIME_PAIRS = 3                   # graphed/eager timing pairs, interleaved
# the SHD-scale golden artifact's identity: the reference's content_hash
SHD_HASH = "2b2916b301a3678ffa1bf4427c59838bde159f778e00f7ab9df3106cff54ee01"
# the portfolio search on the SHD golden's graph and hardware: each
# candidate's (strategy, seed, feasible, OT depth) and the winner's
# content_hash, from the reference on the CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import dataclasses;
#   from repro.configs.snn_paper import SHD_HW;
#   from repro.core import SearchConfig, compile, random_graph;
#   g = random_graph(700, 320, 33000, seed=0, weight_lo=-255,
#   weight_hi=255); p = compile(g, dataclasses.replace(SHD_HW,
#   weight_bits=9, potential_bits=18), search=SearchConfig());
#   print([(c.strategy, c.seed, c.feasible, c.ot_depth) for c in
#   p.report.search.candidates], p.content_hash())"
SHD_PORTFOLIO = [("post_neuron_rr", None, True, 618),
                 ("synapse_rr", None, False, None),
                 ("weight_rr", None, False, None),
                 ("hypergraph", 0, True, 706),
                 ("framework", 0, True, 1240),
                 ("framework", 1, False, None),
                 ("framework", 2, False, None),
                 ("framework", 3, False, None)]
# the same search over a pool (SearchConfig(workers=4)), where every
# framework restart runs to its end (early_exit stops the others only
# inline), from the same command with workers=4; equal to the inline
# search with early_exit=False
SHD_PORTFOLIO_POOLED = SHD_PORTFOLIO[:5] + [("framework", 1, True, 1174),
                                            ("framework", 2, True, 1194),
                                            ("framework", 3, True, 1262)]
SHD_PORTFOLIO_HASH = \
    "9d661e22f8c3078f10d11b88e783f7961ab363b21e83f791df10725b0176fbb5"
PORTFOLIO_WORKERS = 4
# benchmarks/compiler_scale.py's PINNED 10^5-synapse shape compiled per
# chip with method="multilevel", n_chips=4: feasible, its OT depth and
# content_hash, from the reference on the CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import dataclasses;
#   from repro.core import compile;
#   from repro.core.scale import scale_hw, synthetic_graph;
#   g = synthetic_graph(100_000, topology='mixed', skew=1.0, seed=0);
#   hw = scale_hw(g, n_chips=4, spus_per_chip=16);
#   p = compile(g, dataclasses.replace(hw, n_spus=16, n_chips=1),
#   method='multilevel', n_chips=4);
#   print(p.feasible, p.ot_depth, p.content_hash())"
SCALE_OT_DEPTH = 2718
SCALE_HASH = "bb8196d01d30e3c51c2d7e9c6981a37189617137d7fc30e54489791d820f49a9"
TRAIN_STEPS = 5
SHD_BATCH, MNIST_BATCH = 32, 64
# the training path on the card against the plain versions on the CPU;
# measured on an H100 at 700 W: loss 6.9e-8, no spike differing,
# gradients 1.8e-7 (PERF.md, PR 12)
LOSS_RTOL = 1e-5                 # relative difference of the first loss
SPIKE_FLIP_FRAC = 1e-4           # share of hidden/output spikes differing
GRAD_RTOL = 1e-3                 # |g_card - g_cpu| / |g_cpu| per plane
# the float LIF step's gradient kernel against lif_update_bwd_ref on the
# same inputs: the same operations in the same order, but the sigmoid
# surrogate's exp on the card and in torch may differ in the last bits
BWD_TOL = dict(rtol=1e-5, atol=1e-6)


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
    call computes the LIF step. ``engine_*`` times the ``"lif"`` tier's
    unchecked launch (``lif_int_launcher``, draining a copy of the
    current plane) on the same buffers."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_update import (lif_int_launcher,
                                                lif_update_int,
                                                lif_update_int_ref)
    v_k, c_k, s_out = v.clone(), cur.clone(), torch.empty_like(v)
    launch = lif_int_launcher(p)
    ptrs = (v_k.data_ptr(), c_k.data_ptr(), v_k.data_ptr(),
            s_out.data_ptr(), v.numel(), _build.stream_handle(v.device))
    rec = {
        "engine_ms": median_ms(lambda: launch(*ptrs)),
        "engine_host_us": host_us(lambda: launch(*ptrs)),
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
    from repro_torch.kernels.spike_accum import (SpikeAccumFn,
                                                 launch_spike_accum,
                                                 spike_accum,
                                                 spike_accum_ref)
    b, n_post = s.shape[0], w.shape[1]
    out = spike_accum(s, w)
    stream = _build.stream_handle(s.device)
    rec = {}
    if s.is_floating_point():           # the training forward's node
        w_g = w.clone().requires_grad_()
        rec["autograd_host_us"] = host_us(lambda: SpikeAccumFn.apply(s, w_g))
    rec |= {
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
    PyTorch call computes the LIF step. ``engine_*`` times the training
    forward's unchecked launch (``launch_lif_update``) of the same step."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_update import (LIFUpdateFn,
                                                launch_lif_update,
                                                lif_update, lif_update_ref)
    kw = dict(alpha=p.alpha, v_th=p.v_threshold, v_reset=p.v_reset)
    v_out, s_out = torch.empty_like(v), torch.empty_like(v)
    stream = _build.stream_handle(v.device)
    v_g = v.clone().requires_grad_()

    def lean():
        launch_lif_update(v, cur, None, v_out, s_out, p.alpha,
                          p.v_threshold, p.v_reset, stream)

    rec = {
        "engine_ms": median_ms(lean),
        "engine_host_us": host_us(lean),
        "autograd_host_us": host_us(lambda: LIFUpdateFn.apply(
            v_g, cur, None, p, "sigmoid")),
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


def time_lif_bwd(v, cur, cur_rec, g_vnext, g_s, p, surrogate) -> dict:
    """The float LIF step's gradient kernel (``lif_update_bwd``, not a TPU
    kernel: it replaces the plain autograd of ``lif_step``): its times
    beside its plain version's and the card's bound; ``engine_*`` times
    the unchecked launch ``LIFUpdateFn.backward`` makes. No single
    PyTorch call computes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_update import (launch_lif_update_bwd,
                                                lif_update_bwd,
                                                lif_update_bwd_ref)
    kw = dict(alpha=p.alpha, v_th=p.v_threshold, surrogate=surrogate,
              current_rec=cur_rec)
    g_v, g_i = torch.empty_like(v), torch.empty_like(v)
    stream = _build.stream_handle(v.device)

    def call():
        lif_update_bwd(v, cur, g_vnext, g_s, **kw)

    def lean():
        launch_lif_update_bwd(v, cur, cur_rec, g_vnext, g_s, g_v, g_i,
                              p.alpha, p.v_threshold, surrogate, stream)

    rec = {"ms": median_ms(call), "host_us": host_us(call),
           "device_us": device_us(call), "engine_ms": median_ms(lean),
           "engine_host_us": host_us(lean),
           "plain_ms": median_ms(lambda: lif_update_bwd_ref(
               v, cur, g_vnext, g_s, p.alpha, p.v_threshold, surrogate,
               cur_rec)),
           "library_ms": None}
    # v, both currents and both incoming gradients read, two gradients
    # written; about 20 float32 operations per element (u again, the
    # surrogate's exp, divide and products, the select, two products)
    n_in = 2 + sum(t is not None for t in (cur_rec, g_vnext, g_s))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (n_in + 2) * v.numel() * 4, 20 * v.numel(), F32_OPS_PER_S)
    return rec


def print_times(what: str, rec: dict) -> None:
    lib = ("n/a" if rec["library_ms"] is None
           else f"{rec['library_ms'] * 1e3:.2f} us")
    lean = (f", unchecked launch {rec['engine_ms'] * 1e3:.2f} us (host "
            f"{rec['engine_host_us']:.2f} us/call)" if "engine_ms" in rec
            else "")
    if "autograd_host_us" in rec:
        lean += (f", under autograd (.apply, grad on) host "
                 f"{rec['autograd_host_us']:.2f} us/call")
    print(f"  {what}: kernel {rec['ms'] * 1e3:.2f} us (host "
          f"{rec['host_us']:.2f} us/call, device {rec['device_us']:.2f} "
          f"us/launch){lean}, plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
          f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']})")


def phase_kernels(dev: torch.device) -> dict:
    """Kernels vs plain versions (bit-exact) and their times, then each
    kernel's record at the serving shape on the SHD-scale artifact."""
    from repro_torch.core import Program
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_step import (fused_step, fused_step_ref,
                                                pack_dense)
    from repro_torch.kernels.lif_update import (lif_int_launcher,
                                                lif_update_int,
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
            # the "lif" tier's unchecked launch, draining its current
            v_d, c_d, s_d = v0.clone(), cur.clone(), torch.empty_like(v0)
            lif_int_launcher(p)(
                v_d.data_ptr(), c_d.data_ptr(), v_d.data_ptr(),
                s_d.data_ptr(), v0.numel(), _build.stream_handle(dev))
            torch.cuda.synchronize()
            for what, a, r in (("v", v_k, v_r), ("spikes", s_k, s_r),
                               ("v in place", v_i, v_r),
                               ("v, drained", v_d, v_r),
                               ("spikes, drained", s_d, s_r),
                               ("current, drained", c_d,
                                torch.zeros_like(cur))):
                e = max_err(a, r)
                err["lif_update_int"] = max(err["lif_update_int"], e)
                expect(torch.equal(a, r), f"lif_update_int {shape} ls={ls}: "
                       f"{what} differs (max |err| {e})")
            print(f"lif_update_int {shape} leak_shift={ls}: bit-exact, "
                  f"checked, in place and draining its current")
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
    err = {"spike_accum": 0.0, "lif_update": 0.0, "lif_update_bwd": 0.0}
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
            check_lif_two_currents(v, cur, on, p, err)
            check_lif_bwd(v, cur, p, err)
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
    # the gradient kernel's record (not a TPU kernel, so not in the
    # kernels line): SHD layer 0's backward, both currents, both gradients
    cur_rec = spike_accum(hidden, w["wr0"])
    g_vnext, g_s = (torch.randn((SHD_BATCH, 300), device=dev) * 0.1
                    for _ in range(2))
    bwd = time_lif_bwd(v, cur, cur_rec, g_vnext, g_s, p, SHD_CONFIG.surrogate)
    bwd["max_abs_err"] = err["lif_update_bwd"]
    print_times(f"lif_update_bwd record, SHD layer 0 at B={SHD_BATCH} "
                f"(two currents, {SHD_CONFIG.surrogate})", bwd)
    print(f"lif_update_bwd record: max |err| {bwd['max_abs_err']:.3g} "
          f"against lif_update_bwd_ref (rtol {BWD_TOL['rtol']}, atol "
          f"{BWD_TOL['atol']})")
    return recs


def check_lif_two_currents(v, cur, on, p, err) -> None:
    """The forward with the recurrent current added in the kernel, through
    ``LIFUpdateFn`` and the unchecked launch (in place), bit-exact with
    ``lif_update_ref(v, a + b)``. ``cur`` puts the neurons ``on`` on the
    threshold; there the recurrent plane is zero and ``a`` is ``cur``,
    elsewhere the two planes split it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_update import (LIFUpdateFn,
                                                launch_lif_update,
                                                lif_update_ref)
    rec = torch.where(on, 0.0, torch.randn_like(v) * 0.5)
    a = torch.where(on, cur, cur - rec)
    want = lif_update_ref(v, a + rec, p.alpha, p.v_threshold, p.v_reset)
    got = LIFUpdateFn.apply(v, a, rec, p, "sigmoid")
    v_i, s_i = v.clone(), torch.empty_like(v)
    launch_lif_update(v_i, a, rec, v_i, s_i, p.alpha, p.v_threshold,
                      p.v_reset, _build.stream_handle(v.device))
    torch.cuda.synchronize()
    for what, x, y in (("v", got[0], want[0]), ("spikes", got[1], want[1]),
                       ("v in place", v_i, want[0]),
                       ("spikes in place", s_i, want[1])):
        e = max_err_f(x, y)
        err["lif_update"] = max(err["lif_update"], e)
        expect(torch.equal(x, y), f"lif_update two currents {tuple(v.shape)}"
               f" {p}: {what} differs (max |err| {e})")


def check_lif_bwd(v, cur, p, err) -> None:
    """The gradient kernel (public call and the unchecked launch, one and
    two currents, each gradient present or absent, every surrogate)
    within ``BWD_TOL`` of ``lif_update_bwd_ref`` on the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_update import (launch_lif_update_bwd,
                                                lif_update_bwd,
                                                lif_update_bwd_ref)
    from repro_torch.snn.lif import SURROGATES
    g_vnext, g_s = torch.randn_like(v), torch.randn_like(v)
    rec = (torch.rand_like(v) < 0.3).float() * 0.2
    stream = _build.stream_handle(v.device)
    for surrogate in SURROGATES:
        for c_rec, gv, gs in ((None, g_vnext, g_s), (rec, g_vnext, g_s),
                              (rec, None, g_s), (None, g_vnext, None)):
            want = lif_update_bwd_ref(v, cur, gv, gs, p.alpha,
                                      p.v_threshold, surrogate, c_rec)
            got = lif_update_bwd(v, cur, gv, gs, alpha=p.alpha,
                                 v_th=p.v_threshold, surrogate=surrogate,
                                 current_rec=c_rec)
            lean = torch.empty_like(v), torch.empty_like(v)
            launch_lif_update_bwd(v, cur, c_rec, gv, gs, *lean, p.alpha,
                                  p.v_threshold, surrogate, stream)
            torch.cuda.synchronize()
            for x, y in zip(got + lean, want + want):
                e = max_err_f(x, y)
                err["lif_update_bwd"] = max(err["lif_update_bwd"], e)
                expect(torch.allclose(x, y, **BWD_TOL),
                       f"lif_update_bwd {tuple(v.shape)} {surrogate} "
                       f"recurrent={c_rec is not None} g_vnext="
                       f"{gv is not None} g_s={gs is not None}: max |err| "
                       f"{e}")
    print(f"  lif_update two currents bit-exact; lif_update_bwd within "
          f"BWD_TOL for {', '.join(SURROGATES)}, one and two currents, "
          f"absent gradients; max |err| so far {err['lif_update_bwd']:.3g}")


def ssm_inputs(kind: str, shape: tuple, dtype, dev, seed: int,
               decay: str = "mild") -> tuple:
    """Seeded inputs of ``wkv6`` ((b, s, h, n): r, k, v, w_log, u, state0)
    or ``ssd`` ((b, s, h, p, n): x, dt, a_log, b, c, state0), with a
    non-zero initial state. ``decay``: "mild" (w_log = -exp(N/2 - 1);
    a_log = log(1..H)), "model" (the decays an initialised model gives:
    w_log near -exp(-6)) or "strong" (wkv6: every other head's w_log
    uniform down to -40 a token, past the kernel's span threshold; ssd:
    exp(a_log) dt up to 50 a token)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sz):
        return torch.randn(sz, device=dev, generator=g)

    if kind == "wkv6":
        b, s, h, n = shape
        w = -torch.exp(rnd(b, s, h, n) * 0.5
                       - (6.0 if decay == "model" else 1.0))
        if decay == "strong":
            w[:, :, ::2] = -40.0 * torch.rand((b, s, (h + 1) // 2, n),
                                              device=dev, generator=g)
        return (*(rnd(b, s, h, n).to(dtype) for _ in range(3)), w,
                rnd(h, n) * 0.1, rnd(b, h, n, n) * 0.1)
    b, s, h, p, n = shape
    if decay == "strong":
        dt = torch.rand((b, s, h), device=dev, generator=g) * 2.0
        a_log = torch.log(torch.linspace(1.0, 25.0, h, device=dev))
    else:
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        a_log = torch.log(torch.arange(1, h + 1, device=dev,
                                       dtype=torch.float32))
    return (rnd(b, s, h, p).to(dtype), dt, a_log, rnd(b, s, n).to(dtype),
            rnd(b, s, n).to(dtype), rnd(b, h, p, n) * 0.1)


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
    from repro_torch.kernels.ssm_chunks import CHUNK
    c = CHUNK
    if kind == "wkv6":
        # bytes: r, k, v read and y written in their dtype, w_log read in
        # float32, u once, the state read and written. Operations, in the
        # chunked form the kernel computes (chunks of C tokens), per token
        # and head: on the tensor cores the causal scores r k^T and att v
        # (C N / 2 products each), r S0 and the state hop (N^2 each);
        # outside them about 10 float32 operations per key (the running
        # log-decay, four decayed factors and their products, the bonus)
        r, w = args[0], args[3]
        b, s, h, n = r.shape
        n_bytes = (4 * r.numel() * r.element_size() + w.numel() * 4
                   + h * n * 4 + 2 * b * h * n * n * 4)
        tc_ops = b * s * h * 2 * (c * n + 2 * n * n)
        f32_ops = b * s * h * 10 * n
        seq_ops = b * s * h * 5 * n * n
    else:
        # bytes: x read and y written in their dtype, dt, b and c read
        # once (b and c are shared by the heads), the state read and
        # written. Operations, chunked, per token and head: on the tensor
        # cores the causal M x (C P / 2 products), C S0^T and the state
        # hop (P N each), and per batch row and token the causal G = C B^T
        # (C N / 2); outside them the mask's exp and two products per
        # score (3 C / 2), x coef (P) and the decay sums (4)
        x, dt, bm = args[0], args[1], args[3]
        b, s, h, p = x.shape
        n = bm.shape[-1]
        n_bytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
                   + 2 * bm.numel() * bm.element_size() + h * 4
                   + 2 * b * h * p * n * 4)
        tc_ops = b * s * (h * 2 * (c * p // 2 + 2 * p * n) + c * n)
        f32_ops = b * s * h * (3 * c // 2 + p + 4)
        seq_ops = b * s * h * 5 * p * n
    # the least time: the bytes, or the chunked form's operations at each
    # unit's peak, whichever is longer; the sequential form's count (5
    # float32 operations per state element and token) is what the kernel
    # did before it was chunked, printed beside it
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = tc_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S
    rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rec["bound_terms_us"] = (t_bytes * 1e6, t_ops * 1e6)
    rec["seq_bound_ms"] = bound_ms(n_bytes, seq_ops, F32_OPS_PER_S)[0]
    return rec


def phase_ssm_kernels(dev: torch.device) -> dict:
    """``wkv6`` and ``ssd`` against ``wkv6_ref`` / ``ssd_ref`` on the
    card, float32 and bf16, with a non-zero initial state: one token, a
    chunk's sub-chunk boundaries (16, 17), ragged lengths, strong decays
    (``wkv6`` past its span threshold, on both of its routes; ``ssd`` at
    e^-50 a token) and the prefill shapes. Each case is also run twice
    (the same bits) and held to the kernel's emulation (its chunked
    schedule and roundings in plain torch on the card), all within
    ``recurrence_tol``, all finite. Then each one's record at the
    prefill shape of its model (rwkv6-3b: B = 8, S = 1024, H = 40, N =
    64; zamba2-7b: B = 4, S = 1024, H = 112, P = N = 64), bf16 as the
    model runs it."""
    from repro_torch.kernels.ref import ssd_ref, wkv6_ref
    from repro_torch.kernels.ssd import ssd, ssd_emulated
    from repro_torch.kernels.wkv6 import wkv6, wkv6_emulated, wkv6_routes

    paths = {"wkv6": (8, LM_PROMPT, 40, 64),
             "ssd": (4, LM_PROMPT, 112, 64, 64)}
    cases = {"wkv6": [(1, 8, 1, 8), (2, 37, 3, 8), (2, 64, 2, 16),
                      (1, 129, 4, 32), (1, 1, 2, 64), (2, 16, 3, 64),
                      (2, 17, 3, 64), ((2, 129, 4, 64), "strong"),
                      ((2, 129, 3, 16), "strong"), (paths["wkv6"], "model")],
             "ssd": [(1, 8, 1, 4, 8), (2, 29, 3, 4, 8), (1, 64, 2, 16, 16),
                     (2, 37, 3, 64, 64), (1, 129, 2, 128, 32),
                     (1, 1, 2, 64, 64), (2, 16, 3, 64, 64),
                     (2, 17, 3, 100, 64), ((2, 129, 4, 64, 64), "strong"),
                     ((1, 70, 2, 3, 16), "strong"), (paths["ssd"], "mild")]}
    err = {"wkv6": 0.0, "ssd": 0.0}
    kernels = {"wkv6": (wkv6, wkv6_ref, wkv6_emulated),
               "ssd": (ssd, ssd_ref, ssd_emulated)}
    for kind, (fn, ref, emu) in kernels.items():
        for i, case in enumerate(cases[kind]):
            shape, decay = case if isinstance(case[0], tuple) else (case,
                                                                    "mild")
            for dt in (torch.float32, torch.bfloat16):
                args = ssm_inputs(kind, shape, dt, dev, seed=i, decay=decay)
                got, again = fn(*args), fn(*args)
                want, emulated = ref(*args), emu(*args)
                torch.cuda.synchronize()
                what = f"{kind} {dt} {shape} ({decay} decay)"
                expect(got[0].dtype == dt and got[1].dtype == torch.float32
                       and all(g.shape == w.shape for g, w in zip(got, want)),
                       f"{what}: {[(g.dtype, tuple(g.shape)) for g in got]}")
                for name, g, g2, w, e in zip(("y", "state"), got, again, want,
                                             emulated):
                    expect(bool(g.isfinite().all()), f"{what}: {name} not "
                           f"finite")
                    expect(torch.equal(g, g2), f"{what}: {name} differs "
                           f"between two calls")
                    ew = max_err_f(g, w)
                    err[kind] = max(err[kind], ew)
                    expect(torch.allclose(g.float(), w.float(),
                                          **recurrence_tol(dt, w)),
                           f"{what}: {name} differs from {kind}_ref (max "
                           f"|err| {ew})")
                    expect(torch.allclose(g.float(), e.float(),
                                          **recurrence_tol(dt, e)),
                           f"{what}: {name} differs from the emulation "
                           f"(max |err| {max_err_f(g, e)})")
            if kind == "wkv6" and decay == "strong":
                routes = wkv6_routes(args[3])
                expect(bool(routes.any()) and not bool(routes.all()),
                       f"{what}: one route only ({routes.float().mean()} "
                       f"of the sub-chunks factorized)")
                print(f"wkv6 {shape}: {routes.float().mean().item():.3f} of "
                      f"the sub-chunks factorized, the rest in log space")
            print(f"{kind} {shape} ({decay} decay): float32 and bf16 within "
                  f"recurrence_tol of {kind}_ref and of the emulation, the "
                  f"same bits twice; max |err| so far {err[kind]:.3g}")
    print(f"comparison launches (not counted below): wkv6 {wkv6.launches}, "
          f"ssd {ssd.launches}")
    recs = {}
    for kind in ("wkv6", "ssd"):
        args = ssm_inputs(kind, paths[kind], torch.bfloat16, dev, seed=99,
                          decay="model")
        recs[kind] = time_ssm(kind, args)
        recs[kind]["max_abs_err"] = err[kind]
        print_times(f"{kind} record, bf16 {paths[kind]} (the prefill shape)",
                    recs[kind])
        t_bytes, t_ops = recs[kind]["bound_terms_us"]
        print(f"  {kind} bound: bytes {t_bytes:.2f} us, chunked operations "
              f"{t_ops:.2f} us -> {recs[kind]['bound_by']}; the sequential "
              f"count gave {recs[kind]['seq_bound_ms'] * 1e3:.2f} us")
        expect(recs[kind]["device_us"] >= recs[kind]["bound_ms"] * 1e3,
               f"{kind}: device time below the bound")
    return recs


def train_kernels() -> tuple:
    """The training path's kernel wrappers, whose counts are read as
    ``(spike_accum, lif_update, lif_update_bwd)``."""
    from repro_torch.kernels.lif_update import lif_update, lif_update_bwd
    from repro_torch.kernels.spike_accum import spike_accum
    return spike_accum, lif_update, lif_update_bwd


def bwd_per_step(cfg) -> int:
    """The LIF gradient kernel's launches in one backward: one per step
    and layer the loss depends on. The loss reads the output layer's
    spikes; with the hardware's delay layer i's step t feeds layer i+1's
    step t+1, so the last n-1-i steps of layer i feed nothing it reads:
    n T - n (n-1) / 2 for n layers (SHD: 199 of 200)."""
    n, t = cfg.n_layers, cfg.timesteps
    return n * t - (n * (n - 1) // 2 if cfg.delayed else 0)


def first_step(params, x, y, cfg) -> dict:
    """One training step's forward and gradients: the loss, every
    layer's spikes, the gradients, the launches (spike_accum,
    lif_update, lif_update_bwd) and the seconds (each part ended by a
    sync on the card) of the forward and of the backward."""
    from repro_torch.snn.models import is_mask, layer_spikes
    from repro_torch.snn.train import spike_count_loss

    def mark():
        if x.is_cuda:
            torch.cuda.synchronize()
        return (tuple(k.launches for k in train_kernels()),
                time.perf_counter())

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


def device_kernels(fn) -> dict[str, tuple[float, int]]:
    """The card's events under ``torch.profiler`` for one call of ``fn``
    (kernels, copies, fills): name -> (us, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (us + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0)), n + e.count)
    return by_name


KERNEL_EVENTS = ("spike_accum_kernel", "lif_update_kernel",
                 "lif_update_bwd_kernel")


def kernel_events(by_name: dict) -> tuple:
    """The profiled events of (spike_accum, lif_update, lif_update_bwd)
    in ``device_kernels``' result."""
    return tuple(sum(n for name, (_, n) in by_name.items() if key in name)
                 for key in KERNEL_EVENTS)


def step_breakdown(params, x, y, cfg, per_fwd: tuple,
                   per_bwd: tuple) -> None:
    """Where a warm SHD step's time goes: the forward and the backward on
    the host's clock, then one step under ``torch.profiler``: the card's
    time by kernel, its busy share of the unprofiled step and the card's
    launches; then the forward alone under the profiler, which must hold
    no elementwise add (the recurrent layer's two currents are added in
    the LIF kernel). Both profiles must hold the path's kernel events,
    ``per_fwd`` and ``per_bwd`` of (spike_accum, lif_update,
    lif_update_bwd), so that neither check passes on an empty trace."""
    from repro_torch.snn.models import layer_spikes

    first_step(params, x, y, cfg)                  # warm
    warm = first_step(params, x, y, cfg)
    by_name = device_kernels(lambda: first_step(params, x, y, cfg))
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    n_events = sum(n for _, n in by_name.values())
    step_ms = (warm["fwd_s"] + warm["bwd_s"]) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"train SHD warm step (forward + backward, no optimizer): "
          f"forward {warm['fwd_s'] * 1e3:.2f} ms, backward "
          f"{warm['bwd_s'] * 1e3:.2f} ms; launches forward "
          f"{warm['fwd_launches']}, backward {warm['bwd_launches']} "
          f"(spike_accum, lif_update, lif_update_bwd); card time under the "
          f"profiler {busy_ms:.2f} ms in {n_events} device events, "
          + (f"busy {busy_ms / step_ms:.3f} of the unprofiled step"
             if busy_ms else "not measured (no device events)"))
    for name, (us, n) in top:
        print(f"  {us / 1e3:8.3f} ms {n:6d} x  {name[:90]}")
    per_step = tuple(a + b for a, b in zip(per_fwd, per_bwd))
    expect(kernel_events(by_name) == per_step,
           f"the profiled SHD step holds {kernel_events(by_name)} kernel "
           f"events (spike_accum, lif_update, lif_update_bwd), want "
           f"{per_step}")
    fwd = device_kernels(lambda: layer_spikes(params, x, cfg))
    adds = sum(n for name, (_, n) in fwd.items() if "add" in name.lower())
    print(f"  the forward alone: {sum(n for _, n in fwd.values())} device "
          f"events, {adds} of them elementwise adds; by count: " + "; ".join(
              f"{n} x {name[:60]}" for name, (_, n) in sorted(
                  fwd.items(), key=lambda kv: -kv[1][1])[:5]))
    expect(kernel_events(fwd) == per_fwd,
           f"the profiled SHD forward holds {kernel_events(fwd)} kernel "
           f"events, want {per_fwd}")
    expect(adds == 0, f"the SHD forward launched {adds} adds")


def phase_train(dev: torch.device) -> dict[str, int]:
    """Train and score the SHD SRNN and the MNIST SFNN on the card; hold
    the first SHD step against the plain versions on the CPU; return
    each kernel's launches in the counted runs."""
    from repro_torch.data import (mnist_batches, shd_batches,
                                  synthetic_mnist, synthetic_shd)
    from repro_torch.snn.models import MNIST_CONFIG, SHD_CONFIG, init_params
    from repro_torch.snn.train import evaluate, train

    kernels = train_kernels()

    def counts() -> tuple:
        return tuple(k.launches for k in kernels)

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
    # per forward: 2 planes + 1 recurrent, 2 LIF steps; per backward: the
    # LIF gradient alone
    per_fwd = (t_steps * 3, t_steps * 2, 0)
    per_bwd = (0, 0, bwd_per_step(cfg))
    per_step = tuple(a + b for a, b in zip(per_fwd, per_bwd))

    card_params = {k: v.to(dev) for k, v in params.items()}
    card = first_step(card_params, x.to(dev), y.to(dev), cfg)
    cpu = first_step(params, x, y, cfg)
    expect(card["fwd_launches"] == per_fwd, f"SHD forward launched "
           f"{card['fwd_launches']} (spike_accum, lif_update, "
           f"lif_update_bwd), want {per_fwd}")
    expect(card["bwd_launches"] == per_bwd,
           f"SHD backward launched {card['bwd_launches']}, want {per_bwd}")
    expect(cpu["fwd_launches"] == cpu["bwd_launches"] == (0, 0, 0),
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

    step_breakdown(card_params, x.to(dev), y.to(dev), cfg, per_fwd, per_bwd)

    for k in kernels:
        k.launches = 0
    res = train(cfg, shd_batches(xtr, ytr, SHD_BATCH, seed=0), TRAIN_STEPS,
                lr=1e-3, encode=False, params=params)
    trained = counts()
    acc = evaluate(res.params, cfg, xte, yte, encode=False)
    shd = counts()
    expect(trained == tuple(TRAIN_STEPS * n for n in per_step),
           f"SHD training launched {trained}, want {TRAIN_STEPS} x "
           f"{per_step}")
    expect(shd == tuple(a + b for a, b in zip(trained, per_fwd)),
           f"SHD training + evaluate launched {shd} (evaluate: one "
           f"forward, no backward)")
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
          f"ms per step (host clock, each step ends in a sync), launches "
          f"per step spike_accum {per_step[0]} lif_update {per_step[1]} "
          f"lif_update_bwd {per_step[2]}, losses "
          f"{[round(v, 4) for v in res.loss_history]}; "
          f"evaluate on {len(xte)} test samples: accuracy {acc:.3f} after "
          f"{TRAIN_STEPS} steps (not a claim: five steps train nothing)")

    cfg, t_steps = MNIST_CONFIG, MNIST_CONFIG.timesteps
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = synthetic_mnist(n_train=2 * MNIST_BATCH,
                                         n_test=MNIST_BATCH, seed=0)
    print(f"train MNIST: synthetic set {xtr.shape} + {xte.shape} in "
          f"{time.perf_counter() - t0:.2f} s")
    per_fwd = (t_steps * 2, t_steps * 2, 0)
    per_step = (t_steps * 2, t_steps * 2, bwd_per_step(cfg))
    res = train(cfg, mnist_batches(xtr, ytr, MNIST_BATCH, seed=0),
                TRAIN_STEPS, lr=1e-3, seed=0, encode=True)
    trained = tuple(a - b for a, b in zip(counts(), shd))
    acc = evaluate(res.params, cfg, xte, yte, encode=True)
    launches = {k.__name__: k.launches for k in kernels}
    mnist = tuple(a - b for a, b in zip(counts(), shd))
    expect(trained == tuple(TRAIN_STEPS * n for n in per_step),
           f"MNIST training launched {trained}, want {TRAIN_STEPS} x "
           f"{per_step}")
    expect(mnist == tuple(a + b for a, b in zip(trained, per_fwd)),
           f"MNIST training + evaluate launched {mnist}")
    expect(all(np.isfinite(res.loss_history)), "MNIST: non-finite loss")
    print(f"train MNIST {cfg.layer_sizes} T={t_steps} B={MNIST_BATCH} "
          f"rate-coded: {TRAIN_STEPS} steps, "
          f"{res.wall_seconds / TRAIN_STEPS * 1e3:.1f} ms per step, launches "
          f"per step spike_accum {per_step[0]} lif_update {per_step[1]} "
          f"lif_update_bwd {per_step[2]}, losses "
          f"{[round(v, 4) for v in res.loss_history]}; "
          f"evaluate on {len(xte)} test images: accuracy {acc:.3f} (not a "
          f"claim)")
    print(f"training phase launches (SHD + MNIST, train + evaluate): "
          f"{launches}")
    return launches


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import (lif_update, lif_update_bwd,
                                                lif_update_int)
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return {"fused_step": fused_step, "lif_update_int": lif_update_int,
            "lif_update": lif_update, "lif_update_bwd": lif_update_bwd,
            "spike_accum": spike_accum, "wkv6": wkv6, "ssd": ssd}


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
    graphed_decode(name, cfg, params, logits, st_kernel, batch, dev)
    return at_prefill[kernel]


def graphed_decode(name: str, cfg, params, logits, st_prefill, batch: int,
                   dev: torch.device) -> None:
    """The decode step as one CUDA graph (``make_graphed_serve_step``),
    captured after ``_grow_cache``: LM_GEN greedy tokens graphed and
    LM_GEN eager (``make_serve_step``'s body, keeping the last logits)
    from two copies of the grown state, the counts set to 0 just before
    and read just after (no kernel wrapper in decode); tokens, the final
    state's leaves and the last logits equal bit for bit. A step past
    the capacity and a step over another params tree raise. Then ms per
    token step graphed against eager in TIME_PAIRS interleaved pairs
    (the first step of each run, which copies the state in, untimed;
    host clock and the card's clock), tokens/s and the graphed step's
    busy share under the profiler."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map
    from repro_torch.train.steps import (make_graphed_serve_step,
                                         make_serve_step)

    capacity = LM_PROMPT + LM_GEN
    grown = _grow_cache(cfg, st_prefill, batch, capacity, dev)
    tok0 = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    step = make_graphed_serve_step(cfg, params, dev)
    step.precompile(batch, capacity)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0

    g_state, tok, toks_g = tree_map(torch.clone, grown), tok0, []
    for _ in range(LM_GEN):
        tok, g_state = step(params, tok.reshape(batch, 1), g_state)
        toks_g.append(tok.clone())
    logits_g = step.last_logits.clone()
    e_state, tok, toks_e = tree_map(torch.clone, grown), tok0, []
    for _ in range(LM_GEN):
        logits_e, e_state = M.decode_step(params, cfg, tok.reshape(batch, 1),
                                          e_state)
        tok = torch.argmax(logits_e[:, -1], dim=-1).to(torch.int32)
        toks_e.append(tok)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in fns.items()}
    expect(not any(counts.values()),
           f"{name} graphed decode launched {counts}")
    expect(torch.equal(torch.stack(toks_g), torch.stack(toks_e)),
           f"{name}: graphed greedy tokens differ from eager")
    got, ref = dict(leaves(g_state)), dict(leaves(e_state))
    diff = {k: max_err_f(got[k], ref[k]) for k in got
            if not torch.equal(got[k], ref[k])}
    if not torch.equal(logits_g, logits_e):
        diff["last logits"] = max_err_f(logits_g, logits_e)
    expect(not diff, f"{name}: graphed decode differs from eager (max |err| "
           f"by leaf): {diff}")
    for what, call in (("past capacity", lambda: step(
            params, tok.reshape(batch, 1), g_state)),
            ("another params tree", lambda: step(
                dict(params), tok0.reshape(batch, 1), grown))):
        try:
            call()
        except ValueError as e:
            err = str(e)
        else:
            err = None
        expect(err is not None, f"{name}: a step {what} did not raise")
        print(f"  {name} graphed step {what} raised: {err[:90]}")

    eager = make_serve_step(cfg)

    def run(serve) -> tuple[float, float]:
        st = tree_map(torch.clone, grown)
        t, st = serve(params, tok0.reshape(batch, 1), st)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(LM_GEN - 1):
            t, st = serve(params, t.reshape(batch, 1), st)
        ev[1].record()
        torch.cuda.synchronize()
        n = LM_GEN - 1
        return ((time.perf_counter() - t0) / n * 1e3,
                ev[0].elapsed_time(ev[1]) / n)

    pairs = [(run(step), run(eager)) for _ in range(TIME_PAIRS)]
    g_ms = statistics.median(g[0] for g, _ in pairs)
    e_ms = statistics.median(e[0] for _, e in pairs)
    print(f"serve {name} graphed decode (B={batch}, capacity {capacity}): "
          f"capture {t_capture:.3f} s (warm step included); {LM_GEN} tokens "
          f"graphed and eager equal bit for bit (tokens, every state leaf, "
          f"the last logits); 0 kernel-wrapper launches; ms per token step "
          f"graphed/eager (host clock; card clock): "
          + ", ".join(f"{g[0]!r}/{e[0]!r} ({g[1]!r}/{e[1]!r})"
                      for g, e in pairs)
          + f"; tokens/s graphed {batch * 1e3 / g_ms:.1f}, eager "
          f"{batch * 1e3 / e_ms:.1f}")
    st = tree_map(torch.clone, grown)
    tok, st = step(params, tok0.reshape(batch, 1), st)
    print(f"  {name} one graphed decode step: " + device_breakdown(
        lambda: step(params, tok.reshape(batch, 1), st), g_ms / 1e3))
    del step


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


def _io(name: str) -> dict:
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        return {k: io[k] for k in io.files}


def _same_header(a: dict, b: dict) -> bool:
    """Two artifact headers equal but for the compile's wall times: the
    report's ``compile_seconds``, ``phase_seconds`` and
    ``phase_alloc_mb``, and the search trace's ``seconds`` and each
    candidate's."""
    def strip(h):
        rep = {k: v for k, v in h["report"].items()
               if k not in ("compile_seconds", "phase_seconds",
                            "phase_alloc_mb")}
        if rep.get("search"):
            rep["search"] = {
                **{k: v for k, v in rep["search"].items() if k != "seconds"},
                "candidates": [{k: v for k, v in c.items() if k != "seconds"}
                               for c in rep["search"]["candidates"]]}
        return {**h, "report": rep}
    return strip(a) == strip(b)


def phase_back_end(smi: str) -> dict[str, int]:
    """The compiler's back end and the static verifier on the card's
    machine, without jax: (a) the SHD golden's graph rebuilt by
    ``random_graph`` and its hw from ``SHD_HW``; (b) the golden's
    assignment scheduled (``"slack"``), lowered, reported and saved:
    tables, lowering, report, npz arrays and ``content_hash`` equal the
    golden's; (c) the same assignment under ``"consecutive"`` and
    ``"load_balance"``, each program verified clean and run at
    B = SERVE_BATCH, T = TIMESTEPS on the fused and lif tiers with the
    counts set to 0 just before and read just after: exactly T launches
    of the tier's kernel, bit-exact with the reference tier and the
    golden's recorded io; (d) ``verify()`` on both goldens, its wall
    time at SHD scale per checker, and ``schedule``'s per strategy;
    (e) mutants (a stale ``report.scores[0]``, MEM002; a send slot
    moved to 0, SCHED006) refused by ``register(verify=True,
    precompile=...)`` before any capture, and the verifier CLI's exit
    codes 0 / 1 / 2; (f) the golden on 4 chips (a 2 x 2 mesh): the
    multi-chip accounting of the card's served spikes and the cycle
    model's modeled FPGA figures beside the single-chip ones. Returns
    each kernel's launches in the counted runs of (c)."""
    import dataclasses
    import os
    import tempfile
    from repro_torch.configs.snn_paper import SHD_HW
    from repro_torch.core import (ExecutionSpec, Program, lower_tables,
                                  packet_stats, random_graph)
    from repro_torch.core.passes import (build_report, lower_pass,
                                         schedule_pass, validate_pass)
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.serve import ProgramRegistry

    path = GOLDEN / "shd_program_v1.npz"
    gold = Program.load(path)
    io = _io("shd")
    # (a) the graph and the hardware from the port alone
    g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
    hw = dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18)
    expect(all(np.array_equal(getattr(g, f), getattr(gold.graph, f))
               and getattr(g, f).dtype == getattr(gold.graph, f).dtype
               for f in ("pre", "post", "weight"))
           and (g.n_inputs, g.n_neurons, g.output_slice, g.lif)
           == (gold.graph.n_inputs, gold.graph.n_neurons,
               gold.graph.output_slice, gold.graph.lif),
           "random_graph differs from the SHD golden's graph")
    expect(hw == gold.hw, f"SHD_HW at 9/18 bits {hw} != golden {gold.hw}")
    # (b) schedule, lower, report, save: the golden again
    part, rep = gold.part, gold.report
    t0 = time.perf_counter()
    tables = schedule_pass(g, part, hw, method="slack")
    sched_s = time.perf_counter() - t0
    validate_pass(g, tables)
    for f in ("pre", "post", "weight", "pre_end", "post_end", "assign"):
        expect(np.array_equal(getattr(tables, f), getattr(gold.tables, f)),
               f"slack schedule: tables.{f} differs from the golden's")
    expect(tables.send_slot == gold.tables.send_slot
           and tables.send_order == gold.tables.send_order,
           "slack schedule: send slots differ from the golden's")
    lowered = lower_pass(g, tables)
    for f in dataclasses.fields(lowered):
        a, b = getattr(lowered, f.name), getattr(gold.lowered, f.name)
        expect(np.array_equal(a, b) and np.asarray(a).dtype
               == np.asarray(b).dtype, f"lowering: {f.name} differs")
    expect(np.array_equal(lower_tables(g, tables).op_pre, lowered.op_pre),
           "lower_tables differs from lower_pass")
    report = build_report(g, hw, tables, part, method=rep.method,
                          compile_seconds=rep.compile_seconds,
                          routing=lowered.routing, search=rep.search,
                          schedule_method="slack",
                          schedule_depths=rep.schedule_depths)
    report.phase_seconds = rep.phase_seconds
    rebuilt = Program(g, hw, tables, lowered, report, part)
    with tempfile.TemporaryDirectory() as tmp:
        header, arrays = _saved(rebuilt, Path(tmp) / "shd")
    gold_h, gold_a = _artifact(path)
    expect(_same_header(gold_h, header),
           "rebuilt: header differs from the golden's")
    expect(_same_arrays(gold_a, arrays),
           "rebuilt: the arrays differ from the golden's")
    expect(rebuilt.content_hash() == SHD_HASH,
           f"rebuilt content_hash {rebuilt.content_hash()} != {SHD_HASH}")
    print(f"back end shd: random_graph + SHD_HW (9/18 bits) = the golden's "
          f"graph and hw; slack schedule of its assignment in "
          f"{sched_s * 1e3:.2f} ms (host), OT depth {tables.depth}: tables, "
          f"lowering, report and saved arrays equal the golden's, "
          f"content_hash {SHD_HASH}")
    # (c) the other two strategies, verified and run on both kernel tiers
    launches = {"fused_step": 0, "lif_update_int": 0}
    ext = np.concatenate([io["ext"]] * (SERVE_BATCH // len(io["ext"])))
    want = tuple(np.concatenate([io[k]] * (SERVE_BATCH // len(io["ext"])))
                 for k in ("spikes", "v_final", "packet_counts"))
    depths = {"slack": tables.depth}
    for method in ("consecutive", "load_balance"):
        t_m = schedule_pass(g, part, hw, method=method)
        validate_pass(g, t_m)
        prog = Program(g, hw, t_m, lower_pass(g, t_m),
                       build_report(g, hw, t_m, part, method=rep.method,
                                    compile_seconds=0.0,
                                    schedule_method=method), part)
        depths[method] = t_m.depth
        vr = prog.verify()
        expect(vr.ok and not vr.diagnostics,
               f"{method}: verify not clean: {vr.summary()}")
        ref = prog.run(ext, ExecutionSpec(kernel="reference"))
        expect(same_run(ref, want[:2] + (packet_stats(want[2]),)),
               f"{method}: the reference tier differs from the golden's "
               f"recorded io")
        for k, n in _counted_tiers(prog, ext, ref, method).items():
            launches[k] += n
    print(f"back end strategies: OT depth {depths}; consecutive and "
          f"load_balance verify clean and run B={SERVE_BATCH} "
          f"T={TIMESTEPS} on the fused and lif tiers with {TIMESTEPS} "
          f"launches a run, bit-exact with the reference tier and the "
          f"golden's recorded io")
    # (d) the verifier on both goldens, and its host time at SHD scale
    for name in ("tiny", "shd"):
        vr = Program.load(GOLDEN / f"{name}_program_v1.npz").verify()
        expect(vr.ok and not vr.diagnostics,
               f"verify {name}: not clean: {vr.summary()}")
    runs = [gold.verify() for _ in range(7)]
    split = {k: statistics.median(r.checker_wall_ms[k] for r in runs)
             for k in runs[0].checkers}
    sched = {}
    for method in depths:
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            schedule_pass(g, part, hw, method=method)
            ts.append((time.perf_counter() - t0) * 1e3)
        sched[method] = statistics.median(ts)
    print(f"verify shd (host of the card's machine, median of 7): "
          f"{statistics.median(r.wall_ms for r in runs)!r} ms; per checker "
          + ", ".join(f"{k} {v!r}" for k, v in split.items())
          + " ms; schedule (median of 5) "
          + ", ".join(f"{k} {v!r}" for k, v in sched.items())
          + f" ms [{smi}]")
    # (e) mutants refused before any capture; the CLI's exit codes
    registry = ProgramRegistry()
    policy = (1, 2, 4, SERVE_BATCH)
    bad = Program.load(path)
    bad.report.scores[0] += 1
    bad_send = Program.load(path)
    t_b = bad_send.tables
    t_b.send_slot[max(t_b.send_slot, key=t_b.send_slot.__getitem__)] = 0
    for code, mutant in (("MEM002", bad), ("SCHED006", bad_send)):
        before = (fused_step.launches, lif_update_int.launches)
        try:
            registry.register(code, mutant, verify=True, precompile=policy,
                              timesteps=TIMESTEPS)
            refused = ""
        except ValueError as e:
            refused = str(e)
        expect(code in refused and code not in registry
               and not mutant._engines
               and (fused_step.launches, lif_update_int.launches) == before,
               f"mutant {code}: not refused before capture ({refused!r})")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cli = [sys.executable, "-m", "repro_torch.analysis.verify"]
    with tempfile.TemporaryDirectory() as tmp:
        stale = bad.save(Path(tmp) / "stale")
        junk = Path(tmp) / "junk.npz"
        junk.write_bytes(b"not an npz")
        codes = {}
        for what, args in (("goldens", [str(path), str(GOLDEN /
                                                      "tiny_program_v1.npz")]),
                           ("mutant", [str(stale), "--json"]),
                           ("unreadable", [str(junk)])):
            r = subprocess.run(cli + args, capture_output=True, text=True,
                               env=env, timeout=300)
            codes[what] = r.returncode
    expect(codes == {"goldens": 0, "mutant": 1, "unreadable": 2},
           f"verifier CLI exit codes {codes}")
    print(f"verify gate: MEM002 and SCHED006 mutants refused by "
          f"register(verify=True, precompile=...) with no engine built and "
          f"no launch; CLI exit codes {codes}")
    # (f) four chips: the multi-chip accounting of the served spikes
    s, v, stats = gold.run(io["ext"])
    expect(same_run((s, v, stats), (io["spikes"], io["v_final"],
                                     packet_stats(io["packet_counts"]))),
           "4 chips: the served run differs from the recorded io")
    four = Program.load(path)
    four.hw = dataclasses.replace(four.hw, n_chips=4)
    span, hops = four.chip_span(), four.mesh_hops()
    ic = four.inter_chip_counts(io["ext"], s)
    one_p, four_p = gold.profile(stats), four.profile(stats,
                                                      inter_chip_counts=ic)
    expect(four.hw.mesh_dims == (2, 2) and four.hw.spus_per_chip == 16
           and span.max() <= 4 and ic.shape == stats["packet_counts"].shape
           and int(ic.sum()) > 0
           and four_p.cycle.cycles_total > one_p.cycle.cycles_total,
           "4 chips: accounting out of shape or zero")
    print(f"4 chips (2 x 2 mesh, 16 SPUs a chip) on the served spikes: "
          f"mean chip span {float(span[span > 0].mean())!r}, mesh hops "
          f"{int(hops.sum())} over {int((hops > 0).sum())} neurons, "
          f"{int(ic.sum())} inter-chip hops in {ic.size} timesteps; "
          f"CycleModel (modeled FPGA figures, not card times): latency "
          f"{four_p.latency_us!r} us, energy {four_p.energy_mj!r} mJ on 4 "
          f"chips against {one_p.latency_us!r} us, {one_p.energy_mj!r} mJ "
          f"on one")
    return launches


def _artifact(path: Path) -> tuple[dict, dict]:
    """The JSON header and arrays of a saved artifact."""
    with np.load(path) as z:
        return (json.loads(str(z["header"][()])),
                {k: z[k] for k in z.files if k != "header"})


def _saved(program, path: Path) -> tuple[dict, dict]:
    """The JSON header and arrays of ``program.save(path)``."""
    return _artifact(program.save(path))


def _same_arrays(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _counted_tiers(prog, ext, want, what: str, tiers=("fused", "lif")
                   ) -> dict[str, int]:
    """Run ``prog`` on each kernel tier with the counts set to 0 just
    before and read just after: exactly T launches of the tier's kernel
    and none of the other, bit-exact with ``want``. Returns the
    launches by kernel."""
    from repro_torch.core import ExecutionSpec
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    launches = {"fused_step": 0, "lif_update_int": 0}
    steps = ext.shape[-2]
    for tier in tiers:
        kernel, other = {"fused": (fused_step, lif_update_int),
                         "lif": (lif_update_int, fused_step)}[tier]
        kernel.launches = other.launches = 0
        got = prog.run(ext, ExecutionSpec(kernel=tier))
        n_k, n_o = kernel.launches, other.launches
        expect(n_k == steps and n_o == 0,
               f"{what} {tier}: {n_k} launches (and {n_o} of the other "
               f"kernel), want {steps}")
        launches[kernel.__name__] += n_k
        expect(same_run(got, want), f"{what} {tier}: differs from the "
                                    f"reference tier")
    return launches


def _pool_probe(module: str) -> int:
    """A spawned worker's first task: import ``module`` (what unpickling
    a portfolio work item does), report whether CUDA came up."""
    import importlib
    importlib.import_module(module)
    return int(torch.cuda.is_initialized())


SCALE_COMPILE = """
import dataclasses, json, resource, sys, time
import torch
from repro_torch.core import compile
from repro_torch.core.scale import scale_hw, synthetic_graph
g = synthetic_graph(100_000, topology="mixed", skew=1.0, seed=0)
hw = scale_hw(g, n_chips=4, spus_per_chip=16)
hw1 = dataclasses.replace(hw, n_spus=hw.spus_per_chip, n_chips=1)
rss_mb = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
before = rss_mb()
t0 = time.perf_counter()
prog = compile(g, hw1, method="multilevel", n_chips=4)
seconds = time.perf_counter() - t0
peak = rss_mb()
prog.save(sys.argv[1])
print(json.dumps({"seconds": seconds, "rss_before_mb": before,
                  "peak_rss_mb": peak, "cuda": torch.cuda.is_initialized()}))
"""


def phase_compile(smi: str) -> dict[str, int]:
    """The compiler on the card machine's host with the port alone, and
    what it compiled on the card: (a) the SHD golden's graph compiled
    from scratch (``max_iters=20000``): its saved arrays and header
    (but for wall times) the golden's, its ``content_hash``
    ``SHD_HASH``, run at B = SERVE_BATCH, T = TIMESTEPS on the fused and
    lif tiers against the reference tier and the golden's recorded io;
    (b) the portfolio (``search=SearchConfig()``) inline and over a
    spawn pool of ``PORTFOLIO_WORKERS`` while this process holds CUDA:
    each trace the reference's (``SHD_PORTFOLIO``,
    ``SHD_PORTFOLIO_POOLED``: a pooled restart is not stopped early),
    the saved arrays equal, the pooled trace equal but for ``seconds``
    to the inline one with ``early_exit=False``, the winner
    ``SHD_PORTFOLIO_HASH`` run on both tiers; (c) the compiler-scale
    shape (10^5 synapses, multilevel, 4 chips) compiled in a subprocess
    that never touches CUDA: feasible,
    ``SCALE_OT_DEPTH``, ``SCALE_HASH``, verified clean, run on the fused
    tier (its 2000 x 1500 int8 plane) against the reference tier, with
    the cycle model's 4-chip figures; (d) the serving CLI on a missing
    artifact compiles, saves and serves it on the card, with the metrics
    of serving the saved artifact again. Counted runs set the counts to
    0 just before and read them just after: exactly T launches each.
    Returns each kernel's launches in the counted runs of (a)-(c)."""
    import concurrent.futures as cf
    import dataclasses
    import io as _io_mod
    import multiprocessing
    import os
    import tempfile
    from contextlib import redirect_stdout
    from repro_torch.configs.snn_paper import SHD_HW
    from repro_torch.core import (ExecutionSpec, Program, SearchConfig,
                                  compile, packet_stats, random_graph)
    from repro_torch.launch import serve_snn

    launches = {"fused_step": 0, "lif_update_int": 0}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    io = _io("shd")
    reps = SERVE_BATCH // len(io["ext"])
    ext = np.concatenate([io["ext"]] * reps)
    want = (np.concatenate([io["spikes"]] * reps),
            np.concatenate([io["v_final"]] * reps),
            packet_stats(np.concatenate([io["packet_counts"]] * reps)))
    g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
    hw = dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the SHD golden from scratch
        t0 = time.perf_counter()
        shd = compile(g, hw, max_iters=20000)
        shd_s = time.perf_counter() - t0
        header, arrays = _saved(shd, tmp / "shd")
        gold_h, gold_a = _artifact(GOLDEN / "shd_program_v1.npz")
        expect(_same_arrays(arrays, gold_a),
               "compiled SHD: saved arrays differ from the golden's")
        expect(_same_header(header, gold_h),
               "compiled SHD: header differs from the golden's")
        expect(shd.content_hash() == SHD_HASH,
               f"compiled SHD: content_hash {shd.content_hash()}")
        ref = shd.run(ext, ExecutionSpec(kernel="reference"))
        expect(same_run(ref, want), "compiled SHD: the reference tier "
                                    "differs from the recorded io")
        add(_counted_tiers(shd, ext, want, "compiled SHD"))
        print(f"compile shd (host of the card's machine): {shd_s!r} s, "
              f"phases {shd.report.phase_seconds}; arrays and header (but "
              f"for wall times) equal the golden's, content_hash "
              f"{SHD_HASH}; B={SERVE_BATCH} T={TIMESTEPS} on the fused and "
              f"lif tiers bit-exact with the recorded io, {TIMESTEPS} "
              f"launches a run [{smi}]")

        # (b) the portfolio, inline and over a spawn pool with CUDA live
        expect(torch.cuda.is_initialized(), "CUDA not live before the pool")
        timed, progs, saved = {}, {}, {}
        for name, cfg in (("inline", SearchConfig()),
                          ("pooled", SearchConfig(workers=PORTFOLIO_WORKERS)),
                          ("inline-full", SearchConfig(early_exit=False))):
            t0 = time.perf_counter()
            progs[name] = compile(g, hw, search=cfg)
            timed[name] = time.perf_counter() - t0
            saved[name] = _saved(progs[name], tmp / f"portfolio-{name}")
        for name, pinned in (("inline", SHD_PORTFOLIO),
                             ("pooled", SHD_PORTFOLIO_POOLED),
                             ("inline-full", SHD_PORTFOLIO_POOLED)):
            rows = [(c.strategy, c.seed, c.feasible, c.ot_depth)
                    for c in progs[name].report.search.candidates]
            expect(rows == pinned, f"portfolio {name}: candidates {rows} "
                                   f"!= the reference's")
            expect(_same_arrays(saved[name][1], saved["inline"][1])
                   and progs[name].content_hash() == SHD_PORTFOLIO_HASH,
                   f"portfolio {name}: the saved arrays differ, or "
                   f"content_hash {progs[name].content_hash()}")
        expect(_same_header(saved["pooled"][0], saved["inline-full"][0]),
               f"portfolio: {PORTFOLIO_WORKERS} workers differ from one "
               f"(early_exit=False) but for seconds")
        one = progs["inline"]
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=PORTFOLIO_WORKERS,
                                    mp_context=ctx) as pool:
            cuda_up = list(pool.map(
                _pool_probe,
                ["repro_torch.core.mapping.search"] * PORTFOLIO_WORKERS))
        pool_s = time.perf_counter() - t0
        expect(not any(cuda_up), "a spawned compile worker brought up CUDA")
        ref = one.run(ext, ExecutionSpec(kernel="reference"))
        add(_counted_tiers(one, ext, ref, "portfolio winner"))
        sel = one.report.search.selected
        print(f"compile portfolio (host): workers=1 {timed['inline']!r} "
              f"s, workers={PORTFOLIO_WORKERS} (spawn, CUDA live in this "
              f"process) {timed['pooled']!r} s, workers=1 with "
              f"early_exit=False {timed['inline-full']!r} s, a bare spawn "
              f"pool of {PORTFOLIO_WORKERS} importing the port {pool_s!r} "
              f"s; traces the reference's, the pooled one equal to the "
              f"inline early_exit=False one but for seconds; winner "
              f"{sel.strategy} / {sel.schedule_method}, OT depth "
              f"{one.ot_depth}, bit-exact with the reference tier on both "
              f"kernel tiers [{smi}]")

        # (c) the compiler's scale shape, compiled where CUDA never starts
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        r = subprocess.run([sys.executable, "-c", SCALE_COMPILE,
                            str(tmp / "scale.npz")], capture_output=True,
                           text=True, env=env, timeout=600)
        expect(r.returncode == 0, f"scale compile failed: {r.stderr[-2000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        expect(not child["cuda"], "the scale compile brought up CUDA")
        big = Program.load(tmp / "scale.npz")
        expect(big.feasible and big.ot_depth == SCALE_OT_DEPTH
               and big.content_hash() == SCALE_HASH,
               f"scale: feasible {big.feasible}, OT depth {big.ot_depth}, "
               f"content_hash {big.content_hash()}")
        vr = big.verify()
        expect(vr.ok and not vr.diagnostics,
               f"scale: verify not clean: {vr.summary()}")
        plane = vr.stats["ranges"]["dense_dtype"]
        expect(plane == "int8" and (big.graph.n_neurons,
                                    big.graph.n_internal) == (2000, 1500),
               f"scale: plane {plane} {big.graph.n_neurons} x "
               f"{big.graph.n_internal}")
        rng = np.random.default_rng(0)
        ext_big = (rng.random((SERVE_BATCH, TIMESTEPS, big.n_inputs))
                   < 0.1).astype(np.int32)
        ref = big.run(ext_big, ExecutionSpec(kernel="reference"))
        add(_counted_tiers(big, ext_big, ref, "scale", tiers=("fused",)))
        ic = big.inter_chip_counts(ext_big, ref[0])
        prof = big.profile(ref[2], inter_chip_counts=ic)
        print(f"compile scale (10^5 synapses, multilevel, 4 chips, host, "
              f"a subprocess without CUDA): {child['seconds']!r} s, peak "
              f"RSS {child['peak_rss_mb']!r} MB against "
              f"{child['rss_before_mb']!r} MB before the compile (torch "
              f"imported, the graph made), phases "
              f"{big.report.phase_seconds}; feasible, OT depth "
              f"{big.ot_depth}, content_hash {SCALE_HASH}, verify clean; "
              f"B={SERVE_BATCH} T={TIMESTEPS} on the fused tier (2000 x "
              f"1500 int8) bit-exact with the reference tier, {TIMESTEPS} "
              f"launches; CycleModel on 4 chips (modeled FPGA figures, not "
              f"card times): latency {prof.latency_us!r} us, energy "
              f"{prof.energy_mj!r} mJ a request, {int(ic.sum())} "
              f"inter-chip hops [{smi}]")

        # (d) the serving CLI compiles a missing artifact, then serves it
        argv = ["--artifact", str(tmp / "toy"), "--requests",
                str(N_REQUESTS), "--timesteps", "20"]
        out = _io_mod.StringIO()
        with redirect_stdout(out):
            first = serve_snn.main(argv)
        expect("compiled: feasible=True" in out.getvalue()
               and (tmp / "toy.npz").is_file(),
               f"serve_snn: no compile of the missing artifact: "
               f"{out.getvalue()!r}")
        with redirect_stdout(_io_mod.StringIO()):
            again = serve_snn.main(argv)
        expect(first == again, "serve_snn: the compiled artifact served "
                               "again gives other metrics")
        print(f"serve_snn on a missing artifact: compiled, saved, served "
              f"{first['requests']} requests on the card; served again "
              f"from the saved file with the same metrics (p50 "
              f"{first['p50_ms']!r} ms, modeled service times)")
    return launches


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
                            verify=True, precompile=policy,
                            timesteps=TIMESTEPS)
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
        check_profile(program, pk, st_ref, tier)
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
    check_no_internal_neurons()
    return launches


def check_profile(program, served_pkts: np.ndarray, st_ref: dict,
                  tier: str) -> None:
    """``Program.profile`` of the served drain's packet counts equals
    the profile of the reference tier's stats, field by field; prints
    the cycle model's figures per request."""
    import dataclasses
    got, want = program.profile(served_pkts), program.profile(st_ref)
    expect(got.per_sample == want.per_sample and got.cycle == want.cycle
           and got.resources == want.resources,
           f"{tier}: profile of the served stats differs from the "
           f"reference tier's")
    c = got.cycle
    print(f"serve {tier}: profile per request (CycleModel, modeled FPGA "
          f"figures for this artifact, not card times): latency "
          f"{c.latency_us!r} us, power {c.power_w!r} W, energy "
          f"{c.energy_mj!r} mJ, {c.energy_per_synapse_nj!r} nJ per synapse; "
          f"{c.cycles_total} cycles; resources "
          f"{dataclasses.asdict(got.resources)}; equal to the reference "
          f"tier's profile field by field")


def same_run(got, want) -> bool:
    """Bit-exact equality of two ``(spikes, v_final, stats)`` results."""
    return all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in (
        (got[0], want[0]), (got[1], want[1]),
        (got[2]["packet_counts"], want[2]["packet_counts"])))


def phase_sharded() -> None:
    """``ShardedRunner`` over two shards on the one card (``min_shard=0``,
    so every batch pads and masks) and ``ExecutionSpec(mesh="auto")`` on
    the SHD-scale artifact at B in SHARD_BATCHES, T = TIMESTEPS, on the
    fused and lif tiers: bit-exact with ``program.run`` on one engine
    and the reference tier; ``precompile`` captures each per-shard size
    once; a two-shard run launches the tier's kernel T times per shard
    (the counts set to 0 just before each run and read just after)."""
    from repro_torch.core import ExecutionSpec, Program
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.serve import ShardedRunner
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    rng = np.random.default_rng(6)
    reference = ExecutionSpec(kernel="reference")
    cards = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    for tier, kernel, other in (("fused", fused_step, lif_update_int),
                                ("lif", lif_update_int, fused_step)):
        one = ExecutionSpec(kernel=tier)
        auto = ExecutionSpec(kernel=tier, mesh="auto")
        two = ShardedRunner(program, spec=ExecutionSpec(
            kernel=tier, mesh=("cuda:0", "cuda:0")), min_shard=0)
        runner_auto = program.sharded_runner(auto)
        expect(two.n_shards == 2 and runner_auto.mesh == cards
               and program.sharded_runner(auto) is runner_auto,
               f"sharded {tier}: mesh {two.mesh}, auto "
               f"{program.sharded_runner(auto).mesh}")
        new = two.precompile(SHARD_BATCHES, TIMESTEPS)
        want_keys = [(two.padded_size(b), TIMESTEPS) for b in SHARD_BATCHES]
        engine = program.engine(one)
        expect(new == want_keys and two.precompile(SHARD_BATCHES,
                                                   TIMESTEPS) == []
               and all((k[0] // 2, TIMESTEPS) in engine._graphs
                       for k in want_keys),
               f"sharded {tier}: precompile prepared {new}")
        for b in SHARD_BATCHES:
            ext = (rng.random((b, TIMESTEPS, program.n_inputs))
                   < 0.1).astype(np.int32)
            want = program.run(ext, reference)
            kernel.launches = other.launches = 0
            got = two.run(ext)
            counts = (kernel.launches, other.launches)
            expect(counts == (2 * TIMESTEPS, 0),
                   f"sharded {tier} B={b}: launches {counts}, want "
                   f"({2 * TIMESTEPS}, 0)")
            for what, res in (("two shards", got),
                              ("mesh=auto", program.run(ext, auto)),
                              ("one engine", program.run(ext, one))):
                expect(same_run(res, want), f"sharded {tier} B={b}: {what} "
                       f"differs from the reference tier")
        ext = (rng.random((SERVE_BATCH, TIMESTEPS, program.n_inputs))
               < 0.1).astype(np.int32)
        engine.precompile([SERVE_BATCH], TIMESTEPS)   # both sides graphed

        def run_ms(fn) -> float:
            fn(ext)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(ext)
            return (time.perf_counter() - t0) / 5 * 1e3

        print(f"sharded {tier}: two shards on cuda:0 (min_shard=0) and "
              f"mesh=auto {cards} equal one engine and the reference tier at "
              f"B={SHARD_BATCHES}, T={TIMESTEPS}, {2 * TIMESTEPS} launches "
              f"per two-shard run; run at B={SERVE_BATCH}, graphed (warm, 5 runs, "
              f"host clock): two shards {run_ms(two.run)!r} ms, one engine "
              f"{run_ms(engine.run)!r} ms")


def phase_async_server() -> None:
    """``AsyncServer`` in engine mode on the registry's precompiled fused
    engine: N_REQUESTS seeded SHD requests submitted concurrently, every
    output bit-exact with ``program.run`` on the same request, every
    stage sum equal to the latency, the kernel launched T times per
    batch (the count set to 0 just before and read just after). Two
    rounds, each a new server: the first batch of a round runs in a new
    executor thread."""
    import asyncio
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.serve import (AsyncServer, BatchPolicy, ProgramRegistry,
                                   Request)
    policy = BatchPolicy(max_batch=SERVE_BATCH, max_wait_us=2000.0)
    registry = ProgramRegistry()
    program = registry.load("shd", GOLDEN / "shd_program_v1.npz",
                            verify=True, precompile=policy,
                            timesteps=TIMESTEPS)
    rng = np.random.default_rng(7)
    reqs = (rng.random((N_REQUESTS, TIMESTEPS, program.n_inputs))
            < 0.1).astype(np.int32)

    async def serve():
        async with AsyncServer(registry, policy=policy) as srv:
            t0 = time.perf_counter()
            done = await asyncio.gather(*[
                srv.submit(Request("shd", reqs[i], 0.0, stream=i))
                for i in range(N_REQUESTS)])
            wall = time.perf_counter() - t0
        return done, srv.metrics(), wall

    want = [program.run(r) for r in reqs]
    for round_ in (1, 2):
        fused_step.launches = 0
        done, m, wall = asyncio.run(serve())
        launches = fused_step.launches
        batches = m["models"]["shd"]["batches"]
        expect(launches == batches * TIMESTEPS,
               f"async: {launches} fused_step launches for {batches} batches")
        expect(sorted(c.stream for c in done) == list(range(N_REQUESTS)),
               "async: a request was lost")
        for c in done:
            expect(((c.queue_wait_us + c.fill_wait_us) + c.pad_us)
                   + c.compute_us == c.latency_us,
                   f"async: stream {c.stream}'s stages do not sum to its "
                   f"latency")
            s, v, st = want[c.stream]
            expect(np.array_equal(c.outputs[0], s)
                   and np.array_equal(c.outputs[1], v)
                   and np.array_equal(c.outputs[2], st["packet_counts"]),
                   f"async: stream {c.stream}'s outputs differ from "
                   f"program.run")
        t, st = m["total"], m["total"]["stages_us"]
        print(f"async server round {round_} (engine mode, fused tier, "
              f"graphed buckets): {N_REQUESTS} concurrent SHD requests in "
              f"{batches} batches, {launches} fused_step launches; p50 "
              f"{t['p50_ms']!r} ms p99 {t['p99_ms']!r} ms "
              f"{t['throughput_rps']!r} req/s (real clock, wall {wall:.3f} s);"
              f" stages (us) queue {st['queue_wait']:.1f} fill "
              f"{st['batch_fill']:.1f} pad {st['pad']:.1f} compute "
              f"{st['compute']:.1f}; batch compute (us) "
              f"{sorted({round(c.compute_us + c.pad_us, 1) for c in done})}; "
              f"outputs equal program.run, stage sums equal the latency")


def phase_replay(smi: str) -> None:
    """``replay`` of Poisson and bursty traces with the card's measured
    service model: the graphed fused engine's warm run time per bucket
    (median of REPLAY_REPS runs, host clock, outputs copied back), the
    offered rate REPLAY_LOADS of the top bucket's capacity (max_batch /
    its service time), a queue bounded at 64 (reject)."""
    from repro_torch.core import Program
    from repro_torch.serve import ArrivalTrace, BatchPolicy, replay
    policy = BatchPolicy(max_batch=SERVE_BATCH, max_queue=64)
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    engine = program.engine()
    engine.precompile(policy.buckets, TIMESTEPS)
    rng = np.random.default_rng(8)
    service = {}
    for b in policy.buckets:
        ext = (rng.random((b, TIMESTEPS, program.n_inputs))
               < 0.1).astype(np.int32)
        engine.run(ext)
        runs = []
        for _ in range(REPLAY_REPS):
            t0 = time.perf_counter()
            engine.run(ext)
            runs.append((time.perf_counter() - t0) * 1e6)
        service[b] = statistics.median(runs)
    top_qps = SERVE_BATCH / service[SERVE_BATCH] * 1e6
    print(f"replay service model (graphed fused engine, T={TIMESTEPS}, median "
          f"of {REPLAY_REPS} warm runs) us per bucket: "
          + ", ".join(f"{b}: {us!r}" for b, us in service.items())
          + f"; top bucket's capacity {top_qps!r} req/s [{smi}]")
    for kind in ("poisson", "bursty"):
        for load in REPLAY_LOADS:
            trace = getattr(ArrivalTrace, kind)(load * top_qps, REPLAY_S,
                                                seed=0)
            rep = replay(trace, policy, service.__getitem__)
            expect(rep.stage_sum_exact and rep.served + sum(rep.shed.values())
                   == rep.requests, f"replay {kind} {load}: accounting")
            print(f"replay {kind} at {load:.0%} of capacity "
                  f"({trace.offered_qps:.1f} req/s, {rep.requests} requests over {REPLAY_S} s): p50 "
                  f"{rep.p50_ms!r} ms p99 {rep.p99_ms!r} ms, shed {rep.shed} "
                  f"({rep.shed_frac:.4f}); stages (us) "
                  + ", ".join(f"{k} {v:.1f}"
                              for k, v in rep.stages_us.items()))


def phase_engines() -> None:
    """The port's three engines on both golden artifacts: ``"oracle"``
    on the card for every recorded sample, ``"python"`` (the host
    simulator, ``device="cpu"``) on the tiny io and SHD sample 0, each
    bit-exact with the recorded io and the fused tier; then the SHD
    artifact saved and re-loaded: header and arrays equal to the golden
    file's, ``content_hash`` the reference's."""
    import tempfile
    from repro_torch.core import ExecutionSpec, Program
    for name in ("tiny", "shd"):
        path = GOLDEN / f"{name}_program_v1.npz"
        program = Program.load(path)
        with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
            io = {k: io[k] for k in io.files}
        fused = program.run(io["ext"])
        oracle = program.run(io["ext"], ExecutionSpec(engine="oracle"))
        n = 1 if io["ext"].ndim == 2 else len(io["ext"])
        one = (lambda a: a) if n == 1 else (lambda a: a[0])
        t0 = time.perf_counter()
        python = program.run(one(io["ext"]),
                             ExecutionSpec(engine="python", device="cpu"))
        py_s = time.perf_counter() - t0
        for engine, got, pick in (("oracle", oracle, lambda a: a),
                                  ("fused", fused, lambda a: a),
                                  ("python", python, one)):
            for what, a, r in (("spikes", got[0], io["spikes"]),
                               ("v_final", got[1], io["v_final"]),
                               ("packet_counts", got[2]["packet_counts"],
                                io["packet_counts"])):
                r = pick(r)
                expect(a.dtype == r.dtype and np.array_equal(a, r),
                       f"golden {name} engine {engine}: {what} differs from "
                       f"the recorded io")
            if engine != "fused":
                for a, r in zip(got[:2], fused[:2]):
                    expect(np.array_equal(a, pick(r)),
                           f"golden {name}: {engine} differs from fused")
        print(f"engines {name}: oracle on the card ({n} samples), python on "
              f"the CPU ({'sample 0' if n > 1 else 'the io'}: "
              f"{py_s:.3f} s wall, OT depth {program.ot_depth}, "
              f"{program.hw.n_spus} SPUs, T = {io['spikes'].shape[-2]}) and "
              f"fused match the recorded io bit for bit")
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    with tempfile.TemporaryDirectory() as tmp:
        saved = program.save(Path(tmp) / "shd")
        with np.load(GOLDEN / "shd_program_v1.npz") as a, np.load(saved) as b:
            expect(set(a.files) == set(b.files), "save: members differ")
            expect(json.loads(str(a["header"][()]))
                   == json.loads(str(b["header"][()])), "save: header differs")
            for k in a.files:
                expect(k == "header" or (a[k].dtype == b[k].dtype
                                         and a[k].tobytes() == b[k].tobytes()),
                       f"save: array {k} differs")
        again = Program.load(saved)
    expect(program.content_hash() == again.content_hash() == SHD_HASH,
           f"content_hash {again.content_hash()} != {SHD_HASH}")
    expect(again.init_packets() == program.init_packets()
           and len(program.init_packets()) == program.report.n_init_packets,
           "init_packets differ after save and load")
    print(f"save shd: header and arrays equal the golden file's; "
          f"content_hash {SHD_HASH}; {program.report.n_init_packets} init "
          f"packets")


def phase_graphs(smi: str) -> None:
    """Each kernel tier's CUDA-graphed loop (``precompile``) against its
    eager loop and the reference tier on the SHD-scale artifact, at
    every bucket of the serving policy and at T in {TIMESTEPS, ODD_T}:
    bit-exact, T launches counted per replay, re-``precompile`` a no-op,
    an uncaptured shape run eagerly; then the warm time per timestep at
    B = SERVE_BATCH, graphed and eager interleaved."""
    from repro_torch.core import ExecutionSpec, Program, TorchMappedEngine
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.serve import BatchPolicy
    buckets = BatchPolicy(max_batch=SERVE_BATCH).buckets
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    rng = np.random.default_rng(5)
    reference = ExecutionSpec(kernel="reference")
    for tier, kernel, other in (("fused", fused_step, lif_update_int),
                                ("lif", lif_update_int, fused_step)):
        spec = ExecutionSpec(kernel=tier)
        graphed = program.engine(spec)
        eager = TorchMappedEngine(program.graph, program.lowered, spec)
        for t_steps in (TIMESTEPS, ODD_T):
            t0 = time.perf_counter()
            new = graphed.precompile(buckets, t_steps)
            cap_s = time.perf_counter() - t0
            expect(new == [(b, t_steps) for b in buckets]
                   and graphed.precompile(buckets, t_steps) == []
                   and all((b, t_steps) in graphed._graphs for b in buckets),
                   f"{tier}: precompile T={t_steps} captured {new}")
            for b in buckets + (3,):               # 3: not a bucket
                ext = (rng.random((b, t_steps, program.n_inputs))
                       < 0.1).astype(np.int32)
                want = program.run(ext, reference)
                kernel.launches = other.launches = 0
                got = graphed.run(ext)
                expect(kernel.launches == t_steps and other.launches == 0,
                       f"{tier} B={b} T={t_steps}: {kernel.launches} "
                       f"launches, want {t_steps}")
                expect(((b, t_steps) in graphed._graphs) == (b != 3),
                       f"{tier}: B={b} T={t_steps} graphed state")
                for what, a, e, r in zip(("spikes", "v_final"), got,
                                         eager.run(ext), want):
                    expect(np.array_equal(a, e) and np.array_equal(a, r),
                           f"{tier} B={b} T={t_steps}: graphed {what} "
                           f"differs from eager or the reference tier")
                expect(np.array_equal(got[2]["packet_counts"],
                                      want[2]["packet_counts"]),
                       f"{tier} B={b} T={t_steps}: packet counts differ")
            print(f"graphs {tier} T={t_steps}: captured buckets {buckets} "
                  f"in {cap_s:.3f} s; graphed runs equal eager and the "
                  f"reference tier at every bucket, {t_steps} launches per "
                  f"replay; B=3 (not captured) ran eagerly")
        # warm time per timestep at the serving batch, graphed and eager
        # in turns; a run ends in the copy of its outputs to the host
        ext = (rng.random((SERVE_BATCH, TIMESTEPS, program.n_inputs))
               < 0.1).astype(np.int32)

        def per_step_us(eng) -> float:
            eng.run(ext)
            t0 = time.perf_counter()
            for _ in range(5):
                eng.run(ext)
            return (time.perf_counter() - t0) / (5 * TIMESTEPS) * 1e6

        pairs = [(per_step_us(graphed), per_step_us(eager))
                 for _ in range(TIME_PAIRS)]
        shape = graphed._graphs[(SERVE_BATCH, TIMESTEPS)]
        replay_us = median_ms(shape.replay, iters=20, repeats=5) \
            / TIMESTEPS * 1e3
        buf = eager._buffers(SERVE_BATCH, TIMESTEPS)
        buf.ext_d.copy_(torch.from_numpy(ext.transpose(1, 0, 2).copy()))
        loop_us = median_ms(lambda: eager._loop(buf), iters=5, repeats=5) \
            / TIMESTEPS * 1e3
        print(f"graphs {tier}: engine run B={SERVE_BATCH} T={TIMESTEPS} "
              f"(warm, 5 runs each, interleaved) us per timestep "
              f"graphed/eager: "
              + ", ".join(f"{g!r}/{e!r}" for g, e in pairs)
              + f"; card clock per timestep: graph replay {replay_us!r} us, "
              f"eager loop {loop_us!r} us [{smi}]")


def check_failed_capture() -> None:
    """A capture that fails raises, and leaves no graph behind: a loop
    that copies to the host inside the capture is not capturable."""
    from repro_torch.core import ExecutionSpec, Program
    from repro_torch.kernels.fused_step import fused_step
    program = Program.load(GOLDEN / "tiny_program_v1.npz")
    eng = program.engine(ExecutionSpec(kernel="fused"))
    run_card = eng._run_card

    def syncing(buf):
        run_card(buf)
        buf.v.cpu()                        # a host copy: not capturable

    eng._run_card = syncing
    before = fused_step.launches
    try:
        eng.precompile((2,), 5)
    except RuntimeError as e:
        err = e
    else:
        err = None
    expect(err is not None, "a failed capture did not raise")
    expect(not eng._graphs and fused_step.launches == before + 5,
           "a failed capture left a graph or counted its launches")
    eng._run_card = run_card
    torch.cuda.synchronize()
    print(f"failed capture raised {type(err).__name__}: "
          f"{str(err).splitlines()[0][:120]}")


def check_no_internal_neurons() -> None:
    """A program with no internal neuron (4 inputs, no synapse) on the
    card: the fused and lif tiers and the public ``fused_step`` give each
    step's non-zero external spikes as its packet count, and launch no
    kernel (there is no neuron work)."""
    from repro_torch.core import ExecutionSpec, SNNGraph, TorchMappedEngine
    from repro_torch.core.scheduling import LoweredProgram
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.snn.lif import LIFIntParams
    none = np.zeros(0, np.int32)
    g = SNNGraph(n_inputs=4, n_neurons=4, pre=none, post=none, weight=none,
                 lif=LIFIntParams(2, 10, 0))
    lw = LoweredProgram(n_inputs=4, n_neurons=4, n_internal=0, n_spus=1,
                        depth=0, op_spu=none, op_slot=none, op_pre=none,
                        op_post_local=none, op_weight=none,
                        op_pre_end=np.zeros(0, bool),
                        op_post_end=np.zeros(0, bool),
                        routing=np.zeros((4, 1), bool))
    ext = np.random.default_rng(3).integers(-2, 3, (3, 7, 4)).astype(np.int32)
    before = (fused_step.launches, lif_update_int.launches)
    for tier in ("fused", "lif"):
        eng = TorchMappedEngine(g, lw, ExecutionSpec(kernel=tier))
        for e in (np.ones((2, 3, 4), np.int32), ext):
            spikes, v, st = eng.run(e)
            expect(spikes.shape == e.shape[:2] + (0,) and v.shape == (len(e), 0)
                   and np.array_equal(st["packet_counts"], (e != 0).sum(-1)),
                   f"no internal neurons, {tier} tier: packets "
                   f"{st['packet_counts'].tolist()}, want "
                   f"{(e != 0).sum(-1).tolist()}")
    dev = torch.device("cuda", 0)
    ext_t = torch.from_numpy(ext[:, 0]).to(dev)
    empty = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    pkt = torch.full((3,), -7, dtype=torch.int32, device=dev)
    fused_step(ext_t, empty, empty.clone(),
               torch.zeros((4, 0), dtype=torch.int16, device=dev),
               g.lif, pkt_out=pkt)
    expect(pkt.tolist() == (ext[:, 0] != 0).sum(-1).tolist(),
           f"no internal neurons, fused_step: packets {pkt.tolist()}")
    expect((fused_step.launches, lif_update_int.launches) == before,
           "no internal neurons: a kernel was launched")
    print("no internal neurons (4 inputs, no synapse): the fused and lif "
          "tiers and fused_step count each step's non-zero external "
          "spikes, e.g. [[4, 4, 4], [4, 4, 4]] for all-one spikes")


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
    back_end = phase_back_end(smi)
    compiled = phase_compile(smi)
    launches = phase_serve()
    for name in launches:
        launches[name] += back_end[name] + compiled[name]
    phase_sharded()
    phase_async_server()
    phase_replay(smi)
    phase_engines()
    phase_graphs(smi)
    launches.update(phase_train(dev))
    launches.update(phase_lm(dev))
    check_failed_capture()
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
