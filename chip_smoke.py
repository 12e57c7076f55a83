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
   (``ODD_SPIKES``), each twice (repeatability), then ``fused_run``
   (all T steps of a run in one launch) on the int8 and int16 planes at
   the same batches (T = 100 at B = 8, else ``ODD_T``) against
   ``fused_run_ref`` and T ``fused_step`` launches, twice, bit-exact, the
   int32 1020 x 320 plane (too large for a cluster's shared memory)
   refused, and on the SHD-scale artifact's recorded spike trains (B =
   8, T = 100) against ``fused_run_emulated`` on the CPU;
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
   kernel's record at the shape its path gives it (``fused_run``'s also
   per step, beside T ``fused_step`` launches of the same run, a run
   over all-zero spikes and T cluster barriers alone, the serial
   floor);
4. the golden artifacts (``tests/golden``), all three tiers on the
   card, against their recorded outputs; then the compiler's back end
   and the static verifier: the SHD golden's graph rebuilt by the port's
   ``random_graph`` and its hw from ``SHD_HW`` (9-bit weights, 18-bit
   potentials), its assignment scheduled with ``"slack"``, lowered,
   reported and saved, equal to the golden (tables, lowering, report,
   npz arrays, ``content_hash``); the same assignment scheduled with
   ``"consecutive"`` and ``"load_balance"``, each program verified clean
   and run at B = 8, T = 100 on the fused and lif tiers (counts set to 0
   just before each run and read just after: exactly one ``fused_run``
   on the fused tier where the plane fits a cluster's shared memory and
   T ``fused_step`` where it does not, T ``lif_update_int`` on the lif
   tier; ``tier_launches``), bit-exact with the reference tier and the recorded
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
   (2000 x 1500 int8; the fused path it takes printed) with its modeled
   4-chip figures; and the serving
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
   ``precompile`` captures each bucket's T-step loop as a CUDA graph
   (on the fused tier one ``fused_run`` launch), so the drain replays
   graphs and the launch counts are the graphs' recorded launches. Then the three engines on both goldens
   (``"oracle"`` on the card, ``"python"`` on the CPU with its wall
   time, both bit-exact with the recorded io and the fused tier), the
   SHD artifact saved and re-loaded (header and arrays equal to the
   golden file's, ``content_hash`` the reference's ``SHD_HASH``), and
   each kernel tier graphed against eager and the reference tier at
   every bucket and at T in {100, ``ODD_T``}, with one ``fused_run``
   (fused) or T ``lif_update_int`` (lif) launches per replay and per
   eager run, an uncaptured shape run eagerly, and the warm time per
   timestep at B = 8, graphed and eager in turns, beside the card's
   name and power limit. The rest of serving (before the engines): a
   ``ShardedRunner`` of two shards on the one card (``min_shard=0``)
   and ``ExecutionSpec(mesh="auto")`` at B in ``SHARD_BATCHES``, both
   tiers, bit-exact with one engine and the reference tier, one run's
   launches per shard; an ``AsyncServer`` in engine mode serving 32 concurrent
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
   and the graphed step's card busy share. Then, zamba2-7b freed, the
   dense stablelm-12b (``LM_DENSE``: 40 layers, d_model 5120, LayerNorm,
   qkv bias, 25 % partial RoPE, GQA 32 / 8 heads of 160, untied head;
   12.144 B bf16 parameters) at B = 8 the same way through the same
   entry points: no kernel on its path, so every counter must read 0
   over the prefill and the decode; finite logits and in-range tokens;
   one decode step over per-layer cache lists (``unroll=True``) equal to
   the stacked step bit for bit; the prefill's last logits against a
   prefill of 1023 tokens and one decode step (reported, not gated: a
   randomly initialised 40-layer model amplifies rounding); times, peak
   memory and the card's time by kernel; then the same graphed decode.
   Then the last four families the same way (``LM_FAMILIES``, each
   freed before the next is made; every count 0; graphed = eager and
   unrolled = stacked bit for bit): qwen3-moe-30b-a3b at full width cut
   to 12 of its 48 MoE layers (128 experts, top 8; the parameters
   printed) at B = 8; deepseek-v3-671b at full width cut to 4 layers (its 3 dense MLA
   layers and 1 MLA MoE layer of 256 experts and the shared expert;
   15.11 B; the init's peak printed) at B = 4, its unrolled step over
   both stacks' latent caches; qwen2-vl-7b (M-RoPE, the prompts' three
   position streams arange(P), the decode's from the cache length on
   the card) at B = 8; musicgen-medium (4 codebooks: [B, P, 4] prompts,
   [B, 4] greedy tokens a step) at B = 8. The MoE prefills' capacity
   drops are printed with the last-logits agreement.
8. train the language models on the card (``phase_lm_train``), the
   launch counts set to 0 just before and read just after: the training
   path launches none of the six kernels. qwen2-1.5b (``TRAIN_LM``) at
   full width (1.544 B bf16 parameters; B = 8, S = 1024; remat, loss
   chunk 512, float32 Adam moments) takes 5 steps through the training
   CLI's calls (``synthetic_batch``, ``make_train_step``): finite
   losses, every parameter leaf updated, ms per step (first and warm,
   the host clock ending in the loss's read), tokens/s, the card's time
   by kernel and its busy share, peak memory; its (params, opt_state)
   is saved by ``CheckpointManager`` and restored onto the card bit for
   bit (seconds and bytes printed); then one step through
   ``launch.train.main`` with ``--micro 2`` and one with int8 moments,
   each from the same seed: the first loss within ``BF16_LOSS_RTOL`` of
   the 5-step run's, peaks printed. Then its first step at 2 layers (B =
   ``CUT_B``, S = ``CUT_S``) on the card and on the card machine's CPU
   from the same parameters: the loss within ``BF16_LOSS_RTOL`` and
   every gradient within a relative norm of ``BF16_GRAD_RTOL``. Then
   rwkv6-3b (2 layers) and zamba2-7b (6 layers: one shared-block
   period) at full width, B = ``CUT_B``, S = ``CUT_S``, one step each
   through the chunked recurrences, then qwen3-moe-30b-a3b, qwen2-vl-7b
   and musicgen-medium (2 layers each) and deepseek-v3-671b (1 dense + 1
   MoE layer; gradients only, ``NO_ADAM``): every gradient finite and
   non-zero. Then a 2-layer full-width qwen3-moe-30b-a3b prefill (B =
   ``CUT_B``, S = ``CUT_S``) on the card and on the card machine's CPU
   from the same weights cast to float32: at most ``ROUTE_FLIP_FRAC`` of
   the (layer, token) top-k route sets differ, and the logits of the
   tokens whose routes and drops agree in every layer are within
   ``LM_TOL``; the same in bf16 is reported, not gated.
   Last, ``wkv6`` and ``ssd`` must raise on an input that requires grad.
9. the mesh side (``phase_mesh``), the launch counts set to 0 just
   before and read just after its nccl part, again around the qwen3-moe,
   MLA and codebook fake-group prefills, and again around each split
   decode (none of the six kernels is on them; the recurrent prefills
   between count their own): a
   one-rank nccl process group (a ``HashStore``; ``NCCL_SOCKET_IFNAME``
   set to ``lo`` unless given) and ``init_device_mesh("cuda", (1, 1),
   ("data", "model"))`` with ``pick_strategy``'s fsdp rules for
   qwen2-1.5b's ``train_4k`` cell; ``MESH_STEPS`` ruled steps of
   qwen2-1.5b at full width (B = 8, S = 1024; every parameter and Adam
   leaf a DTensor, placed before the steps), then as many plain steps
   from the same seed, in turn: the losses and every parameter leaf
   equal bit for bit; ms per step and the steps' peak memory of each,
   beside the card's name and power limit. Then
   ``compress_error_feedback`` over the model's real gradient tree, two
   rounds, on the card and on the card machine's CPU: q, scales and the
   carried error bit for bit; ms per round. Then the ruled run's state
   after two steps (its host snapshot) resharded by ``reshard_tree``
   onto ``replan_mesh(1, model_parallel=1)`` and stepped once: equal to
   the ruled run's third step bit for bit. Then qwen3-moe-30b-a3b at full
   width, depth-cut as in phase 8 (B = ``CUT_B``, S = ``CUT_S``, two
   microbatches), one step under its ``train_4k`` rules (``tp_ep``) on
   the same (1, 1) mesh: equal to the plain step bit for bit (every axis
   has one rank, so nothing is split). Last (``fake_group_prefill``), the
   nccl group gone, rank 0 of a fake process group of
   ``FAKE_RANKS`` ranks (``"fake"``: its collectives do nothing, so the
   values are not checked) on a ``"cuda"`` (1, 8) mesh prefills the
   full-depth, full-width qwen3-moe-30b-a3b (B = 8, S = ``LM_PROMPT``)
   under ``prefill_32k``'s rules from its own blocks (random, made on the
   card: 1/8 of the experts, heads and vocabulary): the FLOPs of
   ``launch.hlo_analysis.analyze`` of that run equal the same rank's
   count on meta, and the meta peak is within ``PEAK_TOL`` of
   ``max_memory_allocated``; ms (warm) and device ms by op printed beside
   phase 7's whole-model prefill. In the same group, deepseek-v3-671b cut
   to 4 layers (B = 4) the same way, MLA on 16 of its 128 heads and its
   latent cache on rank 0's capacity rows, and the full musicgen-medium
   (B = 8), its 4 codebook heads on 256 of 2048 vocabulary columns each
   (the logits gathered to [B, 1, 4, 2048]); then the
   full-width rwkv6-3b (B = 8, full depth) and zamba2-7b (B = 4, cut to
   6 layers) prefills on rank 0's
   head shard (5 of 40, 14 of 112 heads; the leaves these layers gather
   whole over ``model`` held whole, so both runs read defined values):
   the chunked run (``kernels=False``) counted on meta and on the card
   (FLOPs equal, peak within ``PEAK_TOL``), the kernel run with the
   counts set to 0 just before and read just after (32 ``wkv6`` / 6
   ``ssd`` launches on [B, S, H/8, 64]), every layer of a kernel run
   within ``LM_TOL`` of the chunked path on the same input, the whole
   runs' states compared (reported), ms. Last, rank 0 of a fake group of
   16 on a (1, 16) mesh: one eager stablelm-12b decode step (B = 8)
   under ``decode_32k``'s rules over its 2,048 capacity rows of all 8
   K/V heads (the split-capacity decode), ms, peak and device ms by
   kernel, then one layer's split decode captured as a CUDA graph (equal
   to eager bit for bit; only the owned row written). Then the same for
   MLA (``FAKE_MLA_DECODE``): one decode step of deepseek-v3-671b at full
   width cut to 4 layers (B = 8) as rank 0 of 16 under ``decode_32k``'s
   rules, over its 2,048 of 32,768 capacity rows of the latent cache
   and the RoPE key (each part's leaves [L, 8, 2048, 512] and [L, 8,
   2048, 64]; MLA on 8 of 128 heads, the queries gathered and the
   partial softmaxes merged in the latent space): FLOPs on meta equal to
   the card's, the meta peak within ``PEAK_TOL``, no kernel launched;
   ms, busy share and peak; and one MLA layer's split decode captured as
   a CUDA graph, equal to eager bit for bit. The seconds these cases
   added. Last (``seq_split_steps``), rank 1 of a fake group of
   ``SEQ_RANKS`` on a ``"cuda"`` (2, 1, 1) mesh (pod x data x model)
   under the multi-pod ``fsdp`` rules, which split each sequence over
   ``pod``: one train step (B = 8, S = 1024, the last segment's 512
   tokens of each sequence) of qwen2-1.5b, rwkv6-3b, zamba2-7b and
   qwen3-moe-30b-a3b depth-cut as in phase 8 (the MoE's routing groups
   span the segments, which are gathered), of qwen3-moe-30b-a3b again at
   B = 2, S = 4096 in one microbatch (each 2,048-token segment one
   routing group, routed where it lies), and of deepseek-v3-671b cut to
   its one leading dense layer (MLA gathering its latent and RoPE key),
   from rank 1's own blocks (half of
   every parameter and Adam leaf; the gathers over ``pod``, the K/V
   gather and the carried states hold unwritten memory, so no value is
   checked): the FLOPs of ``analyze`` on the card equal the same rank's
   count on meta, the meta peak is within ``PEAK_TOL`` of the card's,
   none of the six kernels is launched (the counts set to 0 just before
   and read just after each run); ms (warm) and the card's busy share
   printed beside the plain whole-sequence step's, and its FLOPs. Then
   (``fullep_steps``) rank 0 of a fake group of 8 on a ``"cuda"`` (2, 4)
   data x model mesh under ``train_4k``'s ``tp_ep_full`` rules, where
   each card owns whole experts: deepseek-v3-671b at full width cut to 5
   layers (3 dense, 2 MoE; 32 of the 256 experts a rank), two prefills
   (B = 4, S = 1024: each routing group within the rank's data shard,
   the tokens exchanged over ``data``; B = 2: a group spans both data
   shards, the tokens gathered) and one train step's loss and gradients
   (B = 4, S = 1024, one microbatch), each from rank 0's own blocks with
   no value checked: FLOPs on meta equal the card's, the meta peak
   within ``PEAK_TOL``, none of the six kernels launched, the counted
   all-to-all bytes equal to ``fullep_all_to_all``'s formula, and the
   counted all-gather bytes below ``FULLEP_BEFORE``'s by at least the
   expert stacks' bytes; ms (warm) and the card's busy share printed.
10. the dry run (``phase_dryrun``), the launch counts set to 0 just
   before and read just after (it launches none): the plain qwen2-1.5b
   step of phase 8's cell analysed on meta by ``launch.hlo_analysis.
   analyze`` (its FLOPs, HBM bytes and peak of live bytes), then run on
   the card under the same analysis, its inputs resident: the FLOP counts
   equal, the predicted peak within ``PEAK_TOL`` of
   ``max_memory_allocated`` above what the process held before, the
   modeled compute and memory times (H100 datasheet) beside a measured
   warm step; then ``python -m repro_torch.launch.dryrun`` as four
   subprocesses started together that see no card (``DRYRUN_CELLS``:
   qwen2-1.5b ``train_4k`` single, stablelm-12b ``prefill_32k`` single,
   deepseek-v3-671b ``decode_32k`` multi, zamba2-7b ``long_500k``
   single; a fake process group of 256 or 512 ranks each), each exiting
   0 with its JSON, its ``argument_bytes`` equal to the sum of its
   stand-ins' shard bytes (``stand_in_bytes``) and its FLOPs equal to
   the committed ``results/dryrun_torch`` JSON's; seconds, per-card peak
   (beside the committed one), FLOPs, collective bytes and the dominant
   term printed.

11. a capture that fails (a loop that copies to the host) must raise
   and leave no graph.
12. the paper's two experiments end to end (``phase_paper``), through
   ``launch.mnist_end_to_end``'s ``train_stage`` and ``deploy``: the
   MNIST SFNN trained ``PAPER_MNIST_STEPS`` BPTT steps on the card (B =
   64, rate-coded), then quantized to 4/5 bits, compiled onto
   ``MNIST_HW`` (``max_iters=40000``) and run on the whole synthetic test
   set (512 images) in one fused-tier call; the SHD SRNN the same way
   (``PAPER_SHD_STEPS`` steps at B = 32; 7/12 bits, ``SHD_HW``,
   ``max_iters=60000``; a 32-sample test batch, its int8 1020 x 320
   plane). Gates, per net: the launch counts set to 0 just before and
   read just after each part (training: phase 6's per-forward counts per
   step and one evaluation forward, ``lif_update_bwd`` ``bwd_per_step``
   per step, nothing else; deploy: one ``fused_run``, both planes fitting
   a cluster; ``precompile`` of the batch and one replay: 2); finite
   losses; the card's spikes,
   ``v_final`` and packet counts equal to the CPU oracle's over every
   sample, and the graphed run's to the eager one's; the mapped accuracy
   the quantized oracle's; ``Program.profile`` of 2 samples' card
   packet counts equal to the host simulator's. Each net's Table-3 row
   (modeled by the ``CycleModel`` for the paper's FPGA at 100 MHz, not
   card times) is printed beside the paper's values, with each stage's
   seconds (train, quantize, compile, the mapped run with its copies).
   Then ``launch.quickstart.main`` on the card, its asserts holding: 3
   ``fused_run`` (a run, precompile's warm run, a replay) and T
   ``lif_update_int``.

The last two lines are the kernels' JSON record (a kernel's
``launches`` summed over the counted runs of the paths that launch it:
phases 4 (the back end's and the compiler's programs), 5 and 12 for
``fused_run``, ``fused_step`` (the 10^5-synapse program, whose plane
does not fit a cluster) and ``lif_update_int``; 6 and 12 for ``spike_accum``
and ``lif_update``) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
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
LM_DENSE = ("stablelm-12b", 8)   # the dense family's largest; no kernel
# the MoE / MLA, VLM and audio families (no kernel): (arch, batch, depth
# cut or None); qwen3-moe-30b-a3b cut to 12 of its 48 layers for the
# run's time limit (9c prefills its full depth on one rank's blocks);
# deepseek-v3-671b's 61 layers (1.25 TiB) cannot be held on one card: 4
# layers, its 3 dense MLA layers and 1 MoE layer (256 experts and the
# shared expert), 15.11 B parameters
LM_FAMILIES = (("qwen3-moe-30b-a3b", 8, 12), ("deepseek-v3-671b", 4, 4),
               ("qwen2-vl-7b", 8, None), ("musicgen-medium", 8, None))
LM_PROMPT, LM_GEN = 1024, 32
PREFILL_WARM_S: dict = {}        # phase 7's warm prefill: arch -> (s, layers)
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


def time_fused_run(ext, w, p) -> dict:
    """``fused_run``'s times on ``ext`` ``[T, B, n_ext]`` beside its plain
    version's (``fused_run_ref``, T plain steps) and the card's bound;
    ``engine_*`` times the engine's unchecked launch
    (``fused_run_launcher``), ``steps_ms`` the same run as T unchecked
    ``fused_step`` launches (the ``"step"`` path, eager), ``zero_ms`` a
    run over all-zero spikes (every K-step skipped: what is left is the
    step chain's staging, Neuron Unit, spike pushes and barriers) and
    ``floor_ms`` T cluster barriers alone (``suprasnn_cluster_barriers``,
    one cluster of the plane's split): the serial floor no overlap can
    remove. No single PyTorch call computes a T-step run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_step import (fused_launcher, fused_run,
                                                fused_run_launcher,
                                                fused_run_plan,
                                                fused_run_ref, pack_plane)
    t_steps, b, n_ext = ext.shape
    n_int = w.shape[1]
    dev = ext.device
    packed = pack_plane(w)
    i32 = dict(dtype=torch.int32, device=dev)
    spikes = torch.empty((t_steps, b, n_int), **i32)
    v = torch.empty((b, n_int), **i32)
    pkt = torch.empty((t_steps, b), **i32)
    zero = torch.zeros_like(ext)
    stream = _build.stream_handle(dev)
    run = fused_run_launcher(packed, p, n_ext)
    step = fused_launcher(packed, p, n_ext)
    prev0 = torch.zeros((b, n_int), **i32)
    outs = (v.data_ptr(), spikes.data_ptr(), pkt.data_ptr(), b, t_steps,
            stream)
    e0, s0, k0 = ext.data_ptr(), spikes.data_ptr(), pkt.data_ptr()

    def call():
        fused_run(ext, packed, p, spikes_out=spikes, v_out=v, pkt_out=pkt)

    def steps():
        v.zero_()
        prev = prev0.data_ptr()
        for t in range(t_steps):
            out = s0 + t * b * n_int * 4
            step(e0 + t * b * n_ext * 4, prev, outs[0], out, k0 + t * b * 4,
                 b, stream)
            prev = out

    lib = _build.load_library()
    n_split = fused_run_plan(packed).n_split
    rec = {
        "ms": median_ms(call, iters=20),
        "host_us": host_us(call),
        "device_us": device_us(call, iters=20),
        "engine_ms": median_ms(lambda: run(e0, *outs), iters=20),
        "engine_host_us": host_us(lambda: run(e0, *outs)),
        "zero_ms": median_ms(lambda: run(zero.data_ptr(), *outs), iters=20),
        "steps_ms": median_ms(steps, iters=5),
        "floor_ms": median_ms(lambda: _build.check(
            lib.suprasnn_cluster_barriers(n_split, t_steps, stream),
            "cluster barriers"), iters=20),
        "plain_ms": median_ms(lambda: fused_run_ref(ext, w, p), iters=2,
                              repeats=3),
        "library_ms": None,
    }
    # bytes: the plane read once, ext read once, spikes, packets and
    # v_final written once; operations: a multiply and an add for each
    # (non-zero pre spike, post neuron) pair of every step and batch row
    call()
    nnz = int((ext != 0).sum().item()) + int(spikes[:-1].sum().item())
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        w.numel() * w.element_size() + ext.numel() * 4 + spikes.numel() * 4
        + pkt.numel() * 4 + v.numel() * 4, 2 * nnz * n_int)
    return rec


def print_run_times(what: str, rec: dict, t_steps: int) -> None:
    print_times(what, rec)
    us = {k: rec[k] / t_steps * 1e3 for k in ("ms", "engine_ms", "steps_ms",
                                               "zero_ms", "floor_ms",
                                               "bound_ms")}
    print(f"  {what} per step (T={t_steps}): kernel {us['ms']:.3f} us "
          f"(device {rec['device_us'] / t_steps:.3f} us), unchecked launch "
          f"{us['engine_ms']:.3f} us; T fused_step launches "
          f"{us['steps_ms']:.3f} us; all-zero spikes {us['zero_ms']:.3f} us; "
          f"serial floor (one cluster barrier) {us['floor_ms']:.3f} us; "
          f"bound {us['bound_ms']:.4f} us")


def check_fused_run(dev, t, rng, planes: dict) -> int:
    """``fused_run`` against ``fused_run_ref`` and T ``fused_step``
    launches on the same plane, bit for bit, twice, for each plane that
    fits (``fused_path`` "run"); one that does not must be refused.
    Returns the largest |error| seen (0)."""
    from repro_torch.kernels.fused_step import (fused_path, fused_run,
                                                fused_run_ref, fused_step,
                                                pack_plane, run_smem_bytes)
    from repro_torch.snn.lif import LIFIntParams
    err = 0
    for name, (n_ext, n_int, wdt, wmax) in planes.items():
        w = t(rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)), wdt)
        packed = pack_plane(w)
        smem = run_smem_bytes(w.element_size(), n_ext, n_int)
        if fused_path(packed, n_ext) != "run":
            try:
                fused_run(t(np.ones((2, 3, n_ext))), packed,
                          LIFIntParams(2, 15, 0))
                refused = False
            except ValueError:
                refused = True
            expect(refused, f"fused_run {name}: a plane that does not fit "
                            f"was not refused")
            print(f"fused_run {name}: {smem} bytes a CTA, more than a "
                  f"cluster holds: the shape rule says step, and fused_run "
                  f"refuses the plane")
            continue
        for i, b in enumerate(FUSED_BATCHES):
            t_steps = TIMESTEPS if b == SERVE_BATCH else ODD_T
            p = LIFIntParams(leak_shift=(1, 2, 4)[i % 3],
                             v_threshold=(15, 40, 0, 7, -3, 20)[i],
                             v_reset=(0, -5, 0, 1, 2, -1)[i])
            ext = t(rng.random((t_steps, b, n_ext)) < 0.15)
            odd = torch.from_numpy(rng.choice(ODD_SPIKES, ext.shape)).to(
                dev, torch.int32)
            ext_odd = torch.where(t(rng.random(ext.shape) < 0.05) != 0, odd,
                                  ext)
            for kind, e_in in (("0/1", ext), ("non-binary", ext_odd)):
                want = fused_run_ref(e_in, w, p)
                v_k = torch.zeros((b, n_int), dtype=torch.int32, device=dev)
                prev, s_t, pk_t = torch.zeros_like(v_k), [], []
                for step in range(t_steps):
                    _, prev, pkt = fused_step(e_in[step], prev, v_k, packed, p)
                    s_t.append(prev)
                    pk_t.append(pkt)
                stepped = (torch.stack(s_t), v_k, torch.stack(pk_t))
                runs = [fused_run(e_in, packed, p) for _ in range(2)]
                torch.cuda.synchronize()
                for label, got in (("run", runs[0]), ("run again", runs[1]),
                                   (f"{t_steps} fused_step", stepped)):
                    for what, a, r in zip(("spikes", "v_final", "packets"),
                                          got, want):
                        e = max_err(a, r)
                        err = max(err, e)
                        expect(torch.equal(a, r), f"fused_run {name} B={b} "
                               f"T={t_steps} {kind} spikes: {label} {what} "
                               f"differs from fused_run_ref (max |err| {e})")
        print(f"fused_run {name} ({smem} bytes a CTA): bit-exact with "
              f"fused_run_ref and T fused_step launches at B in "
              f"{FUSED_BATCHES} (T = {TIMESTEPS} at B = {SERVE_BATCH}, else "
              f"{ODD_T}), 0/1 and non-binary external spikes, twice each")
    return err


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
    from repro_torch.kernels.fused_step import (fused_run,
                                                fused_run_emulated,
                                                fused_step, fused_step_ref,
                                                pack_dense, pack_plane)
    from repro_torch.kernels.lif_update import (lif_int_launcher,
                                                lif_update_int,
                                                lif_update_int_ref)
    from repro_torch.snn.lif import LIFIntParams

    rng = np.random.default_rng(0)
    fused_step.launches = lif_update_int.launches = fused_run.launches = 0

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
    err["fused_run"] = check_fused_run(dev, t, rng, planes)
    print(f"comparison launches (not counted below): fused_step "
          f"{fused_step.launches}, lif_update_int {lif_update_int.launches}, "
          f"fused_run {fused_run.launches}")

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
    # fused_run on the artifact's recorded spike trains, B = 8, T = 100:
    # the kernel against its plain version and the CPU emulation of its
    # decomposition, then its record
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        trains = np.concatenate([io["ext"]] * (b // len(io["ext"])))
    ext_run = t(trains.transpose(1, 0, 2))
    want = fused_run_emulated(ext_run.cpu(), pack_plane(w.cpu()), p)
    got = fused_run(ext_run, pack_plane(w), p)
    torch.cuda.synchronize()
    for what, a, r in zip(("spikes", "v_final", "packets"), got, want):
        e = max_err(a.cpu(), r)
        err["fused_run"] = max(err["fused_run"], e)
        expect(torch.equal(a.cpu(), r), f"fused_run on the SHD artifact: "
               f"{what} differs from fused_run_emulated (max |err| {e})")
    print(f"fused_run B={b} T={len(ext_run)} on the SHD-scale artifact's "
          f"recorded spike trains: bit-exact with fused_run_emulated on the "
          f"CPU")
    rec = time_fused_run(ext_run, w, p)
    print_run_times(f"fused_run B={b} on the SHD-scale artifact", rec,
                    len(ext_run))
    rec["max_abs_err"] = err["fused_run"]
    recs["fused_run"] = rec
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
    from repro_torch.kernels.fused_step import fused_run, fused_step
    from repro_torch.kernels.lif_update import (lif_update, lif_update_bwd,
                                                lif_update_int)
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return {"fused_run": fused_run, "fused_step": fused_step,
            "lif_update_int": lif_update_int,
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
        tok, state = serve(params, tok[:, None], state)
        toks.append(tok)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def layerwise(cfg, run) -> tuple[dict, object, torch.Tensor]:
    """``run()``, a kernel prefill, in which every recurrent layer also
    runs through the chunked path on the same input (the kernel side
    carries on). Returns, per leaf (the layer's output and each state
    leaf), the largest |err| over the layers and whether every layer was
    within LM_TOL; what ``run`` returned; and the last layer's chunked
    output."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv as RW

    mod, attr = (RW, "rwkv_block") if cfg.family == "ssm" \
        else (M2, "mamba2_block")
    block = getattr(mod, attr)
    worst, last = {}, {}

    def both(p, x, cfg, state, single_step=False, kernels=True, **split):
        out, st = block(p, x, cfg, state, single_step, kernels=True, **split)
        out_c, st_c = block(p, x, cfg, state, single_step, kernels=False,
                            **split)
        for k, a, b in [("out", out, out_c)] + [(k, st[k], st_c[k])
                                               for k in st]:
            e, ok = worst.get(k, (0.0, True))
            worst[k] = (max(e, max_err_f(a, b)),
                        ok and torch.allclose(a.float(), b.float(), **LM_TOL))
        last["x"] = out_c
        return out, st

    setattr(mod, attr, both)
    try:
        result = run()
    finally:
        setattr(mod, attr, block)
    return worst, result, last["x"]


def layerwise_prefill(params, cfg, batch_in) -> tuple[dict, torch.Tensor,
                                                     torch.Tensor]:
    """:func:`layerwise` of the plain kernel prefill. Returns the worst
    per leaf, the prefill's last-position logits, and those of the last
    layer's chunked output."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step

    worst, (logits, _), x_last = layerwise(
        cfg, lambda: make_prefill_step(cfg)(params, batch_in))
    x = L.apply_norm(params["final_norm"], x_last[:, -1:], cfg.norm_eps)
    return worst, logits, M.unembed_hidden(params, cfg, x)


# a recurrence kernel's own outputs, y and the final state, against its
# chunked form on the same inputs: max |err| at most this share of the
# chunked output's largest magnitude (a limit that scales with what is
# compared, so that a kernel that writes zeros fails at any input scale)
KERNEL_REL = 5e-2


@contextlib.contextmanager
def against_chunked(cfg):
    """Every call of the recurrence's kernel (``wkv6`` or ``ssd``) in the
    block's module also runs its chunked form on the same inputs. Yields
    {"y" / "state": (the largest max |err| / max |chunked| over the
    calls, the calls, the smallest max |chunked|)}, filled as the run
    goes; a chunked output of all zeros, or a NaN, gives an infinite
    share."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv as RW

    mod, name, plain = ((RW, "wkv6", RW.wkv6_chunked)
                        if cfg.family == "ssm"
                        else (M2, "ssd", M2.ssd_chunked))
    kernel, seen = getattr(mod, name), {}

    def both(*args):
        got = kernel(*args)
        for k, g, w in zip(("y", "state"), got, plain(*args)):
            scale = float(w.abs().max())
            share = max_err_f(g, w) / scale if scale > 0 else math.inf
            share = math.inf if math.isnan(share) else share
            worst, n, lo = seen.get(k, (0.0, 0, math.inf))
            seen[k] = (max(worst, share), n + 1, min(lo, scale))
        return got

    setattr(mod, name, both)
    try:
        yield seen
    finally:
        setattr(mod, name, kernel)


def device_breakdown(fn, host_s: float, by_op: bool = True) -> str:
    """The card's time under ``torch.profiler`` for one call of ``fn``,
    by kernel (top 5), by the torch op and input shapes that launched
    it (top 5, the op's own kernels; not with ``by_op`` False, which
    traces the card alone, for a run of tens of thousands of ops), and
    its busy share of ``host_s``, the unprofiled call's host-clock
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if by_op else []),
                 record_shapes=by_op) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, ops = {}, {}
    for e in prof.key_averages(group_by_input_shape=by_op):
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
        elif e.key.startswith("aten::") and us:
            op = f"{e.key} {e.input_shapes}".replace(" ", "")
            ops[op] = ops.get(op, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    if not busy_ms:
        return "card time not measured (no device events)"

    def top(d, width=70):
        return "; ".join(f"{us / 1e3:.3f} ms {name[:width]}" for name, us in
                         sorted(d.items(), key=lambda kv: -kv[1])[:5])
    return (f"card busy {busy_ms:.2f} ms, {busy_ms / (host_s * 1e3):.3f} of "
            f"the unprofiled {host_s * 1e3:.2f} ms; top: {top(by_name)}"
            + (f"; by op: {top(ops, 100)}" if by_op else ""))


def make_lm(name: str, batch: int, dev: torch.device,
            n_layers: int | None = None) -> tuple:
    """The full-width model ``name`` (its depth cut to ``n_layers`` if
    given) made on the card from seed 0 (the peak memory count reset
    first) and ``batch`` seeded LM_PROMPT-token prompts ([B, P, K] over K
    codebooks; M-RoPE's three streams arange(P), as the serving CLI
    gives them): (cfg, params, batch_in, init s, parameters, the peak
    memory of the init)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(t.numel() for _, t in leaves(params))
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, LM_PROMPT, *k))).to(dev)
    batch_in = {"tokens": prompts}
    if cfg.mrope_sections:
        batch_in["positions"] = torch.arange(LM_PROMPT, device=dev).expand(
            3, batch, LM_PROMPT)
    return cfg, params, batch_in, t_init, n_params, init_peak


def lm_breakdowns(name: str, cfg, params, batch_in: dict, logits, st,
                  t_prefill_warm: float, dev: torch.device) -> None:
    """The card's time by kernel of a warm prefill and of one eager
    decode step from the grown prefill state ``st``, then the graphed
    decode (``graphed_decode``)."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    batch = batch_in["tokens"].shape[0]
    print(f"  {name} warm prefill: " + device_breakdown(
        lambda: prefill(params, batch_in), t_prefill_warm))
    state = _grow_cache(cfg, st, batch, LM_PROMPT + LM_GEN, dev)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    serve(params, tok, state)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(params, tok, state)
    torch.cuda.synchronize()
    print(f"  {name} one decode step: " + device_breakdown(
        lambda: serve(params, tok, state), time.perf_counter() - t0))
    del state
    graphed_decode(name, cfg, params, logits, st, batch, dev)


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
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg, params, batch_in, t_init, n_params, _ = make_lm(name, batch, dev)
    kernel = "wkv6" if cfg.family == "ssm" else "ssd"
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
    lm_breakdowns(name, cfg, params, batch_in, logits, st_kernel,
                  t_prefill_warm, dev)
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
    from repro_torch.distributed.sharding import tree_map
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
        tok, g_state = step(params, tok[:, None], g_state)
        toks_g.append(tok.clone())
    logits_g = step.last_logits.clone()
    e_state, tok, toks_e = tree_map(torch.clone, grown), tok0, []
    for _ in range(LM_GEN):
        logits_e, e_state = M.decode_step(params, cfg, tok[:, None],
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
            params, tok[:, None], g_state)),
            ("another params tree", lambda: step(
                dict(params), tok0[:, None], grown))):
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
        t, st = serve(params, tok0[:, None], st)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(LM_GEN - 1):
            t, st = serve(params, t[:, None], st)
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
    tok, st = step(params, tok0[:, None], st)
    print(f"  {name} one graphed decode step: " + device_breakdown(
        lambda: step(params, tok[:, None], st), g_ms / 1e3))
    del step


def moe_plans(fn) -> tuple:
    """``fn()`` with every MoE layer's routing recorded (a wrapper around
    ``models.moe._plan``): its result and, per layer, (top-k indices,
    keep mask, capacity)."""
    from repro_torch.models import moe as MOE
    plans, plan = [], MOE._plan

    def record(*args, **kwargs):
        out = plan(*args, **kwargs)
        plans.append((out[1], out[3], out[4]))
        return out
    MOE._plan = record
    try:
        return fn(), plans
    finally:
        MOE._plan = plan


def serve_transformer(name: str, batch: int, dev: torch.device,
                      n_layers: int | None = None) -> None:
    """Serve one full-width transformer (depth cut to ``n_layers`` if
    given) as ``serve_lm`` serves the recurrent ones: prefill LM_PROMPT
    tokens of ``batch`` seeded prompts, grow the cache, decode LM_GEN
    tokens greedily, the counts set to 0 just before and read just after:
    its path reaches no kernel wrapper, so every count must stay 0. Then
    one decode step over per-layer cache lists (``unroll=True``, every
    part: K/V or MLA's latent and RoPE key) against the stacked step, bit
    for bit; the prefill's last logits against a prefill of LM_PROMPT - 1
    tokens and one decode step (reported, not gated: a randomly
    initialised model amplifies rounding, and at full width the MoE
    capacity drops routes, differently for another token count); times,
    memory and the card's time by kernel; and the graphed decode."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg, params, batch_in, t_init, n_params, init_peak = make_lm(
        name, batch, dev, n_layers)
    prompts = batch_in["tokens"]
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    capacity = LM_PROMPT + LM_GEN

    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    logits, st = prefill(params, batch_in)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    state = _grow_cache(cfg, st, batch, capacity, dev)
    toks, t_decode = decode(serve, params, logits, state, batch)
    counts = {k: f.launches for k, f in fns.items()}
    expect(not any(counts.values()), f"{name}: prefill and decode launched "
           f"{counts}; the transformer path has no kernel")
    expect(all(bool(t.isfinite().all()) for t in (logits, *toks))
           and all(((t >= 0) & (t < cfg.vocab_size)).all() for t in toks),
           f"{name}: non-finite logits or tokens out of range")
    del state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, batch_in)                 # warm: not counted, timed
    torch.cuda.synchronize()
    t_prefill_warm = time.perf_counter() - t0
    PREFILL_WARM_S[name] = (t_prefill_warm, cfg.n_layers)

    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    stacked = _grow_cache(cfg, st, batch, capacity, dev)
    parts = [p for p in ("dense", "main") if p in stacked]
    unrolled = {"len": stacked["len"].clone(), **{
        p: {k: [t.clone() for t in v] for k, v in stacked[p].items()}
        for p in parts}}
    lg_s, st_s = M.decode_step(params, cfg, tok, stacked)
    lg_u, st_u = M.decode_step(params, cfg, tok, unrolled, unroll=True)
    expect(torch.equal(lg_u, lg_s) and all(
        torch.equal(a, st_s[p][k][i]) for p in parts for k in st_s[p]
        for i, a in enumerate(st_u[p][k])),
        f"{name}: the unrolled decode step differs from the stacked step")
    del stacked, unrolled, st_s, st_u

    short = {k: v[..., :-1] for k, v in batch_in.items()}
    short["tokens"] = prompts[:, :-1]
    (_, st_short), plans = moe_plans(lambda: prefill(params, short))
    st_short = _grow_cache(cfg, st_short, batch, LM_PROMPT, dev)
    stepped, _ = M.decode_step(params, cfg, prompts[:, -1:], st_short)
    del st_short
    agree = float((stepped.argmax(-1) == logits.argmax(-1)).float().mean())
    mem = torch.cuda.max_memory_allocated(dev)
    drops = ""
    if plans:
        kept = float(torch.stack([keep.float().mean()
                                  for _, keep, _ in plans]).mean())
        drops = (f"; MoE capacity {plans[0][2]} a (group, expert) in that "
                 f"prefill, {1 - kept:.4f} of its routes dropped")
    print(f"{name}: one unrolled decode step (per-layer {'/'.join(parts)} "
          f"cache lists) equal to the stacked step bit for bit (logits, "
          f"every layer's cache); prefill of {LM_PROMPT - 1} tokens + one "
          f"decode step vs the prefill's last logits (not gated): max |err| "
          f"{max_err_f(stepped, logits):.3g} (logits up to "
          f"{float(logits.abs().max()):.3g}), greedy token agreeing "
          f"{agree:.3f}{drops}")
    cut = (f"cut to {cfg.n_layers} layers" if n_layers is not None
           else f"{cfg.n_layers} layers")
    print(f"serve {name} (full width, {n_params / 1e9:.3f} B params, "
          f"{cut}) B={batch} prompt {LM_PROMPT} gen {LM_GEN}: init "
          f"{t_init:.2f} s on the card, its peak {init_peak / 2**30:.2f} GiB;"
          f" prefill {t_prefill * 1e3:.1f} ms (first), "
          f"{t_prefill_warm * 1e3:.1f} ms (warm); decode "
          f"{t_decode / LM_GEN * 1e3:.2f} ms per token step "
          f"({LM_GEN * batch / t_decode:.1f} tokens/s); launches: 0 in "
          f"prefill and decode (no kernel on this path); max memory "
          f"allocated {mem / 2**30:.2f} GiB")
    print(f"  first sequence: {torch.stack(toks)[:16, 0].tolist()}")
    lm_breakdowns(name, cfg, params, batch_in, logits, st, t_prefill_warm,
                  dev)


def phase_lm(dev: torch.device) -> dict[str, int]:
    """Serve rwkv6-3b, then zamba2-7b, then the dense stablelm-12b, then
    the MoE, MLA, VLM and audio models of ``LM_FAMILIES`` (each freed
    before the next is made); return each kernel's launches in its
    model's counted run (the transformers launch none)."""
    launches = {}
    for name, batch in LM_RUNS:
        t0 = time.perf_counter()
        n = serve_lm(name, batch, dev)
        launches["wkv6" if name.startswith("rwkv") else "ssd"] = n
        torch.cuda.empty_cache()
        took(f"phase 7's {name}", t0)
    t0 = time.perf_counter()
    serve_transformer(*LM_DENSE, dev)
    torch.cuda.empty_cache()
    took(f"phase 7's {LM_DENSE[0]}", t0)
    for name, batch, n_layers in LM_FAMILIES:
        t0 = time.perf_counter()
        serve_transformer(name, batch, dev, n_layers)
        torch.cuda.empty_cache()
        took(f"phase 7's {name}", t0)
    return launches


# LM training (phase 8): qwen2-1.5b at full width through the training
# CLI's calls; the depth-cut checks run at CUT_B x CUT_S tokens (the
# card machine's CPU takes the same step in (b))
TRAIN_LM, TRAIN_B, TRAIN_S, TRAIN_LM_STEPS = "qwen2-1.5b", 8, 1024, 5
CUT_B, CUT_S = 2, 256
CUT_LAYERS = {"qwen2-1.5b": 2, "rwkv6-3b": 2, "zamba2-7b": None,  # None: one
              "qwen3-moe-30b-a3b": 2,          # attn_layer_period of layers
              "deepseek-v3-671b": 2,           # 1 dense + 1 MoE layer
              "qwen2-vl-7b": 2, "musicgen-medium": 2}
# deepseek-v3's cut step holds 13.9 B bf16 parameters and their
# gradients (56 GB): Adam's float32 moments (111 GB) do not fit beside
# them, so that step stops at the gradients
NO_ADAM = ("deepseek-v3-671b",)
# the 2-layer full-width MoE prefill on the card against the card
# machine's CPU, float32-cast weights: the share of (layer, token) top-k
# route sets that may differ (rounding flips a near-tie route); the
# logits are held to LM_TOL on the tokens whose routes and drops agree in
# every layer. Measured in bf16 on an H100: 2.1 % and 9.8 % of the two
# layers' route sets differ (random weights nearly collapse the router),
# so the bf16 run is reported, not gated
MOE_VS_CPU, ROUTE_FLIP_FRAC = "qwen3-moe-30b-a3b", 0.01
# the card's bf16 step against the CPU's: the bounds tests/
# test_torch_lm_train.py holds the port's bf16 gradients to the
# reference's (the loss, relative; each leaf's gradient, relative norm)
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 5e-3, 0.1


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().cpu(), want.double().cpu()
    return float((g - w).norm() / max(float(w.norm()), 1e-30))


def step_timed(step, params, opt, batch) -> tuple:
    """One train step; the host clock ends in a sync (the loss read)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    return params, opt, loss, time.perf_counter() - t0


def depth_cut(name: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    n = CUT_LAYERS[name] or cfg.attn_layer_period
    if cfg.moe is not None and cfg.moe.n_dense_layers:   # one of each stack
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_dense_layers=1))
    return dataclasses.replace(cfg, n_layers=n)


def train_full_width(dev: torch.device) -> None:
    """(a) TRAIN_LM_STEPS steps of qwen2-1.5b at full width, B = TRAIN_B,
    S = TRAIN_S, making the training CLI's calls; then one step through
    the CLI itself with ``--micro 2`` and one with int8 Adam moments."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)

    cfg = get_config(TRAIN_LM)
    hp = TrainHParams(lr=3e-4, loss_chunk=min(512, TRAIN_S))
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    start = tree_map(torch.clone, params)
    opt = init_opt_state(params, hp)
    step = make_train_step(cfg, None, hp)
    losses, secs = [], []
    for i in range(TRAIN_LM_STEPS):
        batch = synthetic_batch(cfg, TRAIN_B, TRAIN_S, i, 0, dev)
        params, opt, loss, dt = step_timed(step, params, opt, batch)
        losses.append(loss)
        secs.append(dt)
    peak = torch.cuda.max_memory_allocated(dev)
    expect(all(np.isfinite(losses)), f"{TRAIN_LM} losses {losses}")
    before = dict(leaves(start))
    same = [k for k, a in leaves(params) if torch.equal(a, before[k])]
    expect(not same, f"{TRAIN_LM}: leaves not updated: {same}")
    n_params = sum(t.numel() for _, t in leaves(params))
    warm = statistics.median(secs[1:])
    tokens = TRAIN_B * TRAIN_S
    print(f"train {TRAIN_LM} (full width: {n_params / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}; cut: none, B = "
          f"{TRAIN_B}, S = {TRAIN_S}; remat, loss chunk {hp.loss_chunk}, "
          f"Adam float32 moments): losses {[round(x, 4) for x in losses]}; "
          f"every one of the {len(leaves(start))} parameter leaves "
          f"updated; ms per step (host clock "
          f"ending in a sync): first {secs[0] * 1e3:.1f}, then "
          + ", ".join(f"{t * 1e3:.1f}" for t in secs[1:])
          + f"; warm median {warm * 1e3:.1f} ms, {tokens / warm:.0f} "
          f"tokens/s; max memory allocated {peak / 2**30:.2f} GiB")
    batch = synthetic_batch(cfg, TRAIN_B, TRAIN_S, TRAIN_LM_STEPS, 0, dev)
    print(f"  {TRAIN_LM} one warm train step: " + device_breakdown(
        lambda: step(params, opt, batch), warm))
    del start, before, batch

    del params, opt
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    micro = train_main(["--arch", TRAIN_LM, "--steps", "1", "--batch",
                        str(TRAIN_B), "--seq", str(TRAIN_S), "--micro", "2"])
    peak_micro = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    hp_q = TrainHParams(lr=3e-4, loss_chunk=hp.loss_chunk,
                        quantized_opt_state=True)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = init_opt_state(params, hp_q)
    _, _, loss_q, t_q = step_timed(
        make_train_step(cfg, None, hp_q), params, opt,
        synthetic_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, dev))
    peak_q = torch.cuda.max_memory_allocated(dev)
    del params, opt
    torch.cuda.empty_cache()
    gaps = [abs(x - losses[0]) / abs(losses[0]) for x in (micro[0], loss_q)]
    expect(all(g <= BF16_LOSS_RTOL for g in gaps),
           f"{TRAIN_LM}: the first loss with --micro 2 / int8 moments "
           f"{micro[0]} / {loss_q} against {losses[0]}")
    print(f"  {TRAIN_LM} first step through the CLI with --micro 2 (2 x "
          f"{TRAIN_B // 2} sequences): loss {micro[0]:.6f}, max memory "
          f"allocated {peak_micro / 2**30:.2f} GiB; with int8 Adam moments: "
          f"loss {loss_q:.6f}, {t_q * 1e3:.1f} ms (first step), max memory "
          f"allocated {peak_q / 2**30:.2f} GiB; relative gaps to the first "
          f"loss above {gaps[0]:.2e} / {gaps[1]:.2e} (limit "
          f"{BF16_LOSS_RTOL})")


def checkpoint_cut(dev: torch.device) -> None:
    """(d) A checkpoint save and restore of the (params, opt_state) of
    qwen2-1.5b at full width cut to CUT_LAYERS layers after
    TRAIN_LM_STEPS steps (B = CUT_B, S = CUT_S): every leaf restored bit
    for bit onto the card (SHA-256 verified), the step kept; seconds and
    GB/s each way."""
    import tempfile
    from repro_torch.distributed import CheckpointManager
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)

    cfg = depth_cut(TRAIN_LM)
    hp = TrainHParams(lr=3e-4, loss_chunk=min(512, CUT_S))
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = init_opt_state(params, hp)
    step = make_train_step(cfg, None, hp)
    for i in range(TRAIN_LM_STEPS):
        params, opt, _, _ = step_timed(
            step, params, opt, synthetic_batch(cfg, CUT_B, CUT_S, i, 0, dev))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        t0 = time.perf_counter()
        mgr.save(TRAIN_LM_STEPS - 1, (params, opt))
        t_snap = time.perf_counter() - t0
        mgr.wait()
        t_save = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file())
        t0 = time.perf_counter()
        (p2, o2), _ = mgr.restore((params, opt))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        got = dict(leaves({"p": p2, "m": o2.m, "v": o2.v}))
        want = leaves({"p": params, "m": opt.m, "v": opt.v})
        diff = [k for k, b in want if got[k].dtype != b.dtype
                or got[k].device != b.device or not torch.equal(got[k], b)]
        name = f"{TRAIN_LM} (full width, cut to {cfg.n_layers} layers)"
        expect(not diff and o2.step == opt.step == TRAIN_LM_STEPS,
               f"{name} checkpoint: restored leaves differ: {diff[:5]}")
        print(f"  {name} checkpoint of (params, opt_state) after "
              f"{TRAIN_LM_STEPS} steps: {n_bytes / 1e9:.3f} GB on disk "
              f"({len(want)} tensors + the step); save {t_save:.2f} s (host "
              f"copy {t_snap:.2f} s, then the write on a thread), "
              f"{n_bytes / 1e9 / t_save:.3f} GB/s; restore onto the card "
              f"{t_load:.2f} s (SHA-256 verified), "
              f"{n_bytes / 1e9 / t_load:.3f} GB/s; every leaf bit for bit")
        del p2, o2, got, want
    del params, opt
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev: torch.device) -> None:
    """(b) The first step of qwen2-1.5b at full width, depth cut, on the
    card and on the CPU from the same parameters and batch."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.train.steps import TrainHParams, loss_and_grads

    cfg = depth_cut(TRAIN_LM)
    hp = TrainHParams(loss_chunk=min(512, CUT_S))
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = synthetic_batch(cfg, CUT_B, CUT_S, 0, 0, dev)
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(params, cfg, batch, hp)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    loss_c, _, grads_c = loss_and_grads(
        tree_map(lambda t: t.to(cpu), params), cfg,
        {k: v.to(cpu) for k, v in batch.items()}, hp)
    t_cpu = time.perf_counter() - t0
    gap = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    on_cpu = dict(leaves(grads_c))
    worst = max((rel_norm(a, on_cpu[k]), k) for k, a in leaves(grads))
    print(f"train {TRAIN_LM} card vs CPU (full width; cut: {cfg.n_layers} "
          f"layers, B = {CUT_B}, S = {CUT_S}; bf16 parameters): loss "
          f"{float(loss):.6f} / {float(loss_c):.6f}, relative gap {gap:.2e} "
          f"(limit {BF16_LOSS_RTOL}); largest per-leaf gradient relative "
          f"norm {worst[0]:.2e} at {worst[1]} (limit {BF16_GRAD_RTOL}); "
          f"forward + backward {t_card * 1e3:.1f} ms on the card (first), "
          f"{t_cpu:.2f} s on the CPU")
    expect(gap <= BF16_LOSS_RTOL and worst[0] <= BF16_GRAD_RTOL,
           f"{TRAIN_LM}: the card's step differs from the CPU's")


def train_cut(name: str, dev: torch.device) -> None:
    """(c) One train step of a model at full width, depth cut: every
    leaf's gradient finite and non-zero (the recurrences' time-mix / SSM
    leaves through their chunked forms under autograd; the MoE router,
    the experts and the shared expert through the gathers' backward),
    then Adam (but for ``NO_ADAM``)."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.optimizer.adam import AdamConfig, adam_update
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         loss_and_grads)

    cfg = depth_cut(name)
    hp = TrainHParams(loss_chunk=min(512, CUT_S))
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = synthetic_batch(cfg, CUT_B, CUT_S, 0, 0, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, metrics, grads = loss_and_grads(params, cfg, batch, hp)
    moved = "Adam not run (its moments do not fit beside the gradients)"
    if name not in NO_ADAM:
        new, _ = adam_update(grads, init_opt_state(params, hp), params,
                             AdamConfig(lr=hp.lr))
        start = dict(leaves(params))
        moved = (f"{sum(not torch.equal(a, start[k]) for k, a in leaves(new))}"
                 f" leaves updated")
        del new, start
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [k for k, g in leaves(grads)
           if not bool(g.isfinite().all()) or not bool(g.ne(0).any())]
    n_params = sum(t.numel() for _, t in leaves(params))
    print(f"train {name} (full width; cut: {cfg.n_layers} layers, B = "
          f"{CUT_B}, S = {CUT_S}; {n_params / 1e9:.3f} B params): loss "
          f"{float(loss):.6f} (aux {float(metrics['aux']):.3g}); "
          f"{len(leaves(grads)) - len(bad)} of {len(leaves(grads))} "
          f"gradients finite and non-zero; {moved}; one step "
          f"{dt * 1e3:.1f} ms (first); max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    expect(np.isfinite(float(loss)) and not bad,
           f"{name}: zero or non-finite gradients: {bad}")


def moe_card_vs_cpu(dev: torch.device) -> None:
    """(e) A 2-layer full-width MoE prefill (``MOE_VS_CPU``, B = CUT_B,
    S = CUT_S) on the card and on the card machine's CPU from the same
    parameters, in their bf16 and cast to float32. Gated in float32: at
    most ``ROUTE_FLIP_FRAC`` of the (layer, token) top-k route sets
    differ, and every position's logits are within ``LM_TOL`` on the
    tokens whose routes and drops agree in every layer (a flipped route
    moves its token's output by O(1), and a drop follows from every
    earlier route of the group). The bf16 run's shares are reported:
    with random weights every token's hidden state is nearly the same
    (tiny embeddings under a position-averaged attention output), the
    router nearly collapses and near-ties abound, so bf16 rounding
    flips routes."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.distributed.sharding import tree_map

    cfg = depth_cut(MOE_VS_CPU)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = synthetic_batch(cfg, CUT_B, CUT_S, 0, 0, dev)["tokens"]
    cpu = torch.device("cpu")

    def run(p, toks):
        with torch.no_grad():
            out = M.forward(p, cfg, toks, mode="prefill")
            return M.unembed_hidden(p, cfg, out.hidden)

    def compare(p_card, what: str) -> bool:
        t0 = time.perf_counter()
        got, card = moe_plans(lambda: run(p_card, tokens))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, host = moe_plans(lambda: run(
            tree_map(lambda t: t.to(cpu), p_card), tokens.to(cpu)))
        t_cpu = time.perf_counter() - t0
        flips, agree = [], torch.ones(CUT_B * CUT_S, dtype=torch.bool)
        for (i_g, k_g, _), (i_c, k_c, _) in zip(card, host):
            same = (i_g.cpu().sort(-1).values == i_c.sort(-1).values).all(-1)
            flips.append(float((~same).float().mean()))
            agree &= (same.reshape(-1)
                      & (k_g.cpu() == k_c).all(-1).reshape(-1))
        rows = agree.reshape(CUT_B, CUT_S)
        g, w = got.cpu()[rows], want[rows]
        dropped = 1 - float(torch.stack([k.float().mean()
                                         for _, k, _ in card]).mean())
        ok = (sum(flips) / len(flips) <= ROUTE_FLIP_FRAC
              and torch.allclose(g, w, **LM_TOL))
        print(f"{MOE_VS_CPU} MoE prefill card vs CPU, {what} (full width; "
              f"cut: {cfg.n_layers} layers, B = {CUT_B}, S = {CUT_S}; "
              f"capacity {card[0][2]}, {dropped:.4f} of the card's routes "
              f"dropped): top-k route sets differing by layer "
              f"{[round(f, 5) for f in flips]} (limit {ROUTE_FLIP_FRAC}); "
              f"{int(rows.sum())} of {rows.numel()} tokens agree in every "
              f"layer, their logits max |err| {max_err_f(g, w):.3g} (limit "
              f"rtol = atol = {LM_TOL['rtol']}); all tokens "
              f"{max_err_f(got.cpu(), want):.3g}; {t_card * 1e3:.1f} ms on "
              f"the card (first), {t_cpu:.2f} s on the CPU")
        return ok

    compare(params, "bf16 (reported, not gated)")
    params = tree_map(lambda t: t.float(), params)
    expect(compare(params, "float32-cast weights (gated)"),
           f"{MOE_VS_CPU}: the card's MoE prefill differs from the CPU's")


def check_kernels_refuse_grad(dev: torch.device) -> None:
    """The wkv6 / ssd wrappers raise on an input that requires grad."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6

    z = dict(device=dev)
    w_args = (torch.zeros(1, 8, 1, 64, **z, requires_grad=True),
              *[torch.zeros(1, 8, 1, 64, **z) for _ in range(2)],
              -torch.ones(1, 8, 1, 64, **z), torch.zeros(1, 64, **z),
              torch.zeros(1, 1, 64, 64, **z))
    s_args = (torch.zeros(1, 8, 1, 64, **z, requires_grad=True),
              torch.ones(1, 8, 1, **z), torch.zeros(1, **z),
              torch.zeros(1, 8, 64, **z), torch.zeros(1, 8, 64, **z),
              torch.zeros(1, 1, 64, 64, **z))
    for fn, args in ((wkv6, w_args), (ssd, s_args)):
        try:
            fn(*args)
        except RuntimeError as e:
            msg = str(e)
        else:
            msg = None
        expect(msg is not None and "no backward" in msg,
               f"{fn.__name__} launched on an input that requires grad")
    print("wkv6 and ssd on an input that requires grad raised: "
          f"{msg[:80]}")


def phase_lm_train(dev: torch.device) -> None:
    """Train the LMs on the card: (a) qwen2-1.5b at full width, (d) a
    checkpoint of it cut to CUT_LAYERS layers, (b) its depth-cut first
    step against the CPU, (c) rwkv6-3b,
    zamba2-7b and the MoE, MLA, VLM and audio models at full width,
    depth cut, (e) a 2-layer MoE prefill against the CPU; the six
    kernels' counts set to 0 just before and read just after: the
    training path launches none."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    train_full_width(dev)
    checkpoint_cut(dev)
    train_card_vs_cpu(dev)
    for name in ("rwkv6-3b", "zamba2-7b", "qwen3-moe-30b-a3b",
                 "deepseek-v3-671b", "qwen2-vl-7b", "musicgen-medium"):
        train_cut(name, dev)
        torch.cuda.empty_cache()
    moe_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    counts = {k: f.launches for k, f in fns.items()}
    expect(not any(counts.values()), f"the LM training phase launched "
           f"{counts}")
    check_kernels_refuse_grad(dev)
    print(f"LM training phase launches: {counts}")


MESH_STEPS = 3       # ruled, then plain, steps of phase 9


def mesh_train(cfg, hp, rules, dev: torch.device, steps: int,
               keep_at: int | None = None) -> dict:
    """``steps`` train steps of ``cfg`` from seed 0 (B = TRAIN_B, S =
    TRAIN_S) with ``rules`` (None: the plain step), each timed; the
    state after ``keep_at`` steps is kept as a host snapshot (its global
    tensors, what a checkpoint writes). A ruled run's state is placed on
    the mesh before the steps. Returns losses, seconds, the steps' peak
    (from the placed state on), the final parameters on the host and the
    snapshot."""
    from repro_torch.distributed.sharding import (gather_tree,
                                                  tree_map_with_path)
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (init_opt_state, make_train_step,
                                         place_train_state)

    torch.cuda.empty_cache()
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = init_opt_state(params, hp)
    if rules is not None:              # placed before the steps
        params, opt = place_train_state(params, opt, rules)
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_train_step(cfg, rules, hp)
    out = {"losses": [], "secs": [], "snapshot": None}
    for i in range(steps):
        if i == keep_at:
            out["snapshot"] = tree_map_with_path(   # leaf by leaf
                lambda _, t: gather_tree(t).cpu()
                if isinstance(t, torch.Tensor) else t, (params, opt))
        batch = synthetic_batch(cfg, TRAIN_B, TRAIN_S, i, 0, dev)
        params, opt, loss, dt = step_timed(step, params, opt, batch)
        out["losses"].append(loss)
        out["secs"].append(dt)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["params"] = {k: v.cpu() for k, v in leaves(gather_tree(params))}
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_mesh(dev: torch.device, smi: str) -> None:
    """9. The mesh side on the one card: a one-rank nccl process group
    (a ``HashStore``, no network) and ``init_device_mesh("cuda", (1, 1),
    ("data", "model"))`` with ``pick_strategy``'s rules for qwen2-1.5b's
    ``train_4k`` cell (fsdp). MESH_STEPS ruled steps of qwen2-1.5b at full
    width (B = TRAIN_B, S = TRAIN_S), then the same plain steps from the
    same seed, in turn (one model on the card at a time): the losses and
    every parameter leaf equal bit for bit; ms per step and the peaks.
    Then ``compress_error_feedback`` over the model's real gradient tree,
    two rounds (the second carries the first's error), on the card,
    bit for bit with the same calls on the card machine's CPU; its ms.
    Then the elastic resume: the ruled run's state after its second step
    (host snapshot), ``replan_mesh(1, model_parallel=1)``,
    ``reshard_tree``, one step: equal to the ruled run's third step bit
    for bit. Then :func:`tp_ep_one_rank` on the same mesh and, the nccl
    group gone, :func:`fake_group_prefill`, :func:`seq_split_steps`,
    :func:`fullep_steps` and :func:`seq_tensor_prefills`, whose meta
    counts a process started as the phase starts makes meanwhile
    (:func:`spawn_sp_meta`).
    The six kernels' counts are set to 0 just before and read before the
    fake groups: this path launches none; the fake groups gate their own
    counts."""
    import os
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.compression import (compress_error_feedback,
                                                     init_error)
    from repro_torch.distributed.elastic import (replan_mesh, reshard_tree,
                                                 rules_for)
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import loss_and_grads, make_train_step

    sp_meta = spawn_sp_meta()
    fns = counters()
    for f in fns.values():
        f.launches = 0
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed("cuda", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config(TRAIN_LM)
        strat = pick_strategy(cfg, SHAPES["train_4k"])
        hp = strat.hparams
        expect(strat.name == "fsdp", f"{TRAIN_LM} train_4k: {strat}")
        rules = make_mesh_rules(mesh, strat)
        ruled = mesh_train(cfg, hp, rules, dev, MESH_STEPS, keep_at=2)
        plain = mesh_train(cfg, hp, None, dev, MESH_STEPS)
        diff = [k for k, v in plain["params"].items()
                if not torch.equal(v, ruled["params"][k])]
        expect(ruled["losses"] == plain["losses"] and not diff,
               f"ruled {ruled['losses']} vs plain {plain['losses']}; "
               f"leaves differ: {diff[:5]}")

        def ms(r):
            return (f"first {r['secs'][0] * 1e3:.1f}, then "
                    + ", ".join(f"{t * 1e3:.1f}" for t in r["secs"][1:]))
        print(f"mesh {TRAIN_LM} (full width, B = {TRAIN_B}, S = {TRAIN_S}; "
              f"one-rank nccl mesh (1, 1) data x model, rules "
              f"{strat.name}): ruled losses {ruled['losses']} equal the "
              f"plain steps' and every one of the {len(plain['params'])} "
              f"parameter leaves bit for bit; ms per step ruled {ms(ruled)}"
              f" / plain {ms(plain)}; max memory allocated ruled "
              f"{ruled['peak'] / 2**30:.2f} GiB / plain "
              f"{plain['peak'] / 2**30:.2f} GiB; card: {smi}")

        # int8 error-feedback compression of the real gradient tree
        params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
        _, _, grads = loss_and_grads(
            params, cfg, synthetic_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, dev),
            hp)
        del params
        err, secs, rounds = init_error(grads), [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp, _, err = compress_error_feedback(grads, err)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rounds.append([dict(leaves(t)) for t in (comp.q, comp.scale,
                                                     err)])
        bad, n_values = [], 0
        for k, g in leaves(grads):          # the same calls, leaf by leaf
            g_c, e_c = {"g": g.cpu()}, {"g": torch.zeros(g.shape)}
            n_values += g.numel()
            for q, scale, e in rounds:
                c_c, _, e_c = compress_error_feedback(g_c, e_c)
                if not (torch.equal(c_c.q["g"], q[k].cpu())
                        and torch.equal(c_c.scale["g"], scale[k].cpu())
                        and torch.equal(e_c["g"], e[k].cpu())):
                    bad.append(k)
        expect(not bad, f"compression: card and CPU differ at {bad[:5]}")
        print(f"  compress_error_feedback over the {len(leaves(grads))} "
              f"gradient leaves ({n_values / 1e9:.3f} B values, blocks "
              f"of 1024): two rounds on the card {secs[0] * 1e3:.1f} / "
              f"{secs[1] * 1e3:.1f} ms; q, scales and the carried error "
              f"bit for bit with the card machine's CPU")
        del grads, err, rounds, comp
        torch.cuda.empty_cache()

        # elastic: the snapshot after two steps, re-meshed, resharded
        new_mesh = replan_mesh(1, model_parallel=1)
        expect(tuple(new_mesh.shape) == (1, 1)
               and new_mesh.mesh_dim_names == ("data", "model"),
               f"replan_mesh(1, model_parallel=1): {new_mesh}")
        t0 = time.perf_counter()
        params, opt = reshard_tree(ruled.pop("snapshot"), new_mesh)
        t_place = time.perf_counter() - t0
        step = make_train_step(cfg, rules_for(new_mesh), hp)
        params, opt, loss, dt = step_timed(
            step, params, opt,
            synthetic_batch(cfg, TRAIN_B, TRAIN_S, 2, 0, dev))
        got = {k: v for k, v in leaves(gather_tree(params))}
        diff = [k for k, v in got.items()
                if not torch.equal(v.cpu(), ruled["params"][k])]
        expect(loss == ruled["losses"][2] and not diff,
               f"elastic resume: loss {loss} vs {ruled['losses'][2]}, "
               f"leaves differ {diff[:5]}")
        print(f"  elastic: the ruled run's state after 2 steps (host "
              f"snapshot) resharded onto replan_mesh(1, model_parallel=1) "
              f"in {t_place:.2f} s, one step ({dt * 1e3:.1f} ms): loss "
              f"{loss} and every leaf equal to the uninterrupted third step")
        del params, opt, got
        torch.cuda.empty_cache()
        tp_ep_one_rank(mesh, dev)
    finally:
        dist.destroy_process_group()
    counts = {k: f.launches for k, f in fns.items()}
    expect(not any(counts.values()), f"the mesh phase launched {counts}")
    print(f"mesh phase launches: {counts}")
    split = fake_group_prefill(dev, smi)
    print(f"mesh phase, the head-split prefills' counted runs: {split}")
    seq_split_steps(dev, smi)
    fullep_steps(dev, smi)
    sp = seq_tensor_prefills(dev, smi, sp_meta)
    print(f"mesh phase, the sequence-split prefills' kernel runs: {sp}")


FAKE_RANKS = 8       # phase 9's fake group: the (1, 8) mesh's ranks


def tp_ep_one_rank(mesh, dev: torch.device) -> None:
    """9b. qwen3-moe-30b-a3b depth-cut (CUT_B, CUT_S, two microbatches)
    under its train_4k (tp_ep) rules on the one-rank mesh against the
    plain step: loss and every parameter bit for bit."""
    import dataclasses
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (init_opt_state, make_train_step,
                                         place_train_state)

    name = "qwen3-moe-30b-a3b"
    cfg = depth_cut(name)
    strat = pick_strategy(cfg, SHAPES["train_4k"])
    expect(strat.name == "tp_ep", f"{name} train_4k: {strat}")
    hp = dataclasses.replace(strat.hparams, n_micro=CUT_B,
                             loss_chunk=min(512, CUT_S))
    rules = make_mesh_rules(mesh, strat)
    runs = []
    for r in (rules, None):
        torch.cuda.empty_cache()
        params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
        opt = init_opt_state(params, hp)
        if r is not None:
            params, opt = place_train_state(params, opt, r)
        step = make_train_step(cfg, r, hp)
        params, opt, loss, dt = step_timed(
            step, params, opt, synthetic_batch(cfg, CUT_B, CUT_S, 0, 0, dev))
        runs.append((loss, dt, {k: v.cpu() for k, v in
                                leaves(gather_tree(params))}))
        del params, opt
    torch.cuda.empty_cache()
    diff = [k for k, v in runs[1][2].items() if not torch.equal(v,
                                                                runs[0][2][k])]
    expect(runs[0][0] == runs[1][0] and not diff,
           f"{name} tp_ep on (1, 1): loss {runs[0][0]} vs plain "
           f"{runs[1][0]}; leaves differ: {diff[:5]}")
    print(f"  {name} (full width, cut to {cfg.n_layers} layers, B = "
          f"{CUT_B}, S = {CUT_S}, {hp.n_micro} microbatches) under its "
          f"train_4k rules ({strat.name}) on the one-rank (1, 1) mesh: loss "
          f"{runs[0][0]} and every one of the {len(runs[1][2])} parameter "
          f"leaves equal to the plain step's bit for bit; one step "
          f"{runs[0][1] * 1e3:.1f} ms ruled / {runs[1][1] * 1e3:.1f} ms "
          f"plain (first steps)")


def rank_blocks(specs, mesh, dev: torch.device, gen=None):
    """A tree of ``launch/specs.py`` stand-ins as DTensors on ``mesh``
    holding this rank's blocks: on meta (no data), or made on ``dev``
    from ``gen`` (float leaves N(0, 0.02^2) in their dtype, integer
    leaves token ids below 1000, or below the dtype's bound: int8 Adam
    moments)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.specs import Spec

    def one(sp):
        if not isinstance(sp, Spec):
            return sp
        shape = sp.shard_shape
        if dev.type == "meta":
            local = torch.empty(shape, dtype=sp.dtype, device=dev)
        elif sp.dtype.is_floating_point:
            local = (torch.randn(shape, generator=gen, device=dev)
                     * 0.02).to(sp.dtype)
        else:
            high = min(1000, torch.iinfo(sp.dtype).max + 1)
            local = torch.randint(0, high, shape, generator=gen,
                                  device=dev, dtype=sp.dtype)
        return DTensor.from_local(local, mesh, sp.sharding.placements,
                                  run_check=False, shape=torch.Size(sp.shape),
                                  stride=torch.empty(sp.shape,
                                                     device="meta").stride())
    return tree_map(one, specs)


# phase 9's head-split recurrent prefills (rank 0 of FAKE_RANKS: 5 of
# rwkv6-3b's 40 heads, 14 of zamba2-7b's 112; zamba2-7b cut to 6 layers,
# one shared-block period, for the run's time limit) and the MLA prefill
# (deepseek-v3-671b cut to 4 layers, 16 of 128 heads): (arch, batch,
# depth or None)
FAKE_RECURRENT = (("rwkv6-3b", 8, None), ("zamba2-7b", 4, 6))
FAKE_MLA = ("deepseek-v3-671b", 4, 4)
# one decode step over a capacity-split cache: stablelm-12b's 8 K/V heads
# divide 8 ranks, so its split (8 K/V heads on 16, the production mesh's
# decode_32k) runs as rank 0 of a fake group of 16, each rank 1/16 of a
# decode_32k cache (B = 8 rows, all on rank 0's data coordinate)
FAKE_DECODE = ("stablelm-12b", 8, 16, 32768)
# one decode step over MLA's capacity-split latent cache: deepseek-v3-671b
# at full width cut to 4 layers (its 3 dense layers and 1 MoE layer) as
# rank 0 of a fake group of 16 under decode_32k's rules, 2,048 of 32,768
# capacity rows of the latent and the RoPE key, B = 8 rows (all on rank
# 0's data coordinate); (arch, batch, ranks, capacity, layers)
FAKE_MLA_DECODE = ("deepseek-v3-671b", 8, 16, 32768, 4)
# the codebook heads split over the vocabulary: musicgen-medium's full
# prefill as rank 0 of FAKE_RANKS (2048 / 8 columns of each of its 4
# heads; 4 codebooks do not split 8 ways, so its embeddings are whole);
# (arch, batch)
FAKE_CODEBOOKS = ("musicgen-medium", 8)
# the leaves a head-split layer gathers whole over the tensor axis: held
# whole over "model" in the fake groups (whose all-gather writes nothing)
# so that the kernel and chunked runs read defined values
WHOLE_OVER_MODEL = r"(mamba/(in_proj|conv_w|conv_b)|channel_mix/wr)$"


def whole_over_model(specs, pattern: str):
    """``launch/specs.py`` stand-ins with the leaves at ``pattern`` held
    whole over the "model" axis (their shards over other axes kept)."""
    import re
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  tree_map_with_path)
    from repro_torch.launch.specs import Spec

    def drop(ax):
        if isinstance(ax, tuple):
            rest = tuple(a for a in ax if a != "model")
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return None if ax == "model" else ax

    def one(path, sp):
        if not (isinstance(sp, Spec) and sp.sharding is not None
                and re.search(pattern, "/".join(map(str, path)))):
            return sp
        return Spec(sp.shape, sp.dtype, NamedSharding(
            sp.sharding.mesh, tuple(drop(a) for a in sp.sharding.spec)))
    return tree_map_with_path(one, specs)


def fake_rank_specs(cfg, batch: int, seq_len: int, rules, strat,
                    whole: str | None = None):
    """The ``launch/specs.py`` stand-ins of this rank's prefill of
    ``cfg`` (B = ``batch``, S = ``seq_len``) under ``rules``; ``whole``:
    a pattern of the leaves held whole over "model"
    (:func:`whole_over_model`)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_specs
    sp = cell_specs(cfg, ShapeSpec("fake_rank0", seq_len, batch, "prefill"),
                    rules, strat)
    return sp if whole is None else whole_over_model(sp, whole)


def meta_count(cfg, batch: int, mesh, rules, strat,
               whole: str | None = None, seq_len: int = LM_PROMPT) -> dict:
    """``launch.hlo_analysis.analyze`` of this rank's chunked prefill
    (:func:`fake_rank_specs`) on meta: its counts, and the seconds they
    took as ``t_meta``."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.train.steps import make_prefill_step
    t0 = time.perf_counter()
    _, meta = analyze(make_prefill_step(cfg, rules, kernels=False),
                      *rank_blocks(fake_rank_specs(cfg, batch, seq_len,
                                                   rules, strat, whole),
                                   mesh, torch.device("meta")))
    meta["t_meta"] = time.perf_counter() - t0
    return meta


def fake_rank_prefill(cfg, batch: int, meshes: dict, rules: dict, strat,
                      dev: torch.device, kernels: bool = True,
                      whole: str | None = None,
                      seq_len: int = LM_PROMPT, warm: int = 3,
                      meta: dict | None = None) -> dict:
    """This rank's prefill of ``cfg`` (B = ``batch``, S = ``seq_len``)
    under ``rules`` from its own blocks, on meta (:func:`meta_count`,
    unless ``meta`` holds its counts already) and on the card under
    ``launch.hlo_analysis.analyze`` (``kernels``: the card's run may
    launch the recurrences' kernels, which meta cannot see; False for a
    held count), then ``warm`` warm runs. ``whole``: a pattern of the
    leaves held whole over "model" (:func:`whole_over_model`). Returns
    the counts, the peak, the blocks' bytes, the timings (the card's
    analysed run's seconds among them), the step, its arguments and its
    output."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.train.steps import make_prefill_step

    if meta is None:
        meta = meta_count(cfg, batch, meshes["cpu"], rules["cpu"], strat,
                          whole, seq_len)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    args = rank_blocks(fake_rank_specs(cfg, batch, seq_len, rules["cuda"],
                                       strat, whole),
                       meshes["cuda"], dev,
                       torch.Generator(dev).manual_seed(0))
    step = make_prefill_step(cfg, rules["cuda"], kernels=kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, card = analyze(step, *args)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    held = sum(t.to_local().nbytes for _, t in leaves(args[0]))
    secs = []
    for _ in range(warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"meta": meta, "card": card, "peak": peak, "held": held,
            "secs": secs, "t_meta": meta["t_meta"], "t_card": t_card,
            "step": step, "args": args, "out": out}


def check_fake_counts(name: str, r: dict) -> float:
    """The meta count of a fake rank's run against the card's: FLOPs
    equal, the predicted peak within PEAK_TOL; returns the ratio."""
    meta, card, peak = r["meta"], r["card"], r["peak"]
    ratio = meta["peak_bytes"] / peak
    expect(meta["flops"] == card["flops"],
           f"{name} fake-group prefill: FLOPs on meta {meta['flops']:.6e} "
           f"vs on the card {card['flops']:.6e}")
    expect(abs(ratio - 1) <= PEAK_TOL,
           f"{name} fake-group prefill: predicted peak "
           f"{meta['peak_bytes'] / 2**30:.3f} GiB vs the card's "
           f"{peak / 2**30:.3f} GiB (ratio {ratio:.4f})")
    return ratio


def fake_rank_recurrent(name: str, batch: int, layers: int | None,
                        meshes: dict, rules: dict, strat, dev: torch.device,
                        smi: str) -> dict:
    """9d. Rank 0's full-width prefill of a recurrent arch (its depth cut
    to ``layers`` if given) on its head shard: the chunked run
    (``kernels=False``) counted on meta and on the card (FLOPs equal,
    peak within PEAK_TOL); the kernel run with the counts set to 0 just
    before and read just after (one launch of the arch's kernel per
    layer, on this rank's heads); every layer of a kernel run held to
    the chunked path on the same input within LM_TOL (:func:`layerwise`)
    and each launch's own outputs to the chunked form within KERNEL_REL
    (:func:`against_chunked`), and the two whole runs' states compared
    (reported). The gathered leaves are held whole over "model"
    (:func:`whole_over_model`) and the fake all-reduces leave each
    partial sum as it is, so both runs read the same values."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import mesh_plan, ssm_heads
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    kernel = "wkv6" if cfg.family == "ssm" else "ssd"
    plan = mesh_plan(cfg, rules["cuda"])
    expect(plan.heads, f"{name}: its heads do not split over "
           f"{FAKE_RANKS} ranks ({plan})")
    fns = counters()
    for f in fns.values():
        f.launches = 0
    chunked = fake_rank_prefill(cfg, batch, meshes, rules, strat, dev,
                                kernels=False, whole=WHOLE_OVER_MODEL)
    ratio = check_fake_counts(name, chunked)
    expect(not any(f.launches for f in fns.values()),
           f"{name}: the chunked prefill launched a kernel")
    args = chunked["args"]
    step = make_prefill_step(cfg, rules["cuda"])
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, st = step(*args)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launched = {k: f.launches for k, f in fns.items()}
    want = {k: (cfg.n_layers if k == kernel else 0) for k in fns}
    expect(launched == want, f"{name} head-split prefill launched "
           f"{launched}, want {want}")
    heads = ssm_heads(cfg) // FAKE_RANKS
    rec = st["rwkv"]["wkv"] if cfg.family == "ssm" else st["mamba"]["ssm"]
    expect(rec.shape[2] == heads, f"{name}: the state holds "
           f"{rec.shape[2]} heads, this rank's are {heads}")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    breakdown = device_breakdown(lambda: step(*args), min(secs))
    with against_chunked(cfg) as site:
        worst, _, _ = layerwise(cfg, lambda: step(*args))
    # the states (the logits pass through the fake all-gather, unwritten)
    ref = dict(leaves(chunked["out"][1]))
    whole_err = {k: max_err_f(t, ref[k]) for k, t in leaves(st)
                 if k != "/len"}
    ok = all(ok for _, ok in worst.values())
    own = (sorted(site) == ["state", "y"]
           and all(n == cfg.n_layers and share <= KERNEL_REL
                   for share, n, _ in site.values()))
    depth = (f"cut to {cfg.n_layers} layers" if layers is not None
             else "full depth")
    print(f"  {name} prefill (full width, {depth}, B = {batch}, S = "
          f"{LM_PROMPT}, prefill_32k's rules {strat.name}) as rank 0 of "
          f"{FAKE_RANKS}: {heads} of {ssm_heads(cfg)} heads, {kernel} "
          f"launched {launched[kernel]} times on [B, S, {heads}, "
          f"{cfg.ssm.head_dim}]; every layer of the kernel run vs the "
          f"chunked path on the same input (limit rtol = atol = "
          f"{LM_TOL['rtol']}): " + ", ".join(
              f"{k} max |err| {e:.3g}{'' if good else ' FAIL'}"
              for k, (e, good) in worst.items())
          + f"; each launch's own outputs vs the chunked form on the same "
          f"inputs (limit max |err| <= {KERNEL_REL} x max |chunked|): "
          + ", ".join(f"{k} max |err| / max |chunked| {share:.3g} over "
                      f"{n} calls (max |chunked| {lo:.3g} or more)"
                      for k, (share, n, lo) in site.items())
          + "; whole runs (not gated): " + ", ".join(
              f"{k} {e:.3g}" for k, e in whole_err.items())
          + f"; chunked FLOPs meta {chunked['meta']['flops']:.6e} = card "
          f"{chunked['card']['flops']:.6e}, predicted peak "
          f"{chunked['meta']['peak_bytes'] / 2**30:.3f} GiB vs "
          f"{chunked['peak'] / 2**30:.3f} GiB (ratio {ratio:.4f}); ms: "
          f"kernel first {t_first * 1e3:.1f}, warm "
          + ", ".join(f"{t * 1e3:.1f}" for t in secs)
          + "; chunked warm " + ", ".join(f"{t * 1e3:.1f}"
                                          for t in chunked["secs"])
          + f"; blocks {chunked['held'] / 2**30:.2f} GiB; kernel run: "
          f"{breakdown}; card: {smi}")
    expect(ok, f"{name}: a layer of the head-split kernel prefill differs "
           f"from the chunked path")
    expect(own, f"{name}: the head-split prefill's {kernel} differs from "
           f"its chunked form: {site}")
    del chunked, args, logits, st
    torch.cuda.empty_cache()
    return launched


def fake_rank_decode(dev: torch.device, smi: str) -> None:
    """9e. One eager decode step of the full-width ``FAKE_DECODE`` arch as
    rank 0 of a fake group of its size on a "cuda" (1, n) mesh, under
    decode_32k's rules, over its capacity rows of every K/V head (the
    split-capacity decode: the new token's q gathered, the partial
    softmax merged over "model"; no-op collectives, values not checked):
    ms, peak above the blocks and device ms by kernel; then
    :func:`check_split_decode_graph` in the same group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.distributed.tensor_parallel import mesh_plan
    from repro_torch.launch.dryrun import cell_specs
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.train.steps import make_serve_step

    name, batch, ranks, capacity = FAKE_DECODE
    cfg = get_config(name)
    strat = pick_strategy(cfg, SHAPES["decode_32k"])
    shape = ShapeSpec("fake_rank0", capacity, batch, "decode")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        mesh = init_device_mesh("cuda", (1, ranks),
                                mesh_dim_names=("data", "model"))
        rules = make_mesh_rules(mesh, strat)
        plan = mesh_plan(cfg, rules)
        expect(plan.cap and not plan.kv, f"{name} on (1, {ranks}): {plan}")
        torch.cuda.empty_cache()
        gen = torch.Generator(dev).manual_seed(0)
        params, tokens, state = rank_blocks(
            cell_specs(cfg, shape, rules, strat), mesh, dev, gen)
        state = tree_map(lambda t: t.to_local(), state)
        state["len"] = torch.tensor(capacity // 2, dtype=torch.int32,
                                    device=dev)
        tokens = tokens.full_tensor() % cfg.vocab_size
        rows = capacity // ranks
        expect(tuple(state["main"]["k"].shape) == (
            cfg.n_layers, batch, rows, cfg.n_kv_heads,
            cfg.resolved_head_dim), f"{name}: rank 0's cache "
            f"{tuple(state['main']['k'].shape)}")
        held = sum(t.to_local().nbytes for _, t in leaves(params))
        cache = sum(t.nbytes for _, t in leaves(state))
        serve = make_serve_step(cfg, rules)
        with torch.no_grad():
            serve(params, tokens, state)                   # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(params, tokens, state)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev) - base
            breakdown = device_breakdown(
                lambda: serve(params, tokens, state), min(secs))
        del params, state
        torch.cuda.empty_cache()
        graphed = check_split_decode_graph(cfg, rules, dev)
    finally:
        dist.destroy_process_group()
    print(f"  {name} decode step (full width and depth, B = {batch}, "
          f"decode_32k's rules {strat.name}, capacity {capacity}) as rank "
          f"0 of a fake group of {ranks}: {cfg.n_kv_heads} K/V heads do "
          f"not split {ranks} ways, so it holds rows [0, {rows}) of every "
          f"K/V head ({cache / 2**30:.2f} GiB of cache, {held / 2**30:.2f} "
          f"GiB of blocks); eager ms "
          + ", ".join(f"{t * 1e3:.2f}" for t in secs)
          + f"; peak above its inputs {peak / 2**30:.3f} GiB; {breakdown}; "
          f"{graphed}; card: {smi}")


def check_split_decode_graph(cfg, rules, dev: torch.device) -> str:
    """One layer's decode over a capacity-split cache (this rank's 256
    rows, B = 8: of every K/V head, or of MLA's latent and RoPE key)
    captured as a CUDA graph: the replay equal to eager bit for bit
    (output and cache), the row of a position this rank owns written and
    no other, and with the position moved to another rank's rows, the
    cache left as it was (the write is a masked local index, no host
    read)."""
    from repro_torch.distributed.tensor_parallel import mesh_plan
    from repro_torch.models import layers as L

    group = mesh_plan(cfg, rules).tp
    gen = torch.Generator(dev).manual_seed(0)
    b, c = 8, 256
    if cfg.mla:
        p, layer, what = L.init_mla(cfg, gen, dev), L.mla_attention, "MLA"
        shapes = ((b, c, cfg.mla.kv_lora_rank),
                  (b, c, cfg.mla.qk_rope_head_dim))
    else:
        p, layer = L.init_attention(cfg, gen, dev), L.attention
        what = "attention"
        shapes = 2 * ((b, c, cfg.n_kv_heads, cfg.resolved_head_dim),)
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
              for sh in shapes)
    n = torch.tensor(100, dtype=torch.int32, device=dev)
    pos = n + torch.arange(1, device=dev)

    def run(k, v):
        with torch.no_grad():
            return layer(p, x, cfg, positions=pos, kv_cache=(k, v),
                         cache_len=n, cap=group)[0]
    e_ck, e_cv = ck.clone(), cv.clone()
    want = run(e_ck, e_cv)
    s_ck, s_cv = ck.clone(), cv.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run(s_ck.clone(), s_cv.clone())
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(s_ck, s_cv)
    graph.replay()
    torch.cuda.synchronize()
    row = int(n)
    others = [i for i in range(c) if i != row]
    expect(torch.equal(out, want) and torch.equal(s_ck, e_ck)
           and torch.equal(s_cv, e_cv), f"the captured split {what} decode "
           f"differs from eager")
    expect(not torch.equal(s_ck[:, row], ck[:, row])
           and torch.equal(s_ck[:, others], ck[:, others]),
           f"the split {what} decode wrote another row than its position's")
    n.fill_(c + 5)                     # a position another rank owns
    pos.copy_(n + torch.arange(1, device=dev))
    before = s_ck.clone()
    graph.replay()
    torch.cuda.synchronize()
    expect(torch.equal(before, s_ck), f"the split {what} decode wrote a "
           f"position another rank owns")
    return (f"one layer's split {what} decode captured as a CUDA graph: "
            f"equal to eager bit for bit, the owned row written alone, "
            f"another rank's position left unwritten")


def mla_decode_inputs(cfg, rules, mesh, strat, dev: torch.device,
                      gen=None) -> tuple:
    """Rank 0's serve-step arguments for FAKE_MLA_DECODE: its parameter
    blocks, [B, 1] tokens and its decode state as the step computes with
    it (rank 0's capacity rows of each part's latent and RoPE key; ``len``
    half the capacity: every row of rank 0 valid, the new row another
    rank's); on meta, or drawn on ``dev`` from ``gen``."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_specs
    from repro_torch.models import model as M

    _, batch, ranks, capacity, _ = FAKE_MLA_DECODE
    shape = ShapeSpec("fake_rank0", capacity, batch, "decode")
    params = rank_blocks(cell_specs(cfg, shape, rules, strat)[0], mesh, dev,
                         gen)
    state = M.init_decode_state(cfg, batch, capacity // ranks, dev)
    if gen is None:
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    else:
        for _, t in leaves(state):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                               device=dev, dtype=torch.int32)
    state["len"].fill_(capacity // 2)
    return params, tokens, state


def fake_rank_mla_decode(dev: torch.device, smi: str) -> None:
    """9h. One decode step of FAKE_MLA_DECODE as rank 0 of a fake group
    of its size on a "cuda" (1, n) mesh under decode_32k's rules, over
    its capacity rows of MLA's latent cache (``Plan.cap``: the heads'
    absorbed queries gathered, every head scored against the rows, the
    partial softmaxes merged over "model"; no-op collectives, values not
    checked). Gates: each part's cache [L, B, C / n, r] and [L, B, C /
    n, dr]; FLOPs on meta equal to the card's; the meta peak within
    PEAK_TOL of the card's; the six kernels' counts, set to 0 just before
    the counted run and read just after, all 0. Then
    :func:`check_split_decode_graph` of one MLA layer in the same
    group."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.tensor_parallel import mesh_plan
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.train.steps import make_serve_step

    name, batch, ranks, capacity, layers = FAKE_MLA_DECODE
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    strat = pick_strategy(cfg, SHAPES["decode_32k"])
    rows = capacity // ranks
    fns = counters()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        meshes = {d: init_device_mesh(d, (1, ranks),
                                      mesh_dim_names=("data", "model"))
                  for d in ("cpu", "cuda")}
        rules = {d: make_mesh_rules(m, strat) for d, m in meshes.items()}
        plan = mesh_plan(cfg, rules["cuda"])
        expect(plan.cap and plan.heads, f"{name} on (1, {ranks}): {plan}")
        t0 = time.perf_counter()
        with torch.no_grad():
            _, meta = analyze(make_serve_step(cfg, rules["cpu"]),
                              *mla_decode_inputs(cfg, rules["cpu"],
                                                 meshes["cpu"], strat,
                                                 torch.device("meta")))
        t_meta = time.perf_counter() - t0
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        args = mla_decode_inputs(cfg, rules["cuda"], meshes["cuda"], strat,
                                 dev, torch.Generator(dev).manual_seed(0))
        params, _, state = args
        nd = cfg.moe.n_dense_layers
        want = {f"/{part}/{k}": (n, batch, rows, w)
                for part, n in (("dense", nd), ("main", layers - nd))
                for k, w in (("latent", cfg.mla.kv_lora_rank),
                             ("krope", cfg.mla.qk_rope_head_dim))}
        got = {k: tuple(t.shape) for k, t in leaves(state) if k != "/len"}
        expect(got == want, f"{name}: rank 0's cache {got}, want {want}")
        held = sum(t.to_local().nbytes for _, t in leaves(params))
        cache = sum(t.nbytes for _, t in leaves(state))
        serve = make_serve_step(cfg, rules["cuda"])
        for f in fns.values():
            f.launches = 0
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            out, card = analyze(serve, *args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            counts = {k: f.launches for k, f in fns.items()}
            del out
            secs = timed_runs(lambda: serve(*args))
            busy = device_breakdown(lambda: serve(*args), min(secs))
        del args, params, state
        torch.cuda.empty_cache()
        graphed = check_split_decode_graph(cfg, rules["cuda"], dev)
    finally:
        dist.destroy_process_group()
    ratio = meta["peak_bytes"] / peak
    expect(meta["flops"] == card["flops"],
           f"{name} split decode: FLOPs on meta {meta['flops']:.6e} vs on "
           f"the card {card['flops']:.6e}")
    expect(abs(ratio - 1) <= PEAK_TOL,
           f"{name} split decode: predicted peak "
           f"{meta['peak_bytes'] / 2**30:.3f} GiB vs the card's "
           f"{peak / 2**30:.3f} GiB (ratio {ratio:.4f})")
    expect(not any(counts.values()), f"{name} split decode launched "
           f"{counts}")
    print(f"  {name} decode step (full width, cut to {layers} layers, B = "
          f"{batch}, decode_32k's rules {strat.name}, capacity {capacity}) "
          f"as rank 0 of a fake group of {ranks}: MLA on "
          f"{cfg.n_heads // ranks} of {cfg.n_heads} heads over rows [0, "
          f"{rows}) of the latent cache, every part's leaves "
          f"{sorted(set(got.values()))} ({cache / 2**30:.3f} GiB of cache, "
          f"{held / 2**30:.2f} GiB of blocks; values not checked); FLOPs "
          f"meta {meta['flops']:.6e} = card {card['flops']:.6e}; predicted "
          f"peak {meta['peak_bytes'] / 2**30:.3f} GiB vs max memory "
          f"allocated {peak / 2**30:.3f} GiB (ratio {ratio:.4f}); launches "
          f"{counts}; eager ms " + ", ".join(f"{t * 1e3:.2f}" for t in secs)
          + f"; meta analysis {t_meta:.1f} s; {busy}; {graphed}; card: "
          f"{smi}")


def fake_group_prefill(dev: torch.device, smi: str) -> dict:
    """9c. Rank 0 of a fake group of FAKE_RANKS on a "cuda" (1, 8) mesh:
    the full qwen3-moe-30b-a3b prefill (B = 8, S = LM_PROMPT) under
    prefill_32k's rules, from rank 0's own blocks: FLOPs equal to the
    meta count of the same rank, the meta peak within PEAK_TOL of the
    card's; ms and device ms by op beside phase 7's whole-model prefill.
    The fake group's collectives do nothing (an all-gather leaves its
    output unwritten), so the values are not checked. Then, in the same
    group, FAKE_MLA's prefill the same way (MLA on 16 of 128 heads, its
    cache this rank's capacity rows) and FAKE_CODEBOOKS' (the codebook
    heads on 256 of 2048 vocabulary columns), and the head-split
    recurrent prefills of FAKE_RECURRENT (:func:`fake_rank_recurrent`);
    last :func:`fake_rank_decode` and :func:`fake_rank_mla_decode`. The
    six kernels' counts are set to 0 just before the qwen3-moe prefill
    and read just after the codebook one, and again around the decodes:
    those launch none (the recurrent prefills and the MLA decode gate
    their own). Prints the seconds these added; returns the recurrent
    kernels' launches."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.tensor_parallel import mesh_plan
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy

    name, batch = "qwen3-moe-30b-a3b", 8
    cfg = get_config(name)
    strat = pick_strategy(cfg, SHAPES["prefill_32k"])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_RANKS)
    launched = {}
    fns = counters()

    def no_launches(what: str) -> None:
        counts = {k: f.launches for k, f in fns.items()}
        expect(not any(counts.values()), f"{what} launched {counts}")
        print(f"  {what}: launches {counts}")
    try:
        meshes = {d: init_device_mesh(d, (1, FAKE_RANKS),
                                      mesh_dim_names=("data", "model"))
                  for d in ("cpu", "cuda")}
        rules = {d: make_mesh_rules(m, strat) for d, m in meshes.items()}
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        r = fake_rank_prefill(cfg, batch, meshes, rules, strat, dev)
        warm = min(r["secs"])
        breakdown = device_breakdown(lambda: r["step"](*r["args"]), warm)
        ratio = check_fake_counts(name, r)
        meta, card, peak, secs = r["meta"], r["card"], r["peak"], r["secs"]
        whole = PREFILL_WARM_S.get(name)
        print(f"  {name} prefill (full depth and width, B = {batch}, S = "
              f"{LM_PROMPT}, prefill_32k's rules {strat.name}) as rank 0 of "
              f"a fake group of {FAKE_RANKS} on a cuda (1, {FAKE_RANKS}) "
              f"mesh (values not checked: the fake collectives do nothing):"
              f" its blocks {r['held'] / 2**30:.2f} GiB; FLOPs meta "
              f"{meta['flops']:.6e} = card {card['flops']:.6e}; predicted "
              f"peak {meta['peak_bytes'] / 2**30:.3f} GiB vs max memory "
              f"allocated {peak / 2**30:.3f} GiB (ratio {ratio:.4f}); warm "
              f"{warm * 1e3:.1f} ms (runs "
              f"{', '.join(f'{t * 1e3:.1f}' for t in secs)}) against phase "
              f"7's whole-model prefill "
              + (f"{whole[0] * 1e3:.1f} ms at {whole[1]} layers" if whole
                 else "(not run)")
              + f"; meta analysis {r['t_meta']:.1f} s; {breakdown}; card: "
              f"{smi}")
        del r
        torch.cuda.empty_cache()
        took(f"9c's {name} prefill", t0)

        t_added = t0 = time.perf_counter()
        mla, mla_b, mla_layers = FAKE_MLA
        cfg = dataclasses.replace(get_config(mla), n_layers=mla_layers)
        plan = mesh_plan(cfg, rules["cuda"])
        expect(plan.heads, f"{mla}: MLA not split over {FAKE_RANKS} "
               f"({plan})")
        r = fake_rank_prefill(cfg, mla_b, meshes, rules, strat, dev)
        ratio = check_fake_counts(mla, r)
        print(f"  {mla} prefill (full width, cut to {mla_layers} layers, B "
              f"= {mla_b}, S = {LM_PROMPT}) as rank 0 of {FAKE_RANKS}: MLA "
              f"on {cfg.n_heads // FAKE_RANKS} of {cfg.n_heads} heads "
              f"(values not checked); its blocks "
              f"{r['held'] / 2**30:.2f} GiB; FLOPs meta "
              f"{r['meta']['flops']:.6e} = card {r['card']['flops']:.6e}; "
              f"predicted peak {r['meta']['peak_bytes'] / 2**30:.3f} GiB vs "
              f"{r['peak'] / 2**30:.3f} GiB (ratio {ratio:.4f}); warm ms "
              + ", ".join(f"{t * 1e3:.1f}" for t in r["secs"])
              + f"; meta analysis {r['t_meta']:.1f} s; card: {smi}")
        del r
        torch.cuda.empty_cache()
        took(f"9c's {mla} prefill", t0)

        t0 = time.perf_counter()
        cb, cb_b = FAKE_CODEBOOKS
        cfg = get_config(cb)
        plan = mesh_plan(cfg, rules["cuda"])
        expect(plan.vocab and not plan.books, f"{cb}: the codebook heads "
               f"not split over the vocabulary on {FAKE_RANKS} ({plan})")
        r = fake_rank_prefill(cfg, cb_b, meshes, rules, strat, dev)
        ratio = check_fake_counts(cb, r)
        logits = tuple(r["out"][0].shape)
        expect(logits == (cb_b, 1, cfg.n_codebooks, cfg.vocab_size),
               f"{cb}: logits {logits}")
        print(f"  {cb} prefill (full width and depth, B = {cb_b}, S = "
              f"{LM_PROMPT}) as rank 0 of {FAKE_RANKS}: the codebook heads "
              f"on {cfg.vocab_size // FAKE_RANKS} of {cfg.vocab_size} "
              f"vocabulary columns each (values not checked), logits "
              f"gathered to {logits}; its blocks {r['held'] / 2**30:.2f} "
              f"GiB; FLOPs meta {r['meta']['flops']:.6e} = card "
              f"{r['card']['flops']:.6e}; predicted peak "
              f"{r['meta']['peak_bytes'] / 2**30:.3f} GiB vs "
              f"{r['peak'] / 2**30:.3f} GiB (ratio {ratio:.4f}); all-gather "
              f"{r['card']['coll']['all-gather']['bytes']:.0f} B; warm ms "
              + ", ".join(f"{t * 1e3:.1f}" for t in r["secs"])
              + f"; meta analysis {r['t_meta']:.1f} s; card: {smi}")
        del r
        torch.cuda.empty_cache()
        took(f"9c's {cb} prefill", t0)
        no_launches(f"the {name}, {mla} and {cb} fake-group prefills")
        for arch, b, layers in FAKE_RECURRENT:
            t0 = time.perf_counter()
            got = fake_rank_recurrent(arch, b, layers, meshes, rules, strat,
                                      dev, smi)
            launched.update({k: launched.get(k, 0) + n
                             for k, n in got.items()})
            took(f"9d's {arch} prefill", t0)
    finally:
        dist.destroy_process_group()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    fake_rank_decode(dev, smi)
    no_launches(f"the {FAKE_DECODE[0]} split decode")
    took(f"9e's {FAKE_DECODE[0]} decode", t0)
    t0 = time.perf_counter()
    fake_rank_mla_decode(dev, smi)
    took(f"9h's {FAKE_MLA_DECODE[0]} decode", t0)
    print(f"  phase 9's head-split, MLA, codebook and capacity-split cases "
          f"added "
          f"{time.perf_counter() - t_added:.1f} s")
    return launched


# phase 9's sequence-split train steps: rank SEQ_RANKS - 1 (the last
# segment) of a fake group on a (SEQ_RANKS, 1, 1) pod x data x model mesh
# under the multi-pod fsdp rules; (arch, "depth": depth-cut as in phase 8,
# or "dense": deepseek-v3 cut to its one leading dense layer, batch,
# tokens, microbatches or None: the strategy's). deepseek-v3's depth cut
# (one dense and one MoE layer, 13.9 B parameters) does not fit the card:
# counted on meta at B = 8, S = 1024, its split step peaks at 104.8 GiB
# and its plain step at 214.5 GiB (the dense cut: 20.7 and 41.4)
SEQ_RANKS = 2
SEQ_SPLIT = (("qwen2-1.5b", "depth", TRAIN_B, TRAIN_S, None),
             ("rwkv6-3b", "depth", TRAIN_B, TRAIN_S, None),
             ("zamba2-7b", "depth", TRAIN_B, TRAIN_S, None),
             # the MoE's form (b): T_g 2,048 tokens over 512-token segments
             ("qwen3-moe-30b-a3b", "depth", TRAIN_B, TRAIN_S, None),
             # form (a): each 2,048-token segment one routing group
             ("qwen3-moe-30b-a3b", "depth", 2, 4096, 1),
             ("deepseek-v3-671b", "dense", TRAIN_B, TRAIN_S, None))


def seq_split_cfg(name: str, cut: str):
    """9f's config of ``name``: :func:`depth_cut`'s, or with ``"dense"``
    deepseek-v3 cut to its one leading dense layer (MLA and the dense
    SwiGLU of ``d_ff_dense`` at full width, no MoE stack)."""
    import dataclasses
    if cut == "depth":
        return depth_cut(name)
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=1, d_ff=cfg.moe.d_ff_dense,
                               moe=None)


def took(what: str, t0: float) -> None:
    """Print the seconds since ``t0`` that ``what`` took."""
    print(f"  {what} took {time.perf_counter() - t0:.1f} s", flush=True)


def timed_runs(fn, n: int = 3) -> list:
    """Host seconds of ``n`` calls of ``fn``, each ending in a sync."""
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def seq_split_step(name: str, cut: str, b: int, s: int,
                   micro: int | None, meshes: dict, dev: torch.device,
                   smi: str) -> None:
    """9f. One train step of ``name`` (``seq_split_cfg(name, cut)``, B =
    ``b``, S = ``s``, ``micro`` microbatches or the strategy's) as the
    last segment's rank of the fake group: counted on meta and on the
    card from the rank's own blocks (FLOPs equal, peak within PEAK_TOL),
    no kernel launched, 3 warm runs and the card's busy share; then the
    plain whole-sequence step of the same config on the card, counted
    and timed the same way."""
    import dataclasses
    from repro_torch.configs import SHAPES
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.tensor_parallel import seq_dim
    from repro_torch.launch.dryrun import cell_specs
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import init_opt_state, make_train_step

    cfg = seq_split_cfg(name, cut)
    strat = pick_strategy(cfg, SHAPES["train_4k"], multi_pod=True,
                          override_profile="fsdp", override_micro=micro)
    expect(strat.name == "fsdp" and strat.logical_rules["seq"] == "pod",
           f"{name} multi-pod train_4k: {strat}")
    hp = dataclasses.replace(strat.hparams, loss_chunk=min(512, s))
    rules = {d: make_mesh_rules(m, strat) for d, m in meshes.items()}
    dim = seq_dim(cfg, rules["cuda"], ("data", "model"), s)
    expect(dim == "pod", f"{name}: the sequences split over {dim}")
    shape = ShapeSpec("seq_split", s, b, "train")
    fns = counters()

    def args(d: str, where: torch.device):
        # the rank's blocks of the parameters and Adam's state; the batch
        # plain and global (every rank's), as the training CLI passes it
        params, opt, _ = rank_blocks(
            cell_specs(cfg, shape, rules[d], strat), meshes[d], where,
            None if where.type == "meta" else
            torch.Generator(where).manual_seed(0))
        batch = synthetic_batch(cfg, b, s, 0, 0, "cpu")
        return params, opt, {k: v.to(where) for k, v in batch.items()}

    for f in fns.values():
        f.launches = 0
    _, meta = analyze(make_train_step(cfg, rules["cpu"], hp),
                      *args("cpu", torch.device("meta")))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    split_args = args("cuda", dev)
    step = make_train_step(cfg, rules["cuda"], hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    card = analyze(step, *split_args)[1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    secs = timed_runs(lambda: step(*split_args))
    busy = device_breakdown(lambda: step(*split_args), min(secs),
                            by_op=False)
    counts = {k: f.launches for k, f in fns.items()}
    held = sum(t.to_local().nbytes for _, t in leaves(split_args[0]))
    del split_args
    torch.cuda.empty_cache()
    ratio = meta["peak_bytes"] / peak
    expect(meta["flops"] == card["flops"],
           f"{name} sequence-split step: FLOPs on meta "
           f"{meta['flops']:.6e} vs on the card {card['flops']:.6e}")
    expect(abs(ratio - 1) <= PEAK_TOL,
           f"{name} sequence-split step: predicted peak "
           f"{meta['peak_bytes'] / 2**30:.3f} GiB vs the card's "
           f"{peak / 2**30:.3f} GiB (ratio {ratio:.4f})")
    expect(not any(counts.values()),
           f"{name} sequence-split step launched {counts}")

    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    plain_args = (params, init_opt_state(params, hp),
                  synthetic_batch(cfg, b, s, 0, 0, dev))
    plain = make_train_step(cfg, None, hp)
    whole = analyze(plain, *plain_args)[1]
    plain_secs = timed_runs(lambda: plain(*plain_args))
    plain_busy = device_breakdown(lambda: plain(*plain_args),
                                  min(plain_secs), by_op=False)
    del params, plain_args
    torch.cuda.empty_cache()
    seg = s // SEQ_RANKS
    depth = (f"cut to {cfg.n_layers} layers" if cut == "depth" else
             "cut to its leading dense layer")
    print(f"  {name} train step ({depth}, full width, B = {b}, "
          f"S = {s}, {hp.n_micro} microbatches, multi-pod fsdp rules) as "
          f"rank {SEQ_RANKS - 1} of a fake group of {SEQ_RANKS} on a cuda "
          f"({SEQ_RANKS}, 1, 1) pod x data x model mesh: tokens "
          f"[{seg * (SEQ_RANKS - 1)}, {s}) of each sequence, its "
          f"blocks {held / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held on "
          f"the card before it; values not checked); FLOPs meta "
          f"{meta['flops']:.6e} = card {card['flops']:.6e} "
          f"({card['flops'] / whole['flops']:.4f} of the whole-sequence "
          f"step's {whole['flops']:.6e}); predicted peak "
          f"{meta['peak_bytes'] / 2**30:.3f} GiB vs {peak / 2**30:.3f} GiB "
          f"(ratio {ratio:.4f}); launches {counts}; warm ms "
          + ", ".join(f"{t * 1e3:.1f}" for t in secs)
          + f" against the plain whole-sequence step's "
          + ", ".join(f"{t * 1e3:.1f}" for t in plain_secs)
          + f"; split: {busy}; plain: {plain_busy}; card: {smi}")


def seq_split_steps(dev: torch.device, smi: str) -> None:
    """9f. :func:`seq_split_step` of each of SEQ_SPLIT, as rank
    SEQ_RANKS - 1 of one fake group; the seconds they took."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=SEQ_RANKS - 1,
                            world_size=SEQ_RANKS)
    try:
        meshes = {d: init_device_mesh(d, (SEQ_RANKS, 1, 1),
                                      mesh_dim_names=("pod", "data",
                                                      "model"))
                  for d in ("cpu", "cuda")}
        for case in SEQ_SPLIT:
            t_case = time.perf_counter()
            seq_split_step(*case, meshes, dev, smi)
            took(f"9f's {case[0]} at B = {case[2]}, S = {case[3]}", t_case)
    finally:
        dist.destroy_process_group()
    print(f"  phase 9's sequence-split steps took "
          f"{time.perf_counter() - t0:.1f} s")


# phase 9i: each prompt split over the tensor axis (``Plan.sp``, the dry
# run's --seq-shard): rank SP_RANKS - 1 (the last segment, whose queries
# see every key) of a fake group on a (1, SP_RANKS) data x model mesh
# under prefill_32k's tp_ep rules with seq -> "model"; (arch, layers or
# None: full depth, batch, tokens, the kernel its prefill launches once a
# layer or None)
SP_RANKS = 16
SP_PREFILLS = (("qwen2-1.5b", None, 2, 32768, None),
               ("stablelm-12b", 4, 2, 32768, None),
               ("rwkv6-3b", 2, 2, 8192, "wkv6"),
               ("zamba2-7b", 6, 2, 8192, "ssd"))
SP_WARM = 1           # 9i's warm runs a case
# the leaves of these layers gathered whole over the tensor axis, held
# whole over "model" in the value checks: rwkv6-3b's time mix, whose 40
# heads 16 ranks do not divide, besides WHOLE_OVER_MODEL's
SP_WHOLE = (r"(mamba/(in_proj|conv_w|conv_b)|channel_mix/wr"
            r"|time_mix/[\w/]+)$")


@contextlib.contextmanager
def loopback_collectives():
    """The tensor-parallel groups' all-gather and reduce-scatter as
    loopbacks on this one rank, for a fake group's value checks (its
    collectives leave their outputs unwritten): every rank's block is
    this rank's, the sum's block this rank's own term. Values, not
    counts: runs under it are not analyzed."""
    from repro_torch.distributed.tensor_parallel import Group
    ag, rs = Group.all_gather, Group.reduce_scatter
    Group.all_gather = lambda self, t: t.unsqueeze(0).expand(
        self.size, *t.shape).contiguous()
    Group.reduce_scatter = lambda self, t: t[self.index].clone()
    try:
        yield
    finally:
        Group.all_gather, Group.reduce_scatter = ag, rs


def sp_prefill(cfg, layers, batch: int, seq_len: int, kernel,
               meshes: dict, rules: dict, strat, dev: torch.device,
               smi: str, meta: dict) -> dict:
    """9i. One prefill of ``cfg`` (cut to ``layers`` where given) as the
    last segment's rank: the chunked run (``kernels=False``) counted on
    the card from the rank's own blocks against ``meta``, its count on
    meta (FLOPs equal, peak within PEAK_TOL), with no
    kernel launched; where the arch has a kernel, the kernel run with the
    counts set to 0 just before and read just after (one launch a
    layer), every recurrent layer of it held to the chunked path on the
    same input within LM_TOL (:func:`layerwise`) and each launch's y and
    state to the chunked form on the same inputs within KERNEL_REL of
    the chunked output's largest magnitude (:func:`against_chunked`;
    token ids in the rank's block of the vocabulary and the gathers made
    loopbacks, so that every input is defined and none is zero); ms (SP_WARM warm runs), busy share
    (the card traced alone) and the peak, and the seconds of the case
    and of its analyses and trace. Returns the launches."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import batch_split, mesh_rules
    from repro_torch.distributed.tensor_parallel import plan_for
    from repro_torch.train.steps import batch_shard, make_prefill_step

    t0 = time.perf_counter()
    name = cfg.name
    fns = counters()
    for f in fns.values():
        f.launches = 0
    r = fake_rank_prefill(cfg, batch, meshes, rules, strat, dev,
                          kernels=False, whole=SP_WHOLE if kernel else None,
                          seq_len=seq_len, warm=0 if kernel else SP_WARM,
                          meta=meta)
    ratio = check_fake_counts(f"{name} sequence-split", r)
    chunked = {k: f.launches for k, f in fns.items()}
    expect(not any(chunked.values()),
           f"{name} sequence-split chunked prefill launched {chunked}")
    split = batch_shard({"tokens": torch.zeros((batch, seq_len),
                                               dtype=torch.int32)},
                        rules["cpu"], cfg, prefill=True)[1]
    with mesh_rules(rules["cpu"]), batch_split(split):
        plan = plan_for(cfg)
    expect(plan.sp is not None and plan.sp.index == SP_RANKS - 1
           and split.segment == seq_len // SP_RANKS,
           f"{name}: the prompt not split over model ({plan}, {split})")
    paths = (("attention heads", plan.attn), ("family heads", plan.heads),
             ("vocab", plan.vocab))
    step, args = r["step"], r["args"]
    launched = {k: 0 for k in fns}
    detail = "no kernel"
    if kernel:
        # token ids in this rank's block of the vocabulary, so that the
        # loopback's own term of the embedding's partial sums is their
        # sum (ids outside it embed to zeros here, and every layer would
        # see a zero stream)
        rows = cfg.vocab_size // SP_RANKS
        expect(plan.vocab and rows * SP_RANKS == cfg.vocab_size,
               f"{name}: the vocabulary not split in {SP_RANKS} ({plan})")
        tokens = args[1]["tokens"]
        if isinstance(tokens, DTensor):
            tokens = tokens.to_local()
        tokens.random_((SP_RANKS - 1) * rows, SP_RANKS * rows,
                       generator=torch.Generator(dev).manual_seed(1))
        step = make_prefill_step(cfg, rules["cuda"])
        for f in fns.values():
            f.launches = 0
        with loopback_collectives(), against_chunked(cfg) as site:
            worst, _, _ = layerwise(cfg, lambda: step(*args))
            torch.cuda.synchronize()
        launched = {k: f.launches for k, f in fns.items()}
        want = {k: (cfg.n_layers if k == kernel else 0) for k in fns}
        expect(launched == want, f"{name} sequence-split prefill launched "
               f"{launched}, want {want}")
        detail = (f"{kernel} launched {launched[kernel]} times (token ids "
                  f"in the rank's vocabulary block, gathers as loopbacks); "
                  f"every layer of the kernel run vs the chunked path on "
                  f"the same input (limit rtol = atol = {LM_TOL['rtol']}): "
                  + ", ".join(f"{k} max |err| {e:.3g}"
                              f"{'' if good else ' FAIL'}"
                              for k, (e, good) in worst.items())
                  + f"; each launch's own outputs vs the chunked form on "
                  f"the same inputs (limit max |err| <= {KERNEL_REL} x max "
                  f"|chunked|): " + ", ".join(
                      f"{k} max |err| / max |chunked| {share:.3g} over {n} "
                      f"calls (max |chunked| {lo:.3g} or more)"
                      for k, (share, n, lo) in site.items()))
        expect(all(good for _, good in worst.values()),
               f"{name}: a layer of the sequence-split kernel prefill "
               f"differs from the chunked path")
        expect(sorted(site) == ["state", "y"]
               and all(n == cfg.n_layers and share <= KERNEL_REL
                       for share, n, _ in site.values()),
               f"{name}: the sequence-split prefill's {kernel} differs from "
               f"its chunked form: {site}")
    secs = timed_runs(lambda: step(*args), SP_WARM) if kernel else r["secs"]
    t1 = time.perf_counter()
    busy = device_breakdown(lambda: step(*args), min(secs), by_op=False)
    t_trace = time.perf_counter() - t1
    depth = f"cut to {cfg.n_layers} layers" if layers else "full depth"
    seg = seq_len // SP_RANKS
    print(f"  {name} prefill (full width, {depth}, B = {batch}, S = "
          f"{seq_len}, prefill_32k's rules {strat.name} with seq -> model) "
          f"as rank {SP_RANKS - 1} of a fake group of {SP_RANKS} on a cuda "
          f"(1, {SP_RANKS}) mesh: tokens [{seq_len - seg}, {seq_len}) of "
          f"each prompt; split "
          + ", ".join(f"{k} {v}" for k, v in paths)
          + f"; its blocks {r['held'] / 2**30:.2f} GiB; FLOPs meta "
          f"{r['meta']['flops']:.6e} = card {r['card']['flops']:.6e} over "
          f"{r['card']['ops']} ops; predicted peak "
          f"{r['meta']['peak_bytes'] / 2**30:.3f} GiB vs "
          f"{r['peak'] / 2**30:.3f} GiB (ratio {ratio:.4f}); collectives "
          + ", ".join(f"{k} {v['bytes']:.4g} B" for k, v in
                      r["card"]["coll"].items()
                      if isinstance(v, dict) and v["count"])
          + f"; {detail}; warm ms " + ", ".join(f"{t * 1e3:.1f}"
                                                for t in secs)
          + f"; {busy}; the case took {time.perf_counter() - t0:.1f} s "
          f"(analysis on the card {r['t_card']:.1f}, trace {t_trace:.1f}); "
          f"card: {smi}")
    del r, step, args
    torch.cuda.empty_cache()
    return launched


def sp_case(name: str, layers) -> tuple:
    """(cfg, strategy) of a SP_PREFILLS case: ``name`` cut to ``layers``
    (full depth where None) under its prefill_32k strategy (tp_ep) with
    seq -> "model"."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.strategy import pick_strategy
    cfg = get_config(name)
    strat = pick_strategy(cfg, SHAPES["prefill_32k"])
    expect(strat.name == "tp_ep", f"{name} prefill_32k: {strat}")
    strat.logical_rules["seq"] = "model"
    return (dataclasses.replace(cfg, n_layers=layers) if layers else cfg,
            strat)


def sp_meta_counts() -> None:
    """9i's meta side, in the process :func:`spawn_sp_meta` starts: each
    SP_PREFILLS case's :func:`meta_count` as rank SP_RANKS - 1 of a fake
    group on a cpu (1, SP_RANKS) mesh. Prints {arch: {"flops",
    "peak_bytes", "ops", "t_meta"}} as its one line of output."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.strategy import make_mesh_rules

    dist.init_process_group("fake", store=FakeStore(), rank=SP_RANKS - 1,
                            world_size=SP_RANKS)
    counts = {}
    try:
        mesh = init_device_mesh("cpu", (1, SP_RANKS),
                                mesh_dim_names=("data", "model"))
        for name, layers, batch, seq_len, kernel in SP_PREFILLS:
            cfg, strat = sp_case(name, layers)
            meta = meta_count(cfg, batch, mesh, make_mesh_rules(mesh, strat),
                              strat, SP_WHOLE if kernel else None, seq_len)
            counts[name] = {k: meta[k] for k in ("flops", "peak_bytes",
                                                  "ops", "t_meta")}
    finally:
        dist.destroy_process_group()
    print(json.dumps(counts))


def spawn_sp_meta() -> subprocess.Popen:
    """:func:`sp_meta_counts` in a process of its own, started as phase 9
    starts, so that 9i's meta counts run on another of the host's cores
    beside the phase's earlier steps (one thread: meta computes nothing);
    :func:`seq_tensor_prefills` reads its output. Killed at exit if it
    still runs."""
    import os
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']"
            "; import chip_smoke; chip_smoke.sp_meta_counts()")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT)],
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1",
                                     MKL_NUM_THREADS="1"))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def seq_tensor_prefills(dev: torch.device, smi: str,
                        sp_meta: subprocess.Popen) -> dict:
    """9i. :func:`sp_prefill` of each of SP_PREFILLS as rank SP_RANKS - 1
    of one fake group, its meta counts read from ``sp_meta``
    (:func:`spawn_sp_meta`); the seconds they took. Returns the kernels'
    launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.strategy import make_mesh_rules

    t0 = time.perf_counter()
    out, _ = sp_meta.communicate(timeout=900)
    expect(sp_meta.returncode == 0,
           f"9i's meta counts exited {sp_meta.returncode}")
    metas = json.loads(out.strip().splitlines()[-1])
    t_wait = time.perf_counter() - t0
    launched: dict = {}
    dist.init_process_group("fake", store=FakeStore(), rank=SP_RANKS - 1,
                            world_size=SP_RANKS)
    try:
        meshes = {d: init_device_mesh(d, (1, SP_RANKS),
                                      mesh_dim_names=("data", "model"))
                  for d in ("cpu", "cuda")}
        for name, layers, batch, seq_len, kernel in SP_PREFILLS:
            cfg, strat = sp_case(name, layers)
            rules = {d: make_mesh_rules(m, strat) for d, m in meshes.items()}
            got = sp_prefill(cfg, layers, batch, seq_len, kernel, meshes,
                             rules, strat, dev, smi, metas[name])
            launched = {k: launched.get(k, 0) + n for k, n in got.items()}
    finally:
        dist.destroy_process_group()
    print(f"  phase 9's sequence-split prefills (9i) took "
          f"{time.perf_counter() - t0:.1f} s, of which {t_wait:.1f} s "
          f"waiting for their meta counts (made in a process of their own "
          f"beside the phase's earlier steps: "
          + ", ".join(f"{k} {m['t_meta']:.1f} s" for k, m in metas.items())
          + ")")
    return launched


# phase 9's expert-parallel runs under tp_ep_full: rank 0 of a fake group
# on a FULLEP_MESH data x model mesh, FULLEP_ARCH at full width cut to
# FULLEP_LAYERS layers (its 3 dense, then MoE), S = FULLEP_S tokens
FULLEP_ARCH, FULLEP_LAYERS, FULLEP_MESH, FULLEP_S = ("deepseek-v3-671b", 5,
                                                     (2, 4), 1024)
# (run, batch): two prefills, one with every routing group inside the
# rank's data shard (the exchange) and one whose group spans both
# shards, and one train step's loss and gradients
FULLEP_RUNS = (("prefill", 4), ("prefill", 2), ("train", 4))
# the counted all-gather bytes of the same runs on meta before the
# exchange, when every MoE layer gathered its expert stacks over "data"
# (fullep_counts_on_meta() with PYTHONPATH at that tree's src)
FULLEP_BEFORE = {("prefill", 4): 69886140416, ("prefill", 2): 69943301120,
                 ("train", 4): 185326510080}


def fullep_setup() -> tuple:
    """(cfg, strategy, train hparams) of phase 9's tp_ep_full runs; the
    train step takes one microbatch."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.strategy import pick_strategy
    cfg = dataclasses.replace(get_config(FULLEP_ARCH),
                              n_layers=FULLEP_LAYERS)
    strat = pick_strategy(cfg, SHAPES["train_4k"],
                          override_profile="tp_ep_full")
    hp = dataclasses.replace(strat.hparams, n_micro=1,
                             loss_chunk=min(512, FULLEP_S))
    return cfg, strat, hp


def fullep_call(kind: str, batch: int, cfg, strat, hp, rules, mesh,
                where: torch.device, gen=None) -> tuple:
    """(the step, its arguments) of one of FULLEP_RUNS from the rank's
    own blocks on ``where`` (meta, or made from ``gen``); the train
    step's batch plain and global, as the training CLI passes it."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import cell_specs
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train.steps import make_prefill_step, \
        ruled_loss_and_grads
    shape = ShapeSpec("fullep", FULLEP_S, batch, kind)
    specs = cell_specs(cfg, shape, rules, strat)
    if kind == "prefill":
        return (make_prefill_step(cfg, rules, kernels=False),
                rank_blocks(specs, mesh, where, gen))
    data = synthetic_batch(cfg, batch, FULLEP_S, 0, 0, "cpu")
    return ((lambda p, b: ruled_loss_and_grads(p, cfg, b, hp, rules)),
            (rank_blocks(specs[0], mesh, where, gen),
             {k: v.to(where) for k, v in data.items()}))


def fullep_counts_on_meta() -> dict:
    """The counted runs of FULLEP_RUNS on meta as rank 0 of a fake group
    on a "cpu" FULLEP_MESH mesh, no card: {run: {"flops", "peak",
    collective kind: bytes}}. Run against the tree before the exchange,
    this gives FULLEP_BEFORE."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.strategy import make_mesh_rules
    cfg, strat, hp = fullep_setup()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FULLEP_MESH[0] * FULLEP_MESH[1])
    out = {}
    try:
        mesh = init_device_mesh("cpu", FULLEP_MESH,
                                mesh_dim_names=("data", "model"))
        rules = make_mesh_rules(mesh, strat)
        for kind, batch in FULLEP_RUNS:
            step, args = fullep_call(kind, batch, cfg, strat, hp, rules,
                                     mesh, torch.device("meta"))
            _, acc = analyze(step, *args)
            out[(kind, batch)] = {
                "flops": acc["flops"], "peak": acc["peak_bytes"],
                **{k: v["bytes"] for k, v in acc["coll"].items()
                   if isinstance(v, dict)}}
    finally:
        dist.destroy_process_group()
    return out


def fullep_all_to_all(cfg, kind: str, batch: int, hp) -> tuple:
    """(the all-to-all bytes rank 0 of FULLEP_MESH sends in one of
    FULLEP_RUNS, the formula as text). Where every routing group lies in
    the rank's data shard, each MoE layer exchanges a bf16 buffer of
    n_data x E_loc x G x C slots of D values twice (to the experts and
    back); a train step does so three times (the forward, the remat'd
    recompute and the backward). Where a group spans the shards, no
    exchange."""
    from repro_torch.models.moe import _pick_group_size
    mo = cfg.moe
    n_data, n_model = FULLEP_MESH
    tokens = batch // n_data * FULLEP_S                # the rank's
    tg = _pick_group_size(batch * FULLEP_S)
    if tokens % tg:
        return 0, "0 (a routing group spans the data shards)"
    cap = max(int(mo.capacity_factor * tg * mo.top_k / mo.n_experts), 4)
    e_loc = mo.n_experts // (n_data * n_model)
    passes = 2 if kind == "prefill" else 6 if hp.remat else 4
    n_moe = cfg.n_layers - mo.n_dense_layers
    n = passes * n_moe * n_data * e_loc * (tokens // tg) * cap \
        * cfg.d_model * 2
    return n, (f"{passes} x {n_moe} MoE layers x {n_data} x {e_loc} "
               f"experts x {tokens // tg} groups x {cap} slots x "
               f"{cfg.d_model} x 2 B = {n}")


def fullep_steps(dev: torch.device, smi: str) -> None:
    """9g. FULLEP_RUNS as rank 0 of a fake group on a "cuda" FULLEP_MESH
    mesh under ``train_4k``'s ``tp_ep_full`` rules: each counted on meta
    and on the card from the rank's own blocks (FLOPs equal, peak within
    PEAK_TOL), no kernel launched (the counts set to 0 just before and
    read just after each run), the all-to-all bytes equal to
    :func:`fullep_all_to_all`'s, the all-gather bytes below
    FULLEP_BEFORE's by at least the expert stacks' (passes x MoE layers x
    3 x E x D x F x 2 B: the stacks gathered whole before); 3 warm runs
    and the card's busy share. The fake group's collectives write
    nothing, so no value is checked (the CPU tests hold the numbers)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.tensor_parallel import mesh_plan
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.strategy import make_mesh_rules

    t_start = time.perf_counter()
    cfg, strat, hp = fullep_setup()
    mo = cfg.moe
    n_data, n_model = FULLEP_MESH
    e_loc = mo.n_experts // (n_data * n_model)
    fns = counters()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_data * n_model)
    try:
        meshes = {d: init_device_mesh(d, FULLEP_MESH,
                                      mesh_dim_names=("data", "model"))
                  for d in ("cpu", "cuda")}
        rules = {d: make_mesh_rules(m, strat) for d, m in meshes.items()}
        plan = mesh_plan(cfg, rules["cuda"])
        expect(plan.a2a is not None and plan.a2a.dim == "data"
               and plan.ep is not None and plan.ep.dim == "model",
               f"{FULLEP_ARCH} tp_ep_full on {FULLEP_MESH}: {plan}")
        for kind, batch in FULLEP_RUNS:
            name = f"{FULLEP_ARCH} {kind} B = {batch}"
            step, args = fullep_call(kind, batch, cfg, strat, hp,
                                     rules["cpu"], meshes["cpu"],
                                     torch.device("meta"))
            t0 = time.perf_counter()
            _, meta = analyze(step, *args)
            t_meta = time.perf_counter() - t0
            del args
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            step, args = fullep_call(kind, batch, cfg, strat, hp,
                                     rules["cuda"], meshes["cuda"], dev,
                                     torch.Generator(dev).manual_seed(0))
            for f in fns.values():
                f.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            out, card = analyze(step, *args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            counts = {k: f.launches for k, f in fns.items()}
            del out
            secs = timed_runs(lambda: step(*args))
            busy = device_breakdown(lambda: step(*args), min(secs))
            params = args[0]
            held = sum(t.to_local().nbytes for _, t in leaves(params))
            del args, params
            torch.cuda.empty_cache()

            ratio = meta["peak_bytes"] / peak
            a2a, formula = fullep_all_to_all(cfg, kind, batch, hp)
            coll = {k: v["bytes"] for k, v in card["coll"].items()
                    if isinstance(v, dict)}
            passes = 2 if kind == "train" else 1
            n_moe = cfg.n_layers - mo.n_dense_layers
            stacks = passes * n_moe * 3 * mo.n_experts * cfg.d_model \
                * mo.d_ff_expert * 2
            before = FULLEP_BEFORE[(kind, batch)]
            expect(meta["flops"] == card["flops"],
                   f"{name}: FLOPs on meta {meta['flops']:.6e} vs on the "
                   f"card {card['flops']:.6e}")
            expect(abs(ratio - 1) <= PEAK_TOL,
                   f"{name}: predicted peak {meta['peak_bytes'] / 2**30:.3f}"
                   f" GiB vs the card's {peak / 2**30:.3f} GiB (ratio "
                   f"{ratio:.4f})")
            expect(not any(counts.values()), f"{name} launched {counts}")
            expect(coll["all-to-all"] == a2a,
                   f"{name}: all-to-all {coll['all-to-all']:.0f} B vs the "
                   f"formula {formula}")
            expect(before - coll["all-gather"] >= stacks,
                   f"{name}: all-gather {coll['all-gather']:.0f} B, before "
                   f"{before} B, not below by the stacks' {stacks} B")
            print(f"  {name} (S = {FULLEP_S}, full width cut to "
                  f"{cfg.n_layers} layers, {e_loc} whole experts of "
                  f"{mo.n_experts} a rank) as rank 0 of a "
                  f"fake group of {n_data * n_model} on a cuda {FULLEP_MESH} "
                  f"data x model mesh, train_4k's tp_ep_full rules (values "
                  f"not checked): its blocks {held / 2**30:.2f} GiB; FLOPs "
                  f"meta {meta['flops']:.6e} = card {card['flops']:.6e}; "
                  f"predicted peak {meta['peak_bytes'] / 2**30:.3f} GiB vs "
                  f"{peak / 2**30:.3f} GiB (ratio {ratio:.4f}); launches "
                  f"{counts}; all-to-all {coll['all-to-all']:.0f} B = "
                  f"{formula}; all-gather {coll['all-gather']:.0f} B, "
                  f"before {before} B (the expert stacks {stacks} B); "
                  f"all-reduce {coll['all-reduce']:.0f} B, reduce-scatter "
                  f"{coll['reduce-scatter']:.0f} B; warm ms "
                  + ", ".join(f"{t * 1e3:.1f}" for t in secs)
                  + f"; meta analysis {t_meta:.1f} s; {busy}; card: {smi}")
    finally:
        dist.destroy_process_group()
    print(f"  phase 9's tp_ep_full runs took "
          f"{time.perf_counter() - t_start:.1f} s")


DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", "single"),
                ("stablelm-12b", "prefill_32k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"),
                ("zamba2-7b", "long_500k", "single"))
PEAK_TOL = 0.15      # predicted peak against the card's, relative


def predict_on_card(dev: torch.device) -> None:
    """10a. The plain qwen2-1.5b step of phase 8's cell analysed on meta
    and then run on the card under the same analysis."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)

    cfg = get_config(TRAIN_LM)
    hp = TrainHParams(lr=3e-4, loss_chunk=min(512, TRAIN_S))
    step = make_train_step(cfg, None, hp)
    batch = synthetic_batch(cfg, TRAIN_B, TRAIN_S, 0, 0, "cpu")
    params = M.init_model(cfg, None, "meta")
    t0 = time.perf_counter()
    _, meta = analyze(step, params, init_opt_state(params, hp),
                      tree_map(lambda t: t.to("meta"), batch))
    t_meta = time.perf_counter() - t0
    del params

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = init_opt_state(params, hp)
    batch = tree_map(lambda t: t.to(dev), batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, card = analyze(step, params, opt, batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    params, opt, loss, dt = step_timed(step, params, opt, batch)
    del params, opt, batch
    torch.cuda.empty_cache()
    ratio = meta["peak_bytes"] / peak
    expect(meta["flops"] == card["flops"],
           f"FLOPs on meta {meta['flops']:.6e} vs on the card "
           f"{card['flops']:.6e}")
    expect(abs(ratio - 1) <= PEAK_TOL,
           f"predicted peak {meta['peak_bytes'] / 2**30:.3f} GiB vs the "
           f"card's {peak / 2**30:.3f} GiB (ratio {ratio:.4f})")
    expect(np.isfinite(loss), f"{TRAIN_LM} loss {loss}")
    print(f"dryrun {TRAIN_LM} plain step (B = {TRAIN_B}, S = {TRAIN_S}, "
          f"phase 8's hparams): FLOPs meta {meta['flops']:.6e} = card "
          f"{card['flops']:.6e} ({meta['ops']} / {card['ops']} ops); HBM "
          f"bytes meta {meta['bytes']:.6e} / card {card['bytes']:.6e}; "
          f"predicted peak {meta['peak_bytes'] / 2**30:.3f} GiB vs max "
          f"memory allocated {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before (ratio {ratio:.4f}); "
          f"modeled (H100 datasheet) t_compute "
          f"{meta['flops'] / PEAK_FLOPS * 1e3:.1f} ms, t_memory "
          f"{meta['bytes'] / HBM_BW * 1e3:.1f} ms vs a warm step "
          f"{dt * 1e3:.1f} ms (host clock ending in a sync); analysis "
          f"{t_meta:.1f} s on meta, {t_card:.1f} s on the card")


def dryrun_cli() -> None:
    """10b. ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELLS, as
    subprocesses started together that see no card."""
    import os
    import tempfile
    from repro_torch.launch.dryrun import stand_in_bytes

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for arch, shape, mesh in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out]
            procs.append((time.perf_counter(), subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for (arch, shape, mesh), (t0, p) in zip(DRYRUN_CELLS, procs):
            try:
                stdout, stderr = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
            secs = time.perf_counter() - t0
            path = Path(out) / f"{arch}_{shape}_{mesh}.json"
            expect(p.returncode == 0 and path.exists(),
                   f"dryrun {arch} {shape} {mesh}: exit {p.returncode}\n"
                   f"{stdout[-2000:]}\n{stderr[-4000:]}")
            r = json.loads(path.read_text())
            want = stand_in_bytes(arch, shape, mesh)
            mem, rf = r["memory"], r["roofline"]
            expect(mem["argument_bytes"] == want,
                   f"dryrun {arch} {shape} {mesh}: argument bytes "
                   f"{mem['argument_bytes']} vs the stand-ins' {want}")
            kept = json.loads((ROOT / "results" / "dryrun_torch" /
                               path.name).read_text())
            expect(r["cost"]["flops_per_device"]
                   == kept["cost"]["flops_per_device"],
                   f"dryrun {arch} {shape} {mesh}: FLOPs "
                   f"{r['cost']['flops_per_device']:.6e} vs the committed "
                   f"{kept['cost']['flops_per_device']:.6e}")
            coll = ", ".join(f"{k} {v['bytes'] / 2**30:.2f} GiB"
                             for k, v in r["collectives"].items()
                             if isinstance(v, dict) and v["count"])
            print(f"  dryrun {arch} x {shape} x {mesh} ({r['chips']} cards, "
                  f"{r['strategy']}): {secs:.1f} s (trace {r['trace_s']} "
                  f"s); arguments {mem['argument_bytes'] / 2**30:.3f} GiB "
                  f"= the stand-ins'; peak {mem['peak_bytes'] / 2**30:.2f} "
                  f"GiB per card (committed "
                  f"{kept['memory']['peak_bytes'] / 2**30:.2f}); FLOPs "
                  f"{r['cost']['flops_per_device']:.3e} = the committed"
                  f"; collectives {coll or 'none'}; {rf['dominant']}-bound "
                  f"(modeled), useful-flop ratio "
                  f"{rf['useful_flop_ratio']:.3f}")


def phase_dryrun(dev: torch.device, smi: str) -> None:
    """10. The dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``):
    (a) the predicted peak and FLOPs against the card; (b) the CLI on
    four production cells. The six kernels' counts are set to 0 just
    before and read just after: the dry run launches none (``analyze``
    raises if one moves)."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    predict_on_card(dev)
    dryrun_cli()
    counts = {k: f.launches for k, f in fns.items()}
    expect(not any(counts.values()), f"the dry-run phase launched {counts}")
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}; card: {smi}")


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
    launches = dict.fromkeys(SNN_KERNELS, 0)
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
        for k, n in _counted_tiers(prog, ext, ref, method, "run").items():
            launches[k] += n
    print(f"back end strategies: OT depth {depths}; consecutive and "
          f"load_balance verify clean and run B={SERVE_BATCH} "
          f"T={TIMESTEPS} on the fused tier (one fused_run a run) and the "
          f"lif tier ({TIMESTEPS} launches a run), bit-exact with the "
          f"reference tier and the golden's recorded io")
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
        before = snn_counts()
        try:
            registry.register(code, mutant, verify=True, precompile=policy,
                              timesteps=TIMESTEPS)
            refused = ""
        except ValueError as e:
            refused = str(e)
        expect(code in refused and code not in registry
               and not mutant._engines and snn_counts() == before,
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


SNN_KERNELS = ("fused_run", "fused_step", "lif_update_int")


def tier_launches(engine, runs: int, t_steps: int) -> dict[str, int]:
    """The SNN kernels' launches for ``runs`` runs of ``t_steps`` steps on
    ``engine``'s tier: the fused tier launches one ``fused_run`` a run
    where its shape rule says "run" and one ``fused_step`` a step where
    it says "step"; the lif tier one ``lif_update_int`` a step."""
    want = dict.fromkeys(SNN_KERNELS, 0)
    if engine.fused_path == "run":
        want["fused_run"] = runs
    elif engine.fused_path == "step":
        want["fused_step"] = runs * t_steps
    else:
        want["lif_update_int"] = runs * t_steps
    return want


def snn_counts() -> dict[str, int]:
    kernels = counters()
    return {k: kernels[k].launches for k in SNN_KERNELS}


def zero_snn_counts() -> None:
    kernels = counters()
    for k in SNN_KERNELS:
        kernels[k].launches = 0


def _counted_tiers(prog, ext, want, what: str, path: str,
                   tiers=("fused", "lif")) -> dict[str, int]:
    """Run ``prog`` on each kernel tier with the counts set to 0 just
    before and read just after: the fused engine's shape rule must give
    ``path`` ("run" for an SHD-shaped plane, "step" for one that does not
    fit a cluster), and each tier exactly the launches ``tier_launches``
    gives for one run (one ``fused_run``, or T ``fused_step`` on the
    step path; T ``lif_update_int``) and none of the others, bit-exact
    with ``want``. Returns the launches by kernel."""
    from repro_torch.core import ExecutionSpec
    launches = dict.fromkeys(SNN_KERNELS, 0)
    steps = ext.shape[-2]
    for tier in tiers:
        spec = ExecutionSpec(kernel=tier)
        engine = prog.engine(spec)
        if tier == "fused":
            expect(engine.fused_path == path, f"{what}: fused path "
                   f"{engine.fused_path!r}, want {path!r}")
        expected = tier_launches(engine, 1, steps)
        zero_snn_counts()
        got = prog.run(ext, spec)
        n = snn_counts()
        expect(n == expected, f"{what} {tier}: launches {n}, want "
                              f"{expected}")
        for k, c in n.items():
            launches[k] += c
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

    launches = dict.fromkeys(SNN_KERNELS, 0)

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
        add(_counted_tiers(shd, ext, want, "compiled SHD", "run"))
        print(f"compile shd (host of the card's machine): {shd_s!r} s, "
              f"phases {shd.report.phase_seconds}; arrays and header (but "
              f"for wall times) equal the golden's, content_hash "
              f"{SHD_HASH}; B={SERVE_BATCH} T={TIMESTEPS} on the fused and "
              f"lif tiers bit-exact with the recorded io, fused path "
              f"{shd.engine().fused_path!r} [{smi}]")

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
        add(_counted_tiers(one, ext, ref, "portfolio winner", "run"))
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
        add(_counted_tiers(big, ext_big, ref, "scale", "step",
                           tiers=("fused",)))
        big_path = big.engine(ExecutionSpec(kernel="fused")).fused_path
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
              f"1500 int8, fused path {big_path!r}: "
              f"{tier_launches(big.engine(), 1, TIMESTEPS)}) bit-exact with "
              f"the reference tier; CycleModel on 4 chips (modeled FPGA "
              f"figures, not "
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
    launches = dict.fromkeys(SNN_KERNELS, 0)
    for tier, runner in (("fused", registry.runner("shd")),
                         ("lif", registry.runner(
                             "shd", ExecutionSpec(kernel="lif")))):
        if tier == "lif":                  # warm before the counted run
            runner.precompile(policy.buckets, TIMESTEPS)
        batcher = MicroBatcher(policy, runner=runner, service_model=None)
        engine = program.engine(ExecutionSpec(kernel=tier))
        expect(tier == "lif" or engine.fused_path == "run",
               f"serve: the SHD artifact's fused path is "
               f"{engine.fused_path!r}, want 'run'")
        zero_snn_counts()
        t0 = time.perf_counter()
        res = batcher.drain(arrivals, requests)
        wall = time.perf_counter() - t0
        counts = snn_counts()
        want = tier_launches(engine, len(res.batches), TIMESTEPS)
        kernel = "fused_run" if tier == "fused" else "lif_update_int"
        expect(res.n_served == N_REQUESTS, f"{tier}: {res.n_shed} shed")
        expect(counts == want,
               f"{tier}: launches {counts}, want {want} for "
               f"{len(res.batches)} batches of T = {TIMESTEPS}")
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
        for k, n in counts.items():
            launches[k] += n
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
    once; a two-shard run launches one ``fused_run`` (fused) or T
    ``lif_update_int`` (lif) per shard (the counts set to 0 just before
    each run and read just after)."""
    from repro_torch.core import ExecutionSpec, Program
    from repro_torch.serve import ShardedRunner
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    rng = np.random.default_rng(6)
    reference = ExecutionSpec(kernel="reference")
    cards = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    for tier in ("fused", "lif"):
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
            expected = tier_launches(engine, 2, TIMESTEPS)
            zero_snn_counts()
            got = two.run(ext)
            counts = snn_counts()
            expect(counts == expected, f"sharded {tier} B={b}: launches "
                                       f"{counts}, want {expected}")
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
              f"B={SHARD_BATCHES}, T={TIMESTEPS}, launches per two-shard "
              f"run {tier_launches(engine, 2, TIMESTEPS)}; run at "
              f"B={SERVE_BATCH}, graphed (warm, 5 runs, "
              f"host clock): two shards {run_ms(two.run)!r} ms, one engine "
              f"{run_ms(engine.run)!r} ms")


def phase_async_server() -> None:
    """``AsyncServer`` in engine mode on the registry's precompiled fused
    engine: N_REQUESTS seeded SHD requests submitted concurrently, every
    output bit-exact with ``program.run`` on the same request, every
    stage sum equal to the latency, one ``fused_run`` launched per batch
    (the counts set to 0 just before and read just after). Two
    rounds, each a new server: the first batch of a round runs in a new
    executor thread."""
    import asyncio
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
        zero_snn_counts()
        done, m, wall = asyncio.run(serve())
        launches = snn_counts()
        batches = m["models"]["shd"]["batches"]
        want_n = tier_launches(program.engine(), batches, TIMESTEPS)
        expect(launches == want_n and program.engine().fused_path == "run",
               f"async: launches {launches} for {batches} batches, want "
               f"{want_n}")
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
              f"{batches} batches, launches {launches}; p50 "
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
    bit-exact, one ``fused_run`` (fused; the SHD plane fits) or T
    ``lif_update_int`` (lif) launches counted per replay and per eager
    run, re-``precompile`` a no-op, an uncaptured shape run eagerly; then
    the warm time per timestep at B = SERVE_BATCH, graphed and eager
    interleaved."""
    from repro_torch.core import ExecutionSpec, Program, TorchMappedEngine
    from repro_torch.serve import BatchPolicy
    buckets = BatchPolicy(max_batch=SERVE_BATCH).buckets
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    rng = np.random.default_rng(5)
    reference = ExecutionSpec(kernel="reference")
    for tier in ("fused", "lif"):
        spec = ExecutionSpec(kernel=tier)
        graphed = program.engine(spec)
        eager = TorchMappedEngine(program.graph, program.lowered, spec)
        expect(tier == "lif" or graphed.fused_path == eager.fused_path
               == "run", f"graphs: fused path {graphed.fused_path!r}, want "
                         f"'run'")
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
                expected = tier_launches(graphed, 1, t_steps)
                zero_snn_counts()
                got = graphed.run(ext)
                counts = snn_counts()
                expect(counts == expected, f"{tier} B={b} T={t_steps}: "
                       f"graphed launches {counts}, want {expected}")
                expect(((b, t_steps) in graphed._graphs) == (b != 3),
                       f"{tier}: B={b} T={t_steps} graphed state")
                zero_snn_counts()
                eager_got = eager.run(ext)
                expect(snn_counts() == expected, f"{tier} B={b} "
                       f"T={t_steps}: eager launches {snn_counts()}, want "
                       f"{expected}")
                for what, a, e, r in zip(("spikes", "v_final"), got,
                                         eager_got, want):
                    expect(np.array_equal(a, e) and np.array_equal(a, r),
                           f"{tier} B={b} T={t_steps}: graphed {what} "
                           f"differs from eager or the reference tier")
                expect(np.array_equal(got[2]["packet_counts"],
                                      want[2]["packet_counts"]),
                       f"{tier} B={b} T={t_steps}: packet counts differ")
            print(f"graphs {tier} T={t_steps}: captured buckets {buckets} "
                  f"in {cap_s:.3f} s; graphed runs equal eager and the "
                  f"reference tier at every bucket, launches per replay "
                  f"and per eager run {tier_launches(graphed, 1, t_steps)}; "
                  f"B=3 (not captured) ran eagerly")
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
    program = Program.load(GOLDEN / "tiny_program_v1.npz")
    eng = program.engine(ExecutionSpec(kernel="fused"))
    run_card = eng._run_card

    def syncing(buf):
        run_card(buf)
        buf.v.cpu()                        # a host copy: not capturable

    eng._run_card = syncing
    zero_snn_counts()
    try:
        eng.precompile((2,), 5)
    except RuntimeError as e:
        err = e
    else:
        err = None
    expect(err is not None, "a failed capture did not raise")
    # the warm run before the capture counts; the capture's do not
    expect(not eng._graphs and snn_counts() == tier_launches(eng, 1, 5),
           f"a failed capture left a graph or counted its launches: "
           f"{snn_counts()}")
    eng._run_card = run_card
    torch.cuda.synchronize()
    print(f"failed capture raised {type(err).__name__}: "
          f"{str(err).splitlines()[0][:120]}")


def check_no_internal_neurons() -> None:
    """A program with no internal neuron (4 inputs, no synapse) on the
    card: the fused and lif tiers and the public ``fused_step`` and
    ``fused_run`` give each step's non-zero external spikes as its packet
    count, and launch no kernel (there is no neuron work)."""
    from repro_torch.core import ExecutionSpec, SNNGraph, TorchMappedEngine
    from repro_torch.core.scheduling import LoweredProgram
    from repro_torch.kernels.fused_step import fused_run, fused_step
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
    before = snn_counts()
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
    ext_run = torch.from_numpy(ext.transpose(1, 0, 2).copy()).to(dev)
    _, _, pkts = fused_run(ext_run, torch.zeros((4, 0), dtype=torch.int16,
                                                device=dev), g.lif)
    expect(pkts.tolist() == (ext != 0).sum(-1).T.tolist(),
           f"no internal neurons, fused_run: packets {pkts.tolist()}")
    expect(snn_counts() == before,
           "no internal neurons: a kernel was launched")
    print("no internal neurons (4 inputs, no synapse): the fused and lif "
          "tiers, fused_step and fused_run count each step's non-zero "
          "external spikes, e.g. [[4, 4, 4], [4, 4, 4]] for all-one spikes")


# the paper's two experiments end to end (phase 12): BPTT steps of each
# net on the card, then deploy on the test set in one fused-tier call
PAPER_MNIST_STEPS = 40
PAPER_SHD_STEPS = 20
PAPER_MNIST_IMAGES = 512         # the whole synthetic test set
PAPER_SHD_BATCH = 32
PAPER_PYTHON_SAMPLES = 2         # profiled again on the host simulator


def launches_of(**counts) -> dict:
    """Every kernel's count: ``counts``, and 0 for the others."""
    return {**{name: 0 for name in counters()}, **counts}


def train_counts(steps: int, cfg, per_fwd: tuple, n_eval: int) -> dict:
    """The training path's launches for ``steps`` BPTT steps and
    ``n_eval`` evaluation forwards (phase 6's per-forward counts)."""
    return launches_of(spike_accum=(steps + n_eval) * per_fwd[0],
                       lif_update=(steps + n_eval) * per_fwd[1],
                       lif_update_bwd=steps * bwd_per_step(cfg))


def counted(fn, *args, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` with every kernel's count set to 0 just
    before and read just after (the card synchronised): (result, counts,
    seconds)."""
    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {n: k.launches for n, k in kernels.items()}, seconds


def paper_net(name: str, cfg, hw, qcfg, max_iters: int, train_args: dict,
              ext: np.ndarray, labels: np.ndarray, per_fwd: tuple,
              paper: dict, dev: torch.device, smi: str) -> dict:
    """One experiment end to end through ``launch.mnist_end_to_end``'s
    ``train_stage`` and ``deploy`` on the card, gated; returns each
    kernel's launches over its counted runs."""
    import dataclasses
    from repro_torch.core import ExecutionSpec
    from repro_torch.launch.mnist_end_to_end import deploy, train_stage

    steps = train_args["steps"]
    (params, acc_float, losses), got, t_train = counted(
        train_stage, cfg, train_args["data"], steps, lr=train_args["lr"],
        encode=train_args["encode"], test=train_args["test"], device=dev)
    want = train_counts(steps, cfg, per_fwd, 1)
    expect(got == want, f"{name} training launched {got}, want {want}")
    expect(all(np.isfinite(losses)) and len(losses) == steps,
           f"{name}: non-finite loss {losses}")
    expect(all(v.is_cuda for v in params.values()),
           f"{name}: params off the card")

    t_steps = cfg.timesteps
    fused = ExecutionSpec(device=str(dev))
    dep, got, t_deploy = counted(deploy, params, cfg, hw, qcfg, ext,
                                 labels=labels, spec=fused,
                                 max_iters=max_iters)
    program, card = dep["program"], dep["outputs"]
    engine = program.engine(fused)
    expect(engine.fused_path == "run", f"{name}: fused path "
           f"{engine.fused_path!r}, want 'run'")
    want = launches_of(**tier_launches(engine, 1, t_steps))
    expect(got == want, f"{name} deploy launched {got}, want {want} (one "
           f"fused_run for one batch run)")
    sec = {"train": t_train, **dep["seconds"]}
    t0 = time.perf_counter()
    oracle = program.run(ext, ExecutionSpec(engine="oracle", device="cpu"))
    t_oracle = time.perf_counter() - t0
    expect(same_run(card, oracle), f"{name}: the card's spikes, v_final or "
           f"packet counts differ from the CPU oracle's")
    out_lo, out_hi = (i - program.graph.n_inputs
                      for i in program.graph.output_slice)
    acc_oracle = float(np.mean(np.argmax(
        oracle[0].sum(1)[:, out_lo:out_hi], axis=-1) == labels))
    expect(dep["accuracy"] == acc_oracle,
           f"{name}: mapped accuracy {dep['accuracy']} != the quantized "
           f"oracle's {acc_oracle}")

    # the same batch graphed: precompile's warm run and capture, a replay
    (_, graphed), got, t_graphed = counted(
        lambda: (program.precompile([len(ext)], t_steps, fused),
                 program.run(ext, fused)))
    expect(same_run(graphed, card), f"{name}: the graphed run at B = "
           f"{len(ext)} differs from the eager one")
    want = launches_of(**tier_launches(engine, 2, t_steps))
    expect(got == want, f"{name}: precompile + one replay launched {got}, "
           f"want {want} (the warm run, the replay)")

    n_py = PAPER_PYTHON_SAMPLES
    t0 = time.perf_counter()
    host = program.run(ext[:n_py], ExecutionSpec(engine="python",
                                                 device="cpu"))
    t_host = time.perf_counter() - t0
    q = dep["quantized"]
    on_card = program.profile(card[2]["packet_counts"][:n_py],
                              n_synapses=q.n_total_synapses)
    on_host = program.profile(host[2], n_synapses=q.n_total_synapses)
    expect([dataclasses.astuple(r) for r in on_card.per_sample]
           == [dataclasses.astuple(r) for r in on_host.per_sample]
           and np.array_equal(host[0], card[0][:n_py]),
           f"{name}: the profile of the card's packet counts differs from "
           f"the host simulator's")

    row = {k: dep[k] for k in ("n_synapses", "sparsity", "feasible",
                               "iterations", "ot_depth", "brams",
                               "accuracy", "latency_us", "energy_mj",
                               "nj_per_synapse")}
    print(f"paper {name}: {cfg.layer_sizes} T={t_steps}, {steps} BPTT steps "
          f"on the card (losses {[round(v, 4) for v in losses]}), float "
          f"accuracy {acc_float:.4f}; Table-3 row, modeled by the "
          f"CycleModel for the paper's FPGA at 100 MHz (not card times), "
          f"paper in brackets: " + ", ".join(
              f"{k} {v!r}" + (f" [{paper[k]}]" if k in paper else "")
              for k, v in row.items()))
    print(f"paper {name}: {len(ext)} samples in one fused-tier call, "
          f"bit-exact with the CPU oracle ({t_oracle:.3f} s) over every "
          f"sample, accuracy {acc_oracle:.4f} = the quantized oracle's; "
          f"graphed at B = {len(ext)} equal ({t_graphed:.3f} s with "
          f"capture); the profile of {n_py} samples' card packets = the "
          f"host simulator's ({t_host:.3f} s); OT depth "
          f"{program.ot_depth}, {program.n_synapses} synapses, plane "
          f"{program.lowered.n_neurons} x {program.lowered.n_internal}")
    print(f"paper {name}: stage seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in sec.items()) + f" (run with its "
          f"copies; deploy {t_deploy:.3f}) on {smi}")
    counts = train_counts(steps, cfg, per_fwd, 1)
    counts.update(tier_launches(engine, 3, t_steps))
    return counts


def paper_quickstart() -> dict:
    """``launch.quickstart.main`` on the card: its asserts hold, and the
    fused tier launches one ``fused_run`` at each of its eager run,
    precompile's warm run and the replay (the toy plane fits), the lif
    tier T at its run."""
    from repro_torch.launch import quickstart
    out, got, sec = counted(quickstart.main, [])
    t_steps = 20
    want = launches_of(fused_run=3, lif_update_int=t_steps)
    expect(got == want, f"quickstart launched {got}, want {want}")
    expect(out["device"].startswith("cuda"), f"quickstart ran on "
           f"{out['device']}")
    print(f"paper quickstart on the card: {sec:.3f} s, launches {got}")
    return want


def phase_paper(dev: torch.device, smi: str) -> dict[str, int]:
    """The paper's two experiments end to end on the card, then the
    quickstart; returns each kernel's launches in the counted runs."""
    from repro_torch.configs.snn_paper import MNIST_HW, SHD_HW
    from repro_torch.data import load_mnist, mnist_batches, shd_batches, \
        synthetic_shd
    from repro_torch.launch.mnist_end_to_end import (PAPER_MNIST,
                                                     encode_images)
    from repro_torch.launch.shd_srnn import PAPER_SHD, shd_config
    from repro_torch.snn import MNIST_CONFIG, QuantConfig

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    t0 = time.perf_counter()
    xtr, ytr, xte, yte = load_mnist(n_train=2048, n_test=PAPER_MNIST_IMAGES)
    ext = encode_images(xte, MNIST_CONFIG.timesteps, seed=2)
    t_steps = MNIST_CONFIG.timesteps
    print(f"paper MNIST: data {xtr.shape} + {xte.shape} and rate coding in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    add(paper_net("MNIST", MNIST_CONFIG, MNIST_HW, QuantConfig(4, 5), 40000,
                  {"steps": PAPER_MNIST_STEPS, "lr": 5e-4, "encode": True,
                   "data": mnist_batches(xtr, ytr, 64),
                   "test": (xte[:256], yte[:256])},
                  ext, yte, (t_steps * 2, t_steps * 2), PAPER_MNIST, dev,
                  smi))
    cfg = shd_config()
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = synthetic_shd(n_train=512, n_test=PAPER_SHD_BATCH,
                                       timesteps=cfg.timesteps)
    print(f"paper SHD: data {xtr.shape} + {xte.shape} in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    add(paper_net("SHD", cfg, SHD_HW, QuantConfig(7, 12), 60000,
                  {"steps": PAPER_SHD_STEPS, "lr": 1e-3, "encode": False,
                   "data": shd_batches(xtr, ytr, 32), "test": (xte, yte)},
                  np.ascontiguousarray(xte, np.int32), yte,
                  (cfg.timesteps * 3, cfg.timesteps * 2), PAPER_SHD, dev,
                  smi))
    add(paper_quickstart())
    print(f"paper phase launches: {total}")
    return total


PHASE_S: dict = {}       # seconds of each phase of main, in order


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds printed on a line of their own
    (``phase <name>: <s> s``) and kept in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


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
    smi = timed("1 card", phase_card)
    timed("1 build", phase_build)
    recs = timed("2 kernels", phase_kernels, dev)
    recs.update(timed("2 snn kernels", phase_snn_kernels, dev))
    recs.update(timed("3 ssm kernels", phase_ssm_kernels, dev))
    timed("4 golden", phase_golden)
    back_end = timed("4 back end", phase_back_end, smi)
    compiled = timed("4 compile", phase_compile, smi)
    launches = timed("5 serve", phase_serve)
    for name in launches:
        launches[name] += back_end[name] + compiled[name]
    timed("5 sharded", phase_sharded)
    timed("5 async server", phase_async_server)
    timed("5 replay", phase_replay, smi)
    timed("5 engines", phase_engines)
    timed("5 graphs", phase_graphs, smi)
    launches.update(timed("6 train", phase_train, dev))
    launches.update(timed("7 lm", phase_lm, dev))
    timed("8 lm train", phase_lm_train, dev)
    timed("9 mesh", phase_mesh, dev, smi)
    timed("10 dryrun", phase_dryrun, dev, smi)
    timed("11 failed capture", check_failed_capture)
    for name, n in timed("12 paper", phase_paper, dev, smi).items():
        launches[name] = launches.get(name, 0) + n
    print("phase times (s): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in PHASE_S.items()))
    meta = {
        "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                       "src/repro/kernels/fused_step.py:122"),
        "fused_run": ("src/repro_torch/kernels/csrc/fused_run.cu",
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
