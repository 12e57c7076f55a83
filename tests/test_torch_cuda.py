"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card
(the kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which ``test_torch_lif.py`` and ``test_torch_fused_step.py``
hold against the JAX reference). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

``fused_run`` (all T steps of a run in one launch) is held to
``fused_run_ref``, to T ``fused_step`` launches and to its emulation,
its plan to the Python mirror of its layout, and the fused engine on the
goldens takes it: one launch a run, eager and graphed.

Every comparison is bit-exact (tolerance 0) but the float LIF step's
gradient kernel, within rtol 1e-5 / atol 1e-6 of its plain version (the
sigmoid surrogate's ``exp`` may differ from torch's in the last bits);
float ``spike_accum``,
which sums in another order than ``torch.matmul``: float32 within
rtol = atol = 1e-5, bf16 within rtol 2e-2 / atol 1e-2 (TF32 off); and
``wkv6`` / ``ssd`` against their token-by-token plain versions and their
emulations: float32 within rtol 1e-4 and atol 1e-5 of the largest output
(sums in another order, so the error scales with the largest terms),
bf16 inputs within 5e-2 (y rounded to bf16 after float32 sums in another
order), as ``chip_smoke.recurrence_tol``; each launched twice, bit for
bit the same. A reduced dense LM (no kernel) on the card against the
same model on the CPU with float32-cast weights: logits within the
float32 recurrence tolerance, bf16 K/V caches within one bf16 ulp
(rtol 2^-7: values agreeing to 1e-6 can round to neighbours). LM
training: a reduced model's loss and gradients on the card against the
CPU with float32-cast weights (loss within relative 1e-5, gradients
within a relative norm of 1e-4, ``tests/test_torch_lm_train.py``'s
bounds), ``remat`` bit for bit, the ``wkv6`` / ``ssd`` wrappers refusing
an input that requires grad, and a checkpoint of card tensors restored
on the CPU bit for bit. The MoE, MLA, codebook and M-RoPE families: the
graphed decode step equal to eager bit for bit (stacked and per-layer
caches), and the MoE layer's gathers giving the same bits run to run,
forward and backward (no atomic adds). The mesh side on a one-rank nccl
group (a ``HashStore``): the ruled train step of a reduced qwen2-1.5b
and qwen3-moe-30b-a3b on ``init_device_mesh("cuda", (1, 1))`` equal to
the plain step bit for bit, every leaf a DTensor on ``cuda:0``, and
``reshard_tree`` placing a host tree on the card. The paper examples'
``deploy`` (MNIST SFNN, SHD SRNN, untrained) on the fused and lif tiers
equal to the same deploy on the CPU oracle bit for bit, row included.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionSpec, Program, packet_stats
from repro_torch.kernels.fused_step import (fused_launcher, fused_path,
                                            fused_run, fused_run_emulated,
                                            fused_run_launcher,
                                            fused_run_plan, fused_run_ref,
                                            fused_step,
                                            fused_step_emulated,
                                            fused_step_ref, pack_plane,
                                            run_smem_bytes)
from repro_torch.kernels.lif_update import (LIFUpdateFn, launch_lif_update,
                                            lif_update, lif_update_bwd,
                                            lif_update_bwd_ref,
                                            lif_update_int,
                                            lif_update_int_ref,
                                            lif_update_ref)
from repro_torch.kernels.ref import ssd_ref, wkv6_ref
from repro_torch.kernels.spike_accum import (spike_accum,
                                             spike_accum_emulated,
                                             spike_accum_ref)
from repro_torch.kernels.ssd import ssd, ssd_emulated
from repro_torch.kernels.wkv6 import wkv6, wkv6_emulated, wkv6_routes
from repro_torch.core import TorchMappedEngine
from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling import LoweredProgram
from repro_torch.snn.lif import SURROGATES, LIFIntParams, LIFParams
from repro_torch.snn.models import SHD_CONFIG, init_params
from repro_torch.snn.train import loss_and_grads
from torch_parity import assert_same_run, cuda_device, to_torch  # noqa: F401

pytestmark = pytest.mark.cuda

GOLDEN = Path(__file__).parent / "golden"
PARAMS = {1: (1, 15, 0), 3: (2, 40, -5), 8: (4, 0, 0), 9: (2, 7, 1),
          17: (1, -3, 2), 64: (4, 20, -1)}
PLANES = [(784, 126, np.int8, 127), (700, 320, np.int16, 1000),
          (37, 29, np.int32, 100_000), (700, 320, np.int32, 100_000),
          (2000, 64, np.int16, 30_000)]         # 65 K-steps: 3 chunks a rank
ODD_SPIKES = [2, -1, 300, 2 ** 20]


def _fused_case(plane, b, nonbinary, seed=None):
    n_ext, n_int, dtype, wmax = plane
    rng = np.random.default_rng(b if seed is None else seed)
    w = rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)).astype(dtype)
    ext = (rng.random((b, n_ext)) < 0.15).astype(np.int32)
    if nonbinary:                               # external spikes are any int
        odd = rng.random(ext.shape) < 0.05
        ext = np.where(odd, rng.choice(ODD_SPIKES, ext.shape), ext)
    prev = rng.random((b, n_int)) < 0.35            # recurrent input
    v = rng.integers(-3000, 3000, (b, n_int))
    return ext, prev, v, w


@pytest.mark.parametrize("nonbinary", [False, True])
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("b", sorted(PARAMS))
def test_fused_step_kernel(cuda_device, plane, b, nonbinary):
    ext, prev, v, w = _fused_case(plane, b, nonbinary)
    p = LIFIntParams(*PARAMS[b])
    want = fused_step_ref(to_torch(ext), to_torch(prev), to_torch(v),
                          torch.from_numpy(w), p)
    dev = cuda_device
    before = fused_step.launches
    got = fused_step(to_torch(ext, dev), to_torch(prev, dev),
                     to_torch(v, dev), torch.from_numpy(w).to(dev), p)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    for g, wnt in zip(got, want):
        assert torch.equal(g.cpu(), wnt)
    s = to_torch(prev, dev)
    with pytest.raises(ValueError, match="alias"):
        fused_step(to_torch(ext, dev), s, to_torch(v, dev),
                   torch.from_numpy(w).to(dev), p, spikes_out=s)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("b", [8, 17, 64])
def test_fused_step_kernel_matches_emulation(cuda_device, plane, b):
    """The kernel, given the packed plane, and the unchecked launcher the
    engine uses are bit-exact with the CPU emulation of the kernel's
    decomposition; two launches give equal results."""
    ext, prev, v, w = _fused_case(plane, b, nonbinary=True, seed=b + 100)
    p = LIFIntParams(*PARAMS[b])
    want = fused_step_emulated(to_torch(ext), to_torch(prev), to_torch(v),
                               pack_plane(torch.from_numpy(w)), p)
    dev = cuda_device
    packed = pack_plane(torch.from_numpy(w).to(dev))
    args = [to_torch(a, dev) for a in (ext, prev)]
    runs = []
    for _ in range(2):
        v_k = to_torch(v, dev)
        runs.append(fused_step(*args, v_k, packed, p))
    v_l = to_torch(v, dev)
    s_l = torch.empty_like(v_l)
    pkt_l = torch.empty((b,), dtype=torch.int32, device=dev)
    launch = fused_launcher(packed, p, ext.shape[1])
    launch(args[0].data_ptr(), args[1].data_ptr(), v_l.data_ptr(),
           s_l.data_ptr(), pkt_l.data_ptr(), b,
           torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for got in runs + [(v_l, s_l, pkt_l)]:
        for g, wnt in zip(got, want):
            assert torch.equal(g.cpu(), wnt)


def _snn_counts():
    return (fused_run.launches, fused_step.launches, lif_update_int.launches)


# -- the whole run in one launch (csrc/fused_run.cu) ---------------------------

RUN_T = {1: 7, 3: 2, 8: 100, 9: 13, 17: 5, 64: 37}


def _run_case(plane, b, nonbinary, seed=None):
    n_ext, n_int, dtype, wmax = plane
    rng = np.random.default_rng(b + 7 if seed is None else seed)
    w = rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)).astype(dtype)
    ext = (rng.random((RUN_T[b], b, n_ext)) < 0.15).astype(np.int32)
    if nonbinary:
        odd = rng.random(ext.shape) < 0.05
        ext = np.where(odd, rng.choice(ODD_SPIKES, ext.shape), ext)
    return ext, w


@pytest.mark.parametrize("nonbinary", [False, True])
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("b", sorted(PARAMS))
def test_fused_run_kernel(cuda_device, plane, b, nonbinary):
    """One launch runs all T steps bit for bit as ``fused_run_ref`` and as
    T ``fused_step`` launches on the same plane, twice; a plane that
    does not fit a cluster's shared memory is refused."""
    ext, w = _run_case(plane, b, nonbinary)
    p = LIFIntParams(*PARAMS[b])
    dev = cuda_device
    packed = pack_plane(torch.from_numpy(w).to(dev))
    ext_d = to_torch(ext, dev)
    if fused_path(packed, ext.shape[2]) == "step":
        assert fused_run_plan(packed).clusters == 0
        with pytest.raises(ValueError, match="does not fit"):
            fused_run(ext_d, packed, p)
        return
    want = fused_run_ref(to_torch(ext), torch.from_numpy(w), p)
    before = fused_run.launches
    runs = [fused_run(ext_d, packed, p) for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_run.launches == before + 2
    v = torch.zeros((b, w.shape[1]), dtype=torch.int32, device=dev)
    s, spikes, pkts = torch.zeros_like(v), [], []
    for t in range(len(ext)):
        _, s, pkt = fused_step(ext_d[t], s, v, packed, p)
        spikes.append(s)
        pkts.append(pkt)
    stepped = (torch.stack(spikes), v, torch.stack(pkts))
    for got in runs + [stepped]:
        for g, wnt in zip(got, want):
            assert torch.equal(g.cpu(), wnt)


@pytest.mark.parametrize("plane", PLANES[:3])
@pytest.mark.parametrize("b", [1, 9, 17])
def test_fused_run_kernel_matches_emulation(cuda_device, plane, b):
    """The engine's unchecked launch is bit-exact with the CPU emulation
    of the kernel's decomposition."""
    ext, w = _run_case(plane, b, nonbinary=True, seed=b + 200)
    p = LIFIntParams(*PARAMS[b])
    want = fused_run_emulated(to_torch(ext), pack_plane(torch.from_numpy(w)),
                              p)
    dev = cuda_device
    packed = pack_plane(torch.from_numpy(w).to(dev))
    ext_d = to_torch(ext, dev)
    t_steps, _, n_int = want[0].shape
    spikes = torch.empty((t_steps, b, n_int), dtype=torch.int32, device=dev)
    v = torch.empty((b, n_int), dtype=torch.int32, device=dev)
    pkt = torch.empty((t_steps, b), dtype=torch.int32, device=dev)
    fused_run_launcher(packed, p, ext.shape[2])(
        ext_d.data_ptr(), v.data_ptr(), spikes.data_ptr(), pkt.data_ptr(), b,
        t_steps, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for g, wnt in zip((spikes, v, pkt), want):
        assert torch.equal(g.cpu(), wnt)


@pytest.mark.parametrize("plane", PLANES)
def test_fused_run_plan_matches_the_mirror(cuda_device, plane):
    """The kernel's plan and the Python mirror of its layout agree, and
    the shape rule on the card is the mirror's for these planes."""
    n_ext, n_int, dtype, _ = plane
    w = torch.zeros((n_ext + n_int, n_int), dtype=getattr(torch, dtype.__name__))
    packed = pack_plane(w.to(cuda_device))
    plan = fused_run_plan(packed)
    mirror = run_smem_bytes(w.element_size(), n_ext, n_int)
    assert plan.smem_bytes == mirror
    assert (plan.clusters >= 1) == (mirror <= 232448)
    assert fused_path(packed, n_ext) == fused_path(w, n_ext)


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_fused_run_engine_graphed_equals_eager(cuda_device, name):
    """The fused engine takes the run path on both goldens: one
    ``fused_run`` and no ``fused_step`` per run, eager and graphed, and
    the two agree with the reference tier bit for bit."""
    prog = Program.load(GOLDEN / f"{name}_program_v1.npz")
    spec = ExecutionSpec(kernel="fused", device=str(cuda_device))
    graphed = prog.engine(spec)
    eager = TorchMappedEngine(prog.graph, prog.lowered, spec)
    assert graphed.fused_path == eager.fused_path == "run"
    ext = (np.random.default_rng(14).random((4, 30, prog.n_inputs))
           < 0.2).astype(np.int32)
    graphed.precompile((4,), 30)
    for eng in (graphed, eager):
        before = _snn_counts()
        got = eng.run(ext)
        assert tuple(a - b for a, b in zip(_snn_counts(), before)) \
            == (1, 0, 0)
        assert_same_run(got, prog.run(ext, ExecutionSpec(
            kernel="reference", device=str(cuda_device))), name)


def test_fused_run_engine_on_an_empty_batch(cuda_device):
    """A batch of no trains on the run path launches no kernel and gives
    the reference tier's empty outputs."""
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    ext = np.zeros((0, 5, prog.n_inputs), np.int32)
    spec = ExecutionSpec(kernel="fused", device=str(cuda_device))
    assert prog.engine(spec).fused_path == "run"
    before = _snn_counts()
    spikes, v, st = prog.run(ext, spec)
    assert _snn_counts() == before
    want = prog.run(ext, ExecutionSpec(kernel="reference",
                                       device=str(cuda_device)))
    for got, ref in ((spikes, want[0]), (v, want[1]),
                     (st["packet_counts"], want[2]["packet_counts"])):
        assert got.shape == ref.shape and got.dtype == ref.dtype
    assert spikes.shape == (0, 5, 320) and v.shape == (0, 320)


@pytest.mark.parametrize("shape", [(320,), (8, 320), (17, 126)])
@pytest.mark.parametrize("leak_shift", [1, 2, 4])
def test_lif_update_int_kernel(cuda_device, shape, leak_shift):
    rng = np.random.default_rng(leak_shift)
    v = rng.integers(-5000, 5000, shape)
    cur = rng.integers(-300, 300, shape)
    p = LIFIntParams(leak_shift, 20, -4)
    want_v, want_s = lif_update_int_ref(to_torch(v), to_torch(cur), p)
    before = lif_update_int.launches
    tv = to_torch(v, cuda_device)
    v_k, s_k = lif_update_int(tv, to_torch(cur, cuda_device), p,
                              out=(tv, torch.empty_like(tv)))
    torch.cuda.synchronize()
    assert v_k is tv and lif_update_int.launches == before + 1
    assert torch.equal(v_k.cpu(), want_v) and torch.equal(s_k.cpu(), want_s)


@pytest.mark.parametrize("name", ["tiny", "shd"])
@pytest.mark.parametrize("tier", ["fused", "lif", "reference"])
def test_engine_on_card_reproduces_golden(cuda_device, name, tier):
    prog = Program.load(GOLDEN / f"{name}_program_v1.npz")
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        ext = io["ext"]
        want = (io["spikes"], io["v_final"],
                {"packet_counts": io["packet_counts"],
                 "mean_packets_per_step": float(io["packet_counts"].mean())})
    counts = _snn_counts()
    got = prog.run(ext, ExecutionSpec(kernel=tier))
    assert_same_run(got, want, f"{name}/{tier}")
    steps = ext.shape[-2]
    grew = tuple(a - b for a, b in zip(_snn_counts(), counts))
    # both goldens' planes fit a cluster: one fused_run a run
    assert grew == {"fused": (1, 0, 0), "lif": (0, 0, steps),
                    "reference": (0, 0, 0)}[tier]


@pytest.mark.parametrize("shape", [(1, 7, 5), (8, 513, 257), (32, 700, 300),
                                   (32, 300, 300), (32, 300, 20),
                                   (64, 784, 116), (64, 116, 10),
                                   (3, 2049, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_spike_accum_kernel(cuda_device, shape, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n_pre, n_post = shape
    rng = np.random.default_rng(n_pre)
    s = torch.from_numpy(rng.random((b, n_pre)) < 0.1).to(cuda_device, dtype)
    w = (rng.integers(-7, 8, (n_pre, n_post)) if dtype == torch.int32
         else rng.standard_normal((n_pre, n_post)).astype(np.float32))
    w = torch.from_numpy(w).to(cuda_device, dtype)
    want = spike_accum_ref(s, w)
    before = spike_accum.launches
    got = spike_accum(s, w)
    torch.cuda.synchronize()
    assert spike_accum.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
               else dict(rtol=2e-2, atol=1e-2))
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("case", ["binary", "non_binary", "unsplittable"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_spike_accum_kernel_repeats(cuda_device, dtype, case):
    """Two launches give equal results (no atomics touch a sum), within
    tolerance of the plain version and of the CPU emulation of the
    kernel's schedule, also where the bf16 split cannot hold the float32
    product: spikes outside {0, 1}, weights below 2^-100."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    s = (rng.random((32, 700)) < 0.1).astype(np.float32)
    w = (rng.integers(-7, 8, (700, 300)) if dtype == torch.int32
         else rng.standard_normal((700, 300))).astype(np.float32)
    if case == "non_binary":
        s[s > 0] = rng.choice([0.5, -2.0, 3.0], int((s > 0).sum()))
    elif case == "unsplittable" and dtype == torch.float32:
        w[::5] *= np.float32(2.0 ** -110)
    s_t, w_t = (torch.from_numpy(a).to(dtype) for a in (s, w))
    got = [spike_accum(s_t.to(cuda_device), w_t.to(cuda_device))
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    for want in (spike_accum_ref(s_t, w_t), spike_accum_emulated(s_t, w_t)):
        if dtype == torch.int32:
            assert torch.equal(got[0].cpu(), want)
        else:
            tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
                   else dict(rtol=2e-2, atol=1e-2))
            torch.testing.assert_close(got[0].cpu(), want, **tol)


def test_spike_accum_zero_tiles_exact(cuda_device):
    s = torch.zeros((8, 512), device=cuda_device)
    s[0, 300] = 1.0
    w = torch.randn((512, 128), device=cuda_device)
    got = spike_accum(s, w)
    assert torch.equal(got[0], w[300]) and not got[1:].any()
    assert not spike_accum(torch.zeros_like(s), w).any()


@pytest.mark.parametrize("shape", [(7,), (32, 300), (13, 300)])
@pytest.mark.parametrize("alpha", [0.25, 0.03125, 0.5])
def test_lif_update_kernel(cuda_device, shape, alpha):
    g = torch.Generator(device=cuda_device).manual_seed(len(shape))
    v = torch.randn(shape, device=cuda_device, generator=g)
    cur = torch.randn(shape, device=cuda_device, generator=g) * 2.0
    on = torch.rand(shape, device=cuda_device, generator=g) < 0.5
    cur = torch.where(on, 1.0 - (1.0 - alpha) * v, cur)    # on the threshold
    want = lif_update_ref(v, cur, alpha, 1.0, -0.25)
    before = lif_update.launches
    got = lif_update(v, cur, alpha=alpha, v_th=1.0, v_reset=-0.25)
    s_out = torch.empty_like(v)
    v_i = v.clone()
    got_i = lif_update(v_i, cur, alpha=alpha, v_th=1.0, v_reset=-0.25,
                       out=(v_i, s_out))
    torch.cuda.synchronize()
    assert lif_update.launches == before + 2 and got_i[0] is v_i
    for a, b in zip(got + got_i, want + want):
        assert torch.equal(a, b)


def test_shd_train_step_launches_kernels(cuda_device):
    """One full-width SHD step: every forward timestep goes through the
    kernels (3 spike_accum, 2 lif_update), the backward through the LIF
    gradient kernel alone, once per step and layer the loss depends on
    (the hidden layer's last step feeds nothing: 2 T - 1)."""
    cfg = SHD_CONFIG
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((cfg.timesteps, 32, 700)) < 0.07
                         ).to(cuda_device, torch.float32)
    y = torch.from_numpy(rng.integers(0, 20, 32)).to(cuda_device)
    kernels = (spike_accum, lif_update, lif_update_bwd)
    before = [k.launches for k in kernels]
    loss, counts, grads = loss_and_grads(params, x, y, cfg)
    torch.cuda.synchronize()
    grew = tuple(k.launches - n for k, n in zip(kernels, before))
    assert grew == (cfg.timesteps * 3, cfg.timesteps * 2,
                    cfg.timesteps * 2 - 1)
    assert torch.isfinite(loss) and sorted(grads) == ["w0", "w1", "wr0"]
    assert all(bool(g.isfinite().all()) for g in grads.values())


def _on_threshold(shape, alpha, dev, seed):
    """v, a current and a recurrent current with about a third of the
    neurons exactly on the threshold 1.0: there v lies on a grid of
    2^-7, so (1 - alpha) v and 1 - (1 - alpha) v are exact in float32
    and the recurrent current is 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(shape, device=dev, generator=g)
    a = torch.randn(shape, device=dev, generator=g)
    b = torch.randn(shape, device=dev, generator=g) * 0.5
    on = torch.rand(shape, device=dev, generator=g) < 0.35
    v = torch.where(on, torch.randint(-64, 192, shape, device=dev,
                                      generator=g) / 128.0, v)
    a = torch.where(on, 1.0 - (1.0 - alpha) * v, a)
    return v, a, torch.where(on, 0.0, b)


@pytest.mark.parametrize("shape", [(7,), (32, 300), (13, 301)])
@pytest.mark.parametrize("alpha", [0.25, 0.03125])
def test_lif_update_two_currents_kernel(cuda_device, shape, alpha):
    """The forward with the recurrent current added in the kernel, through
    ``LIFUpdateFn`` and the unchecked launch (in place too), is bit-exact
    with ``lif_update_ref(v, a + b)``; each counts one launch."""
    v, a, b = _on_threshold(shape, alpha, cuda_device, seed=len(shape))
    p = LIFParams(alpha, 1.0, -0.25)
    want = lif_update_ref(v, a + b, alpha, 1.0, -0.25)
    assert bool(want[1].any()) and not bool(want[1].all())
    before = lif_update.launches
    got = LIFUpdateFn.apply(v, a, b, p, "sigmoid")
    v_i, s_i = v.clone(), torch.empty_like(v)
    launch_lif_update(v_i, a, b, v_i, s_i, alpha, 1.0, -0.25,
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert lif_update.launches == before + 2
    for x, y in zip(got + (v_i, s_i), want + want):
        assert torch.equal(x, y)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` 4 bytes past a 16-byte boundary (a view that does
    not start on an allocation)."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    assert out.data_ptr() % 16 == 4
    return out.copy_(t)


@pytest.mark.parametrize("case", ["both", "no_g_vnext", "no_g_s",
                                  "one_current", "ragged", "offset"])
@pytest.mark.parametrize("surrogate", SURROGATES)
def test_lif_update_bwd_kernel(cuda_device, surrogate, case):
    """The gradient kernel within rtol 1e-5 / atol 1e-6 of
    ``lif_update_bwd_ref`` with neurons on the threshold: both gradients
    and two currents, either gradient absent, one current, n % 4 != 0,
    and operands 4 bytes off a 16-byte boundary; one launch each."""
    shape = (13, 301) if case == "ragged" else (32, 300)
    alpha = 0.03125
    v, a, b = _on_threshold(shape, alpha, cuda_device, seed=7)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    gv, gs = (torch.randn(shape, device=cuda_device, generator=g)
              for _ in range(2))
    if case in ("one_current", "offset"):
        b = None
    if case == "no_g_vnext":
        gv = None
    if case == "no_g_s":
        gs = None
    if case == "offset":
        v, a, gv, gs = (_misaligned(t) for t in (v, a, gv, gs))
    want = lif_update_bwd_ref(v, a, gv, gs, alpha, 1.0, surrogate, b)
    before = lif_update_bwd.launches
    got = lif_update_bwd(v, a, gv, gs, alpha=alpha, v_th=1.0,
                         surrogate=surrogate, current_rec=b)
    torch.cuda.synchronize()
    assert lif_update_bwd.launches == before + 1
    for x, y in zip(got, want):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-6), \
            (x - y).abs().max().item()


@pytest.mark.parametrize("surrogate", SURROGATES)
def test_lif_update_fn_backward_on_card(cuda_device, surrogate):
    """``LIFUpdateFn``'s backward on the card launches the gradient kernel
    once and gives ``lif_update_bwd_ref``'s gradients (rtol 1e-5 / atol
    1e-6), the current's to both planes; with ``v_next`` unused it gets
    ``None`` for its gradient and still launches once."""
    alpha = 0.25
    v, a, b = _on_threshold((32, 300), alpha, cuda_device, seed=3)
    gs = torch.randn((32, 300), device=cuda_device)
    gv = torch.randn((32, 300), device=cuda_device)
    p = LIFParams(alpha, 1.0, 0.0)
    for used in ("both", "spikes"):
        leaves = [t.clone().requires_grad_() for t in (v, a, b)]
        v_next, s = LIFUpdateFn.apply(*leaves, p, surrogate)
        before = lif_update_bwd.launches
        if used == "both":
            torch.autograd.backward((v_next, s), (gv, gs))
        else:
            s.backward(gs)
        torch.cuda.synchronize()
        assert lif_update_bwd.launches == before + 1
        want_v, want_i = lif_update_bwd_ref(
            v, a, gv if used == "both" else None, gs, alpha, 1.0, surrogate,
            b)
        for t, w in zip(leaves, (want_v, want_i, want_i)):
            assert torch.allclose(t.grad, w, rtol=1e-5, atol=1e-6)


def test_lif_tier_card_loop_matches_reference(cuda_device):
    """The ``"lif"`` tier's step loop on the card (one current plane per
    run, drained by the Neuron Unit) against the ``"reference"`` tier on
    the card, bit for bit, on SHD-scale requests, run twice (a plane
    left non-zero would show in the second run): exactly T launches of
    the Neuron Unit per run."""
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    rng = np.random.default_rng(4)
    ext = (rng.random((5, 40, prog.n_inputs)) < 0.1).astype(np.int32)
    want = prog.run(ext, ExecutionSpec(kernel="reference"))
    for _ in range(2):
        before = lif_update_int.launches
        got = prog.run(ext, ExecutionSpec(kernel="lif"))
        assert lif_update_int.launches == before + 40
        assert_same_run(got, want, "lif tier on the card")


@pytest.mark.parametrize("method", ["framework", "hypergraph"])
def test_port_compiled_program_on_both_kernel_tiers(cuda_device, method):
    """A Program the port compiled itself (a recurrent 1200-synapse graph
    on 8 SPUs, on 4 chips for ``hypergraph``) runs on the ``"fused"`` and
    ``"lif"`` tiers on the card bit for bit as the ``"reference"`` tier
    and the oracle, with exactly one ``fused_run`` (its plane fits a
    cluster) and T ``lif_update_int`` launches."""
    from repro_torch.core import HardwareConfig, compile, random_graph
    g = random_graph(16, 32, 1200, seed=4)
    hw = HardwareConfig(n_spus=8, unified_mem_depth=48, concentration=3,
                        max_neurons=g.n_neurons,
                        max_post_neurons=g.n_internal)
    prog = compile(g, hw, method=method, max_iters=20000,
                   n_chips=4 if method == "hypergraph" else None)
    assert prog.verify().ok
    ext = (np.random.default_rng(6).random((5, 30, g.n_inputs))
           < 0.3).astype(np.int32)
    want = prog.run(ext, ExecutionSpec(kernel="reference"))
    assert_same_run(prog.run(ext, ExecutionSpec(engine="oracle")), want,
                    "oracle")
    for tier, kernel, n in (("fused", fused_run, 1),
                            ("lif", lif_update_int, 30)):
        before = kernel.launches
        got = prog.run(ext, ExecutionSpec(kernel=tier))
        assert kernel.launches == before + n, tier
        assert_same_run(got, want, f"port-compiled {method} on {tier}")


def _no_internal_neurons():
    """A program of 4 inputs and no internal neuron or synapse, lowered:
    ``(graph, lowered)``."""
    none = np.zeros(0, np.int32)
    g = SNNGraph(n_inputs=4, n_neurons=4, pre=none, post=none, weight=none,
                 lif=LIFIntParams(2, 10, 0))
    lw = LoweredProgram(n_inputs=4, n_neurons=4, n_internal=0, n_spus=1,
                        depth=0, op_spu=none, op_slot=none, op_pre=none,
                        op_post_local=none, op_weight=none,
                        op_pre_end=np.zeros(0, bool),
                        op_post_end=np.zeros(0, bool),
                        routing=np.zeros((4, 1), bool))
    return g, lw


@pytest.mark.parametrize("tier", ["fused", "lif", "reference"])
def test_no_internal_neurons_on_card(cuda_device, tier):
    """With no internal neuron a step's packet count is its non-zero
    external spikes, on every tier on the card: [[4, 4, 4], [4, 4, 4]]
    for all-one spikes, and per step for random ones (any int32)."""
    g, lw = _no_internal_neurons()
    eng = TorchMappedEngine(g, lw, ExecutionSpec(kernel=tier))
    spikes, v, st = eng.run(np.ones((2, 3, 4), np.int32))
    assert spikes.shape == (2, 3, 0) and v.shape == (2, 0)
    np.testing.assert_array_equal(st["packet_counts"], [[4, 4, 4],
                                                        [4, 4, 4]])
    ext = np.random.default_rng(5).integers(-2, 3, (3, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(eng.run(ext)[2]["packet_counts"],
                                  (ext != 0).sum(-1))


def test_fused_step_without_internal_neurons(cuda_device):
    """The public ``fused_step`` with ``n_int == 0`` writes the packet
    counts (the non-zero external spikes) and launches nothing."""
    dev = cuda_device
    ext = to_torch(np.array([[1, 0, 3, 1], [0, 0, 0, 0], [2, -1, 1, 1]]), dev)
    empty = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    w = torch.zeros((4, 0), dtype=torch.int16, device=dev)
    pkt = torch.full((3,), -7, dtype=torch.int32, device=dev)
    before = fused_step.launches
    _, _, got = fused_step(ext, empty, empty.clone(), w,
                           LIFIntParams(2, 10, 0), pkt_out=pkt)
    _, _, fresh = fused_step(ext, empty, empty.clone(), w,
                             LIFIntParams(2, 10, 0))
    torch.cuda.synchronize()
    assert got is pkt and fused_step.launches == before
    for p in (got, fresh):
        assert p.tolist() == [3, 0, 4]


def _recurrence_tol(dtype, want):
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))
    return dict(rtol=5e-2, atol=5e-2)


def _check_recurrence(fn, emulated, args, dtype):
    """One launch against the plain version and the emulation, a second
    launch bit for bit the same, every output finite."""
    want = (wkv6_ref if fn is wkv6 else ssd_ref)(*args)
    before = fn.launches
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, a2, e, m in zip(got, again, want, emulated(*args)):
        assert bool(a.isfinite().all()) and torch.equal(a, a2)
        torch.testing.assert_close(a.float(), e.float(),
                                   **_recurrence_tol(dtype, e))
        torch.testing.assert_close(a.float(), m.float(),
                                   **_recurrence_tol(dtype, m))


def _wkv6_args(dev, shape, dtype, decay="mild"):
    b, s, h, n = shape
    g = torch.Generator(device=dev).manual_seed(s)
    rnd = lambda *sz: torch.randn(sz, device=dev, generator=g)
    r, k, v = (rnd(b, s, h, n).to(dtype) for _ in range(3))
    # S = 1024 takes a model's decay, near 1 (w0 = -6): a long memory;
    # "strong": every other head down to -40 a token (log-space route)
    w = -torch.exp(rnd(b, s, h, n) * 0.5 - 6.0) if s == 1024 \
        else -torch.exp(rnd(b, s, h, n) - 1.0)
    if decay == "strong":
        w[:, :, ::2] = -40.0 * torch.rand((b, s, (h + 1) // 2, n),
                                          device=dev, generator=g)
    u = rnd(h, n) * 0.1
    st = rnd(b, h, n, n)                           # a non-zero state
    return r, k, v, w, u, st


def _ssd_args(dev, shape, dtype, decay="mild"):
    b, s, h, p, n = shape
    g = torch.Generator(device=dev).manual_seed(s)
    rnd = lambda *sz: torch.randn(sz, device=dev, generator=g)
    x = rnd(b, s, h, p).to(dtype)
    if decay == "strong":                          # exp(a_log) dt up to 50
        dt = torch.rand((b, s, h), device=dev, generator=g) * 2.0
        a_log = torch.log(torch.linspace(1.0, 25.0, h, device=dev))
    else:
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        a_log = torch.log(torch.arange(1, h + 1, device=dev,
                                       dtype=torch.float32))
    bm, cm = rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)
    st = rnd(b, h, p, n)                           # a non-zero state
    return x, dt, a_log, bm, cm, st


@pytest.mark.parametrize("shape", [(1, 8, 1, 8), (2, 37, 3, 8),
                                   (2, 64, 2, 16), (1, 129, 4, 32),
                                   (2, 100, 5, 64), (1, 1024, 3, 64),
                                   (1, 1, 3, 64), (2, 16, 3, 64),
                                   (2, 17, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel(cuda_device, shape, dtype):
    _check_recurrence(wkv6, wkv6_emulated,
                      _wkv6_args(cuda_device, shape, dtype), dtype)


@pytest.mark.parametrize("shape", [(2, 129, 4, 64), (1, 70, 3, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_strong_decay(cuda_device, shape, dtype):
    """Sub-chunks whose decay spans more than the threshold: their scores
    are summed in log space, the others' factorized; no inf or nan."""
    args = _wkv6_args(cuda_device, shape, dtype, "strong")
    routes = wkv6_routes(args[3])
    assert bool(routes.any()) and not bool(routes.all())
    _check_recurrence(wkv6, wkv6_emulated, args, dtype)


@pytest.mark.parametrize("shape", [(1, 8, 1, 4, 8), (2, 29, 3, 4, 8),
                                   (1, 64, 2, 16, 16), (2, 129, 3, 64, 64),
                                   (1, 37, 2, 128, 32), (1, 1, 2, 64, 64),
                                   (2, 16, 3, 64, 64), (2, 17, 3, 100, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel(cuda_device, shape, dtype):
    _check_recurrence(ssd, ssd_emulated,
                      _ssd_args(cuda_device, shape, dtype), dtype)


@pytest.mark.parametrize("shape", [(2, 129, 4, 64, 64), (1, 70, 2, 3, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_strong_decay(cuda_device, shape, dtype):
    _check_recurrence(ssd, ssd_emulated,
                      _ssd_args(cuda_device, shape, dtype, "strong"), dtype)


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-7b"])
def test_lm_prefill_launches_one_kernel_per_layer(cuda_device, name):
    """A reduced model's prefill on the card goes through the kernels,
    one launch per layer, and agrees with the chunked path; its decode
    launches none."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M

    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda_device)
    kernel = wkv6 if cfg.family == "ssm" else ssd
    before = kernel.launches
    logits, st = M.prefill(params, cfg, tokens)
    assert kernel.launches == before + cfg.n_layers
    plain, st_plain = M.prefill(params, cfg, tokens, kernels=False)
    assert kernel.launches == before + cfg.n_layers
    torch.testing.assert_close(logits, plain, rtol=5e-2, atol=5e-2)
    st = _grow_cache(cfg, st, 2, 44, cuda_device)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    lg, _ = M.decode_step(params, cfg, tok, st)
    torch.cuda.synchronize()
    assert kernel.launches == before + cfg.n_layers
    assert bool(lg.isfinite().all())


# -- the CUDA-graphed T-step loop (precompile) ---------------------------------

@pytest.mark.parametrize("tier", ["fused", "lif"])
def test_graphed_loop_matches_eager_and_reference(cuda_device, tier):
    """Every captured bucket, at T = 100 and an odd T, replays the same
    bits as the eager loop and the reference tier, counts one
    ``fused_run`` (the SHD plane fits) or T ``lif_update_int`` launches
    per replay, and a shape not captured still runs eagerly."""
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    spec = ExecutionSpec(kernel=tier, device=str(cuda_device))
    kernel = fused_run if tier == "fused" else lif_update_int
    graphed = prog.engine(spec)
    eager = TorchMappedEngine(prog.graph, prog.lowered, spec)
    rng = np.random.default_rng(11)
    for t_steps in (100, 13):
        assert graphed.precompile((1, 2, 4, 8), t_steps) == \
            [(b, t_steps) for b in (1, 2, 4, 8)]
        for b in (1, 2, 4, 8, 3):
            ext = (rng.random((b, t_steps, prog.n_inputs)) < 0.1
                   ).astype(np.int32)
            before = kernel.launches
            got = graphed.run(ext)
            assert kernel.launches - before == (1 if tier == "fused"
                                                else t_steps)
            assert ((b, t_steps) in graphed._graphs) == (b != 3)
            assert_same_run(got, eager.run(ext), f"{tier} B={b} eager")
            assert_same_run(got, prog.run(ext, ExecutionSpec(
                kernel="reference", device=str(cuda_device))),
                f"{tier} B={b} reference")


@pytest.mark.parametrize("tier", ["fused", "lif"])
def test_precompile_is_idempotent_and_counts_replays(cuda_device, tier):
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    spec = ExecutionSpec(kernel=tier, device=str(cuda_device))
    kernel = fused_run if tier == "fused" else lif_update_int
    per_run = 1 if tier == "fused" else 9
    assert prog.precompile((2, 4), 9, spec) == [(2, 9), (4, 9)]
    graphs = dict(prog.engine(spec)._graphs)
    before = kernel.launches
    assert prog.precompile((4, 2), 9, spec) == []
    assert kernel.launches == before
    assert prog.engine(spec)._graphs == graphs
    shape = graphs[(4, 9)]
    for _ in range(3):
        shape.replay()
    torch.cuda.synchronize()
    assert kernel.launches - before == 3 * per_run


def test_failed_capture_raises(cuda_device):
    """A loop that cannot be captured (it copies to the host) raises at
    precompile; no graph is kept and no launch of the capture counts."""
    prog = Program.load(GOLDEN / "tiny_program_v1.npz")
    eng = prog.engine(ExecutionSpec(kernel="fused", device=str(cuda_device)))
    run_card = eng._run_card

    def syncing(buf):
        run_card(buf)
        buf.v.cpu()

    eng._run_card = syncing
    before = fused_run.launches
    with pytest.raises(RuntimeError):
        eng.precompile((2,), 5)
    # the warm run before the capture counts; the capture's launch not
    assert not eng._graphs and fused_run.launches == before + 1


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_oracle_on_card_matches_cpu(cuda_device, name):
    prog = Program.load(GOLDEN / f"{name}_program_v1.npz")
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        ext = io["ext"]
    got = prog.run(ext, ExecutionSpec(engine="oracle",
                                      device=str(cuda_device)))
    assert_same_run(got, prog.run(ext, ExecutionSpec(engine="oracle",
                                                     device="cpu")))


# -- the rest of serving: sharded runner, async server, graphed decode ------

@pytest.mark.parametrize("tier", ["fused", "lif"])
def test_sharded_two_shards_on_one_card(cuda_device, tier):
    """Two shards on one card (pad-and-mask at every size) equal the
    single engine bit for bit, and run each shard through the kernel."""
    from repro_torch.serve import ShardedRunner
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    dev = str(cuda_device)
    spec = ExecutionSpec(kernel=tier, device=dev)
    kernel = fused_run if tier == "fused" else lif_update_int
    per_run = 1 if tier == "fused" else 20
    runner = ShardedRunner(prog, spec=ExecutionSpec(kernel=tier,
                                                    mesh=(dev, dev)),
                           min_shard=0)
    assert runner.precompile((3, 4), 20) == [(4, 20)]
    rng = np.random.default_rng(12)
    for b in (1, 3, 5):
        ext = (rng.random((b, 20, prog.n_inputs)) < 0.1).astype(np.int32)
        before = kernel.launches
        got = runner.run(ext)
        assert kernel.launches - before == 2 * per_run
        assert_same_run(got, prog.run(ext, spec), f"{tier} B={b}")


def test_async_server_engine_mode_round_trip(cuda_device):
    """One AsyncServer round trip on the card's precompiled fused engine:
    outputs bit-exact with program.run, stage sum equal to the latency."""
    import asyncio

    from repro_torch.serve import (AsyncServer, BatchPolicy, ProgramRegistry,
                                   Request)
    policy = BatchPolicy(max_batch=4, max_wait_us=2000.0)
    spec = ExecutionSpec(device=str(cuda_device))
    reg = ProgramRegistry()
    prog = reg.load("m", GOLDEN / "tiny_program_v1.npz", precompile=policy,
                    timesteps=6, spec=spec)
    rng = np.random.default_rng(13)
    reqs = [(rng.random((6, prog.n_inputs)) < 0.3).astype(np.int32)
            for _ in range(5)]

    async def main():
        async with AsyncServer(reg, policy=policy, spec=spec) as srv:
            return await asyncio.gather(*[srv.submit(Request("m", r, 0.0,
                                                             stream=i))
                                          for i, r in enumerate(reqs)])

    for c in asyncio.run(main()):
        assert ((c.queue_wait_us + c.fill_wait_us) + c.pad_us) \
            + c.compute_us == c.latency_us
        s, v, st = prog.run(reqs[c.stream], spec)
        assert c.outputs[0].tobytes() == s.tobytes()
        assert c.outputs[1].tobytes() == v.tobytes()
        np.testing.assert_array_equal(c.outputs[2], st["packet_counts"])


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-7b", "stablelm-12b",
                                  "glm4-9b"])
def test_graphed_decode_matches_eager(cuda_device, name):
    """The graphed decode step at reduced size: the same greedy tokens and
    state bits as the eager step, no kernel-wrapper launch, and a step
    past the capacity raises before it replays."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map
    from repro_torch.train.steps import (make_graphed_serve_step,
                                         make_serve_step)

    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))).to(cuda_device)
    logits, st = M.prefill(params, cfg, tokens)
    grown = _grow_cache(cfg, st, 2, 22, cuda_device)
    step = make_graphed_serve_step(cfg, params, cuda_device)
    assert step.precompile(2, 22) and not step.precompile(2, 22)
    before = (wkv6.launches, ssd.launches)
    eager = make_serve_step(cfg)
    tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
    tg, te = tok0, tok0
    sg, se = tree_map(torch.clone, grown), tree_map(torch.clone, grown)
    for _ in range(6):
        tg, sg = step(params, tg.reshape(2, 1), sg)
        te, se = eager(params, te.reshape(2, 1), se)
        assert torch.equal(tg, te)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             sg, se)
    torch.cuda.synchronize()
    assert (wkv6.launches, ssd.launches) == before
    with pytest.raises(ValueError, match="past capacity"):
        step(params, tg.reshape(2, 1), sg)


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "musicgen-medium", "qwen2-vl-7b"])
def test_graphed_decode_of_the_new_families_matches_eager(cuda_device, name,
                                                          unroll):
    """MoE, MLA (both stacks), codebooks ([B, 1, K] in, [B, K] out) and
    M-RoPE (decode positions from the state's length, on the card): 6
    greedy tokens graphed and eager, the same tokens and state bits, no
    kernel-wrapper launch."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map
    from repro_torch.train.steps import (greedy, make_graphed_serve_step,
                                         make_serve_step)

    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          cuda_device)
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16, *k))).to(cuda_device)
    logits, st = M.prefill(params, cfg, tokens)
    if unroll:
        st = {"len": st["len"], **{p: {key: [t.clone() for t in v]
                                       for key, v in st[p].items()}
                                   for p in ("dense", "main") if p in st}}
    grown = _grow_cache(cfg, st, 2, 22, cuda_device)
    step = make_graphed_serve_step(cfg, params, cuda_device, unroll=unroll)
    assert step.precompile(2, 22)
    before = (wkv6.launches, ssd.launches)
    eager = make_serve_step(cfg, unroll=unroll)
    tg = te = greedy(logits)
    sg, se = tree_map(torch.clone, grown), tree_map(torch.clone, grown)
    for _ in range(6):
        tg, sg = step(params, tg[:, None], sg)
        te, se = eager(params, te[:, None], se)
        assert torch.equal(tg, te) and tg.shape == (2, *k)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             sg, se)
    torch.cuda.synchronize()
    assert (wkv6.launches, ssd.launches) == before


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_moe_gathers_repeat_bit_for_bit(cuda_device, name):
    """The MoE layer at reduced width with capacity drops (capacity factor
    0.5), forward and backward twice: the same output, aux loss and
    gradients bit for bit; the output within the float32 bound of the
    CPU's on float32 weights."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import tree_map

    cfg = get_reduced(name)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p_cpu = tree_map(lambda a: a.float(), MOE.init_moe(
        cfg, torch.Generator().manual_seed(0), torch.device("cpu")))
    x_cpu = torch.randn(4, 64, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))

    def run(p, x):
        p = tree_map(lambda a: a.detach().clone().requires_grad_(), p)
        x = x.detach().clone().requires_grad_()
        y, aux = MOE.moe_mlp(p, x, cfg)
        (y.square().sum() + aux).backward()
        return [y.detach(), aux.detach(), x.grad] + _leaves(
            tree_map(lambda a: a.grad, p))

    p_gpu = tree_map(lambda a: a.to(cuda_device), p_cpu)
    first = run(p_gpu, x_cpu.to(cuda_device))
    second = run(p_gpu, x_cpu.to(cuda_device))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    on_cpu = run(p_cpu, x_cpu)
    torch.testing.assert_close(first[0].cpu(), on_cpu[0], rtol=2e-4,
                               atol=2e-4)


def test_captures_keep_the_cycle_collector_off(cuda_device, monkeypatch):
    """The engine's and the serve step's captures begin with Python's
    cyclic collector paused, and a capture still succeeds while an old
    engine's graphs lie in unreachable cycles (the collector would free
    them mid-capture, which invalidates the capture)."""
    import gc
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_graphed_serve_step

    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    spec = ExecutionSpec(kernel="lif", device=str(cuda_device))
    old = TorchMappedEngine(prog.graph, prog.lowered, spec)
    old.precompile((1, 2), 5)
    cycle = [old]
    cycle.append(cycle)
    del old, cycle                        # garbage only the collector frees
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, *args, **kwargs):
        seen.append(gc.isenabled())
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    fresh = TorchMappedEngine(prog.graph, prog.lowered, spec)
    assert fresh.precompile((1, 2), 5) == [(1, 5), (2, 5)]
    cfg = get_reduced("glm4-9b")
    params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          cuda_device)
    assert make_graphed_serve_step(cfg, params, cuda_device).precompile(2, 8)
    assert seen == [False] * 3 and gc.isenabled()
    gc.collect()


@pytest.mark.parametrize("name", ["stablelm-12b", "glm4-9b", "qwen2-1.5b"])
def test_dense_lm_on_card_matches_cpu(cuda_device, name):
    """A reduced dense model with float32-cast weights: prefill, two
    decode steps and one unrolled step on the card against the same on
    the CPU; no kernel-wrapper launch; the unrolled step equal to the
    stacked one bit for bit."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map

    cfg = get_reduced(name)
    cpu = torch.device("cpu")
    p_cpu = tree_map(lambda a: a.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), cpu))
    p_gpu = tree_map(lambda a: a.to(cuda_device), p_cpu)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 19)))
    before = (wkv6.launches, ssd.launches)

    def run(params, dev):
        toks = tokens.to(dev)
        lg, st = M.prefill(params, cfg, toks[:, :16])
        st = _grow_cache(cfg, st, 2, 20, dev)
        out = [lg]
        for t in range(16, 18):
            lg, st = M.decode_step(params, cfg, toks[:, t:t + 1], st)
            out.append(lg)
        unrolled = {"len": st["len"].clone(), "main": {
            k: [a.clone() for a in v] for k, v in st["main"].items()}}
        lg_u, st_u = M.decode_step(params, cfg, toks[:, 18:], unrolled,
                                   unroll=True)
        lg, st = M.decode_step(params, cfg, toks[:, 18:], st)
        assert torch.equal(lg_u, lg)
        for k in ("k", "v"):
            assert torch.equal(torch.stack(st_u["main"][k]), st["main"][k])
        return out + [lg], st

    want, st_cpu = run(p_cpu, cpu)
    got, st_gpu = run(p_gpu, cuda_device)
    torch.cuda.synchronize()
    assert (wkv6.launches, ssd.launches) == before
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        torch.testing.assert_close(g.cpu(), w,
                                   **_recurrence_tol(torch.float32, w))
    for k in ("k", "v"):
        torch.testing.assert_close(st_gpu["main"][k].cpu().float(),
                                   st_cpu["main"][k].float(),
                                   rtol=2 ** -7, atol=1e-5)
    assert int(st_gpu["len"]) == 19


# -- programs the port schedules and verifies itself --------------------------

def _port_scheduled(method):
    """The SHD golden's partition scheduled, lowered and reported by the
    port with ``method``."""
    from repro_torch.core import passes
    gold = Program.load(GOLDEN / "shd_program_v1.npz")
    g, hw, part = gold.graph, gold.hw, gold.part
    tables = passes.schedule_pass(g, part, hw, method=method)
    passes.validate_pass(g, tables)
    report = passes.build_report(g, hw, tables, part, method="framework",
                                 compile_seconds=0.0, schedule_method=method)
    return Program(g, hw, tables, passes.lower_pass(g, tables), report, part)


@pytest.mark.parametrize("method", ["consecutive", "load_balance"])
@pytest.mark.parametrize("tier", ["fused", "lif"])
def test_port_scheduled_programs_run_bit_exact(cuda_device, method, tier):
    """Each strategy's program verifies clean and runs B = 8, T = 100 on
    the kernel tier (one ``fused_run``, the plane fitting; T
    ``lif_update_int``), bit-exact with the reference tier and the
    golden's recorded io (the schedule moves slots, not math)."""
    prog = _port_scheduled(method)
    assert prog.verify().ok
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        io = {k: np.concatenate([io[k], io[k]]) for k in io.files}
    kernel = fused_run if tier == "fused" else lif_update_int
    spec = ExecutionSpec(kernel=tier, device=str(cuda_device))
    before = kernel.launches
    got = prog.run(io["ext"], spec)
    assert kernel.launches - before == (1 if tier == "fused"
                                        else io["ext"].shape[1])
    assert_same_run(got, prog.run(io["ext"], ExecutionSpec(
        kernel="reference", device=str(cuda_device))), f"{method} {tier}")
    assert_same_run(got, (io["spikes"], io["v_final"],
                          packet_stats(io["packet_counts"])),
                    f"{method} {tier} recorded")


def test_verify_gate_refuses_before_any_capture(cuda_device):
    """A mutant (a stale score, MEM002; a send slot moved to 0,
    SCHED006) is refused by ``register(verify=True, precompile=...)``
    with ``ValueError``, and no engine or graph is built for it."""
    from repro_torch.serve import ProgramRegistry
    spec = ExecutionSpec(device=str(cuda_device))
    reg = ProgramRegistry()
    good = reg.load("shd", GOLDEN / "shd_program_v1.npz", verify=True,
                    precompile=(8,), timesteps=100, spec=spec)
    assert good.engine(spec)._graphs
    bad = Program.load(GOLDEN / "shd_program_v1.npz")
    bad.report.scores[0] += 1
    t = bad.tables
    t.send_slot[max(t.send_slot, key=t.send_slot.__getitem__)] = 0
    before = _snn_counts()
    with pytest.raises(ValueError, match="MEM002") as info:
        reg.register("bad", bad, verify=True, precompile=(8,),
                     timesteps=100, spec=spec)
    assert "SCHED006" in str(info.value)
    assert "bad" not in reg and not bad._engines
    assert _snn_counts() == before


# -- LM training on the card --------------------------------------------------

TRAIN_ARCHS = ["qwen2-1.5b", "rwkv6-3b", "zamba2-7b"]


def _train_case(name, dev, f32=True):
    """A reduced LM, its parameters cast to float32 (``f32``) or in their
    own dtypes, on the CPU and on ``dev`` (the same values), and a seeded
    2 x 24 batch for each."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map

    cfg = get_reduced(name)
    p_cpu = tree_map(lambda a: a.float() if f32 else a,
                     M.init_model(cfg, torch.Generator().manual_seed(0),
                                  "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    return (cfg, p_cpu, {"tokens": tokens, "labels": tokens},
            tree_map(lambda a: a.to(dev), p_cpu),
            {"tokens": tokens.to(dev), "labels": tokens.to(dev)})


def _leaves(tree):
    from repro_torch.models.model import tree_map
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_lm_train_step_on_card_matches_cpu(cuda_device, name):
    """A reduced model with float32-cast weights: ``loss_and_grads`` and
    one train step (``n_micro`` 2) on the card against the CPU, the loss
    within relative 1e-5 and each gradient within a relative norm of
    1e-4 (``tests/test_torch_lm_train.py``'s float32 bounds); the
    recurrences run their chunked forms, so no kernel launches."""
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         loss_and_grads, make_train_step)

    cfg, p_cpu, b_cpu, p_gpu, b_gpu = _train_case(name, cuda_device)
    hp = TrainHParams(loss_chunk=10, n_micro=2)
    before = (wkv6.launches, ssd.launches)
    (l_g, _, g_g), (l_c, _, g_c) = (loss_and_grads(p, cfg, b, hp) for p, b in
                                    ((p_gpu, b_gpu), (p_cpu, b_cpu)))
    assert abs(float(l_g) - float(l_c)) <= 1e-5 * abs(float(l_c))
    for a, b in zip(_leaves(g_g), _leaves(g_c)):
        assert a.is_cuda and bool(a.ne(0).any())
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())
    step = make_train_step(cfg, None, hp)
    (pg, _, mg), (pc, _, mc) = (step(p, init_opt_state(p, hp), b)
                                for p, b in ((p_gpu, b_gpu), (p_cpu, b_cpu)))
    torch.cuda.synchronize()
    assert (wkv6.launches, ssd.launches) == before
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-5 * abs(float(mc["loss"]))
    for a, b, p0 in zip(_leaves(pg), _leaves(pc), _leaves(p_cpu)):
        assert not torch.equal(a.cpu(), p0)                 # updated
        # Adam's first step moves each weight by lr * sign(g): at most
        # 2 lr apart where a gradient at rounding noise flips its sign
        assert float((a.cpu() - b).abs().max()) <= 2 * hp.lr * 1.001


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_remat_changes_no_bit_on_card(cuda_device, name):
    from repro_torch.train.steps import TrainHParams, loss_and_grads

    cfg, _, _, params, batch = _train_case(name, cuda_device, f32=False)
    (l1, _, g1), (l0, _, g0) = (
        loss_and_grads(params, cfg, batch,
                       TrainHParams(remat=remat, loss_chunk=10))
        for remat in (True, False))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(g1), _leaves(g0)))


def test_recurrence_kernels_refuse_grad(cuda_device):
    """``wkv6`` / ``ssd`` have no backward: an input that requires grad
    raises under grad mode, and launches under ``torch.no_grad()``."""
    dev = cuda_device
    r = torch.randn(1, 8, 1, 64, device=dev)
    w = (r, r, r, -torch.ones_like(r), torch.zeros(1, 64, device=dev),
         torch.zeros(1, 1, 64, 64, device=dev))
    x = torch.randn(1, 8, 1, 64, device=dev)
    s = (x, torch.ones(1, 8, 1, device=dev), torch.zeros(1, device=dev),
         torch.randn(1, 8, 64, device=dev), torch.randn(1, 8, 64, device=dev),
         torch.zeros(1, 1, 64, 64, device=dev))
    for fn, args in ((wkv6, w), (ssd, s)):
        leaf = args[0].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(leaf, *args[1:])
        before = fn.launches
        with torch.no_grad():
            y, _ = fn(leaf, *args[1:])
        assert fn.launches == before + 1 and not y.requires_grad


def test_checkpoint_of_card_tensors_restores_on_cpu(cuda_device, tmp_path):
    """A reduced qwen2-1.5b's (params, opt_state) on the card after one
    step, saved asynchronously; restored into a CPU tree bit for bit."""
    from repro_torch.distributed import CheckpointManager
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)

    cfg, p_cpu, _, params, batch = _train_case("qwen2-1.5b", cuda_device,
                                               f32=False)
    hp = TrainHParams(loss_chunk=8)
    params, opt, _ = make_train_step(cfg, None, hp)(
        params, init_opt_state(params, hp), batch)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(0, (params, opt))
    want = [t.cpu() for t in _leaves([params, opt.m, opt.v])]
    mgr.wait()
    like = (M.init_model(cfg, torch.Generator().manual_seed(3), "cpu"),
            init_opt_state(p_cpu, hp))
    (p2, o2), _ = mgr.restore(like)
    got = _leaves([p2, o2.m, o2.v])
    assert o2.step == 1 and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank nccl process group and its (1, 1) (data, model) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import init_distributed

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed("cuda", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_ruled_step_on_one_rank_equals_plain(cuda_device, nccl_mesh, name):
    from repro_torch.configs import SHAPES, get_reduced
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)

    cfg = get_reduced(name)
    rules = make_mesh_rules(nccl_mesh, pick_strategy(cfg, SHAPES["train_4k"]))
    hp = TrainHParams(loss_chunk=16, n_micro=2)
    runs = []
    for r in (rules, None):
        params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                              cuda_device)
        opt, step, losses = init_opt_state(params, hp), \
            make_train_step(cfg, r, hp), []
        for i in range(2):
            params, opt, met = step(params, opt, synthetic_batch(
                cfg, 4, 32, i, 0, cuda_device))
            losses.append(float(met["loss"]))
        runs.append((losses, params, opt))
    (l_r, p_r, o_r), (l_p, p_p, o_p) = runs
    assert l_r == l_p
    for a, b in zip(_leaves(p_r), _leaves(p_p)):
        assert a.to_local().device == cuda_device
        assert torch.equal(a.full_tensor(), b)
    for a, b in zip(_leaves(o_r.m), _leaves(o_p.m)):
        assert torch.equal(a.full_tensor(), b)
    assert o_r.step == o_p.step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(gather_tree(p_r)), _leaves(p_p)))


def test_reshard_tree_places_on_the_card(cuda_device, nccl_mesh):
    from repro_torch.distributed.elastic import reshard_tree
    tree = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "b": torch.ones(5), "step": 3}
    got = reshard_tree(tree, nccl_mesh)
    assert got["step"] == 3
    for k in ("w", "b"):
        assert got[k].to_local().device == cuda_device
    assert torch.equal(got["w"].full_tensor().cpu(),
                       torch.from_numpy(tree["w"]))


# -- the public wrappers (kernels/ops.py) and the dry run's counter -----------

@pytest.mark.parametrize("interpret", [None, False, True])
def test_ops_wrappers_on_card(cuda_device, interpret):
    """Each ``kernels.ops`` wrapper on the card equals its plain version
    within this file's tolerances; ``interpret=True`` runs the plain
    version on the card (no launch), else the kernel launches once."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s = (torch.rand((8, 513), device=cuda_device, generator=g) < 0.25
         ).float()
    w = torch.randn((513, 257), device=cuda_device, generator=g)
    v = torch.randn((32, 300), device=cuda_device, generator=g)
    cur = torch.randn((32, 300), device=cuda_device, generator=g) * 2.0
    vi = torch.randint(-50, 50, (17, 126), device=cuda_device,
                       dtype=torch.int32, generator=g)
    ci = torch.randint(-30, 30, (17, 126), device=cuda_device,
                       dtype=torch.int32, generator=g)
    p = LIFIntParams(2, 15, -3)
    rec = _wkv6_args(cuda_device, (2, 37, 3, 8), torch.float32)
    ssm = _ssd_args(cuda_device, (2, 29, 3, 4, 8), torch.float32)
    kw = {"interpret": interpret}
    fns = (spike_accum, lif_update, lif_update_int, wkv6, ssd)
    before = [f.launches for f in fns]
    cases = [
        (ops.spike_accum(s, w, block_b=16, **kw), (spike_accum_ref(s, w),),
         dict(rtol=1e-5, atol=1e-5)),
        (ops.lif_update(v, cur, alpha=0.25, v_reset=0.1, **kw),
         lif_update_ref(v, cur, 0.25, 1.0, 0.1), dict(rtol=0, atol=0)),
        (ops.lif_update_int(vi, ci, p, block=(16, 256), **kw),
         lif_update_int_ref(vi, ci, p), dict(rtol=0, atol=0)),
        (ops.wkv6(*rec, chunk=32, **kw), wkv6_ref(*rec), None),
        (ops.ssd(*ssm, chunk=16, **kw), ssd_ref(*ssm), None),
    ]
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == \
        [0 if interpret else 1] * len(fns)
    for got, want, tol in cases:
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want):
            assert a.device == cuda_device and a.dtype == b.dtype
            torch.testing.assert_close(
                a, b, **(tol or _recurrence_tol(torch.float32, b)))


def test_analyze_raises_around_a_kernel_launch(cuda_device):
    """A dispatch mode cannot see a ctypes launch: ``analyze`` of a
    reduced rwkv6-3b prefill through the ``wkv6`` kernel raises, naming
    it; the same prefill with ``kernels=False`` is counted."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models import model as M

    cfg = get_reduced("rwkv6-3b")
    params = M.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda_device)
    with pytest.raises(RuntimeError, match="wkv6"):
        analyze(M.prefill, params, cfg, tokens, kernels=True)
    _, counts = analyze(M.prefill, params, cfg, tokens, kernels=False)
    assert counts["flops"] > 0 and counts["peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["mnist", "shd"])
@pytest.mark.parametrize("kernel", ["fused", "lif"])
def test_paper_deploy_on_card_equals_the_cpu_oracle(cuda_device, net,
                                                    kernel):
    from repro_torch.configs.snn_paper import MNIST_HW, SHD_HW
    from repro_torch.launch.mnist_end_to_end import ROW_KEYS, deploy
    from repro_torch.snn import MNIST_CONFIG, QuantConfig
    cfg, hw, qcfg, b = ((MNIST_CONFIG, MNIST_HW, QuantConfig(4, 5), 64)
                        if net == "mnist" else
                        (SHD_CONFIG, SHD_HW, QuantConfig(7, 12), 8))
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(0)
    ext = (rng.random((b, cfg.timesteps, cfg.layer_sizes[0])) < 0.2
           ).astype(np.int32)
    labels = rng.integers(0, cfg.layer_sizes[-1], b)
    runs = [deploy(params, cfg, hw, qcfg, ext, labels=labels, spec=spec,
                   max_iters=2000)
            for spec in (ExecutionSpec(kernel=kernel, device="cuda"),
                         ExecutionSpec(engine="oracle", device="cpu"))]
    assert_same_run(runs[0]["outputs"], runs[1]["outputs"])
    assert runs[0]["program"].lowered.n_internal == cfg.layer_sizes[1] + \
        cfg.layer_sizes[-1]
    assert {k: runs[0][k] for k in ROW_KEYS} == \
        {k: runs[1][k] for k in ROW_KEYS}
