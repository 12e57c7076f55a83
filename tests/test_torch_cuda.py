"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card
(the kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which ``test_torch_lif.py`` and ``test_torch_fused_step.py``
hold against the JAX reference). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bit-exact (tolerance 0) but float ``spike_accum``,
which sums in another order than ``torch.matmul``: float32 within
rtol = atol = 1e-5, bf16 within rtol 2e-2 / atol 1e-2 (TF32 off); and
``wkv6`` / ``ssd`` against their token-by-token plain versions: float32
within rtol 1e-4 and atol 1e-5 of the largest output (both sequential,
the sums over the state in another order, so the error scales with the
largest terms), bf16 inputs within 5e-2 (y rounded to bf16 after
float32 sums in another order), as ``chip_smoke.recurrence_tol``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionSpec, Program
from repro_torch.kernels.fused_step import (fused_launcher, fused_step,
                                            fused_step_emulated,
                                            fused_step_ref, pack_plane)
from repro_torch.kernels.lif_update import (lif_update, lif_update_int,
                                            lif_update_int_ref,
                                            lif_update_ref)
from repro_torch.kernels.ref import ssd_ref, wkv6_ref
from repro_torch.kernels.spike_accum import (spike_accum,
                                             spike_accum_emulated,
                                             spike_accum_ref)
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.snn.lif import LIFIntParams
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
    counts = (fused_step.launches, lif_update_int.launches)
    got = prog.run(ext, ExecutionSpec(kernel=tier))
    assert_same_run(got, want, f"{name}/{tier}")
    steps = ext.shape[-2]
    grew = (fused_step.launches - counts[0], lif_update_int.launches - counts[1])
    assert grew == {"fused": (steps, 0), "lif": (0, steps),
                    "reference": (0, 0)}[tier]


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
    kernels (3 spike_accum, 2 lif_update), the backward through none."""
    cfg = SHD_CONFIG
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((cfg.timesteps, 32, 700)) < 0.07
                         ).to(cuda_device, torch.float32)
    y = torch.from_numpy(rng.integers(0, 20, 32)).to(cuda_device)
    before = (spike_accum.launches, lif_update.launches)
    loss, counts, grads = loss_and_grads(params, x, y, cfg)
    torch.cuda.synchronize()
    grew = (spike_accum.launches - before[0], lif_update.launches - before[1])
    assert grew == (cfg.timesteps * 3, cfg.timesteps * 2)
    assert torch.isfinite(loss) and sorted(grads) == ["w0", "w1", "wr0"]
    assert all(bool(g.isfinite().all()) for g in grads.values())


def _recurrence_tol(dtype, want):
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))
    return dict(rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("shape", [(1, 8, 1, 8), (2, 37, 3, 8),
                                   (2, 64, 2, 16), (1, 129, 4, 32),
                                   (2, 100, 5, 64), (1, 1024, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel(cuda_device, shape, dtype):
    b, s, h, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(s)
    rnd = lambda *sz: torch.randn(sz, device=cuda_device, generator=g)
    r, k, v = (rnd(b, s, h, n).to(dtype) for _ in range(3))
    # S = 1024 takes a model's decay, near 1 (w0 = -6): a long memory
    w = -torch.exp(rnd(b, s, h, n) * 0.5 - 6.0) if s == 1024 \
        else -torch.exp(rnd(b, s, h, n) - 1.0)
    u = rnd(h, n) * 0.1
    st = rnd(b, h, n, n)                           # a non-zero state
    want = wkv6_ref(r, k, v, w, u, st)
    before = wkv6.launches
    got = wkv6(r, k, v, w, u, st)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(),
                                   **_recurrence_tol(dtype, e))


@pytest.mark.parametrize("shape", [(1, 8, 1, 4, 8), (2, 29, 3, 4, 8),
                                   (1, 64, 2, 16, 16), (2, 129, 3, 64, 64),
                                   (1, 37, 2, 128, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel(cuda_device, shape, dtype):
    b, s, h, p, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(s)
    rnd = lambda *sz: torch.randn(sz, device=cuda_device, generator=g)
    x = rnd(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a_log = torch.log(torch.arange(1, h + 1, device=cuda_device,
                                   dtype=torch.float32))
    bm, cm = rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)
    st = rnd(b, h, p, n)                           # a non-zero state
    want = ssd_ref(x, dt, a_log, bm, cm, st)
    before = ssd.launches
    got = ssd(x, dt, a_log, bm, cm, st)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(),
                                   **_recurrence_tol(dtype, e))


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
