"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a card
(the kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which ``test_torch_lif.py`` and ``test_torch_fused_step.py``
hold against the JAX reference). This file imports neither jax nor the
JAX package, so it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bit-exact: tolerance 0.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionSpec, Program
from repro_torch.kernels.fused_step import fused_step, fused_step_ref
from repro_torch.kernels.lif_update import lif_update_int, lif_update_int_ref
from repro_torch.snn.lif import LIFIntParams
from torch_parity import assert_same_run, cuda_device, to_torch  # noqa: F401

pytestmark = pytest.mark.cuda

GOLDEN = Path(__file__).parent / "golden"
PARAMS = {1: (1, 15, 0), 3: (2, 40, -5), 8: (4, 0, 0), 17: (1, -3, 2)}


@pytest.mark.parametrize("plane", [(784, 126, np.int8, 127),
                                   (700, 320, np.int16, 1000),
                                   (37, 29, np.int32, 100_000)])
@pytest.mark.parametrize("b", sorted(PARAMS))
def test_fused_step_kernel(cuda_device, plane, b):
    n_ext, n_int, dtype, wmax = plane
    rng = np.random.default_rng(b)
    w = rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)).astype(dtype)
    ext = rng.random((b, n_ext)) < 0.15
    prev = rng.random((b, n_int)) < 0.35            # recurrent input
    v = rng.integers(-3000, 3000, (b, n_int))
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
