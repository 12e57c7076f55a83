"""Parity of the port's whole-run fused kernel with the JAX reference.

``repro_torch.kernels.fused_step.fused_run`` runs all T steps of a run
in one launch of ``csrc/fused_run.cu`` on the card; on the CPU it runs
its plain version ``fused_run_ref``. Here ``fused_run_ref``,
``fused_run_emulated`` (the kernel's decomposition replayed in plain
torch: post tiles split over a cluster's ranks, K-steps over warps, the
skip / tensor-core / exact rules) and the port's fused engine are held
to the reference's ``JaxMappedEngine`` on its ``"fused"`` tier (its
compiled scan over the Pallas ``fused_step``, in interpret mode on the
CPU): spikes, ``v_final`` and packet counts, bit for bit (tolerance 0).
Inputs come from numpy seeds: the SHD golden at B = 8, T = 100, and
random int8, int16 and int32 planes at B in {1, 3, 8, 9, 17} and T in
{1, 2, 7}, with non-binary external spikes, non-positive thresholds and
internal widths that are not a multiple of 16. The shape rule's Python
mirror (``run_smem_bytes``, ``fused_path``) is checked on the SHD and
MNIST planes, which fit, and on planes too large for a cluster, which
take the per-step kernel.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels.fused_step as torch_fused
from repro.core import ExecutionSpec as JaxSpec
from repro.core import JaxMappedEngine
from repro.core import Program as JaxProgram
from repro.core.graph import SNNGraph as JaxGraph
from repro.core.scheduling import LoweredProgram as JaxLowered
from repro.snn.lif import LIFIntParams as JaxLIFIntParams
from repro_torch.core import ExecutionSpec, Program, TorchMappedEngine
from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling import LoweredProgram
from repro_torch.kernels.fused_step import (fused_path, fused_run,
                                            fused_run_emulated,
                                            fused_run_ref, pack_dense,
                                            pack_plane, run_smem_bytes,
                                            run_split, run_tiles)
from repro_torch.snn.lif import LIFIntParams
from torch_parity import to_torch

GOLDEN = Path(__file__).parent / "golden"
CPU = ExecutionSpec(kernel="fused", device="cpu")
# dtype -> (n_ext, n_int, weight bound): n_int off multiples of 16; the
# int16 plane's 150 posts are 10 tiles over 8 ranks (uneven), its 163
# pre neurons 6 K-steps with the ext / internal boundary inside one
PLANES = {"int8": (37, 29, 127), "int16": (13, 150, 1000),
          "int32": (41, 21, 100_000)}
T_OF_B = {1: 7, 3: 1, 8: 2, 9: 7, 17: 2}
PARAMS = {1: (1, 15, 0), 3: (2, 0, -5), 8: (4, 40, 0), 9: (2, -3, 1),
          17: (1, 7, 2)}
ODD_SPIKES = [2, -1, 300, 2 ** 20]


def _lowered(cls, w: np.ndarray, n_ext: int):
    """A lowered program whose dense plane is ``w`` (one op per non-zero
    entry), as either package's ``LoweredProgram``."""
    pre, post = np.nonzero(w)
    none = np.zeros(len(pre), np.int32)
    return cls(n_inputs=n_ext, n_neurons=w.shape[0], n_internal=w.shape[1],
               n_spus=1, depth=len(pre), op_spu=none, op_slot=none,
               op_pre=pre.astype(np.int32), op_post_local=post.astype(np.int32),
               op_weight=w[pre, post].astype(np.int32),
               op_pre_end=np.zeros(len(pre), bool),
               op_post_end=np.zeros(len(pre), bool),
               routing=np.zeros((w.shape[0], 1), bool))


def _engines(w: np.ndarray, n_ext: int, params):
    """The reference's fused-tier engine and the port's, on the CPU, over
    the program whose plane is ``w``."""
    lw_j, lw_t = _lowered(JaxLowered, w, n_ext), _lowered(LoweredProgram, w,
                                                          n_ext)
    g = dict(n_inputs=n_ext, n_neurons=w.shape[0], pre=lw_t.op_pre,
             post=lw_t.op_post_local + n_ext, weight=lw_t.op_weight)
    jax_eng = JaxMappedEngine(JaxGraph(**g, lif=JaxLIFIntParams(*params)),
                              lw_j, JaxSpec(kernel="fused"))
    port = TorchMappedEngine(SNNGraph(**g, lif=LIFIntParams(*params)), lw_t,
                             CPU)
    return jax_eng, port


def _case(dtype: str, b: int, seed: int):
    n_ext, n_int, wmax = PLANES[dtype]
    rng = np.random.default_rng(seed)
    w = rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int))
    w[w == 0] = 1
    w = w.astype(dtype)
    ext = (rng.random((b, T_OF_B[b], n_ext)) < 0.3).astype(np.int32)
    odd = rng.random(ext.shape) < 0.1                # non-binary spikes
    ext = np.where(odd, rng.choice(ODD_SPIKES, ext.shape), ext)
    return w, ext.astype(np.int32)


def _as_run(got):
    """Engine output ``(spikes [B, T, n], v, stats)`` as fused_run's
    ``(spikes [T, B, n], v_final, packets [T, B])``."""
    spikes, v, stats = got
    return (np.asarray(spikes).transpose(1, 0, 2), np.asarray(v),
            np.asarray(stats["packet_counts"]).T.astype(np.int32))


def _same(got, want, what):
    for name, a, b in zip(("spikes", "v_final", "packets"), got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


@pytest.mark.parametrize("b", sorted(T_OF_B))
@pytest.mark.parametrize("dtype", sorted(PLANES))
def test_fused_run_matches_reference_engine(dtype, b):
    seed = sorted(PLANES).index(dtype) * 100 + b
    w, ext = _case(dtype, b, seed)
    n_ext = ext.shape[2]
    params = PARAMS[b]
    jax_eng, port = _engines(w, n_ext, params)
    assert pack_dense(port.lowered).weight.tobytes() == w.tobytes()
    want = _as_run(jax_eng.run(ext))
    p = LIFIntParams(*params)
    ext_t = to_torch(ext.transpose(1, 0, 2))
    wt = torch.from_numpy(w)
    _same(fused_run_ref(ext_t, wt, p), want, "fused_run_ref")
    _same(fused_run_emulated(ext_t, pack_plane(wt), p), want,
          "fused_run_emulated")
    _same(fused_run(ext_t, wt, p), want, "fused_run")
    assert port.fused_path == "run"
    _same(_as_run(port.run(ext)), want, "port engine")


def test_shd_golden_run_matches_reference_engine():
    """The SHD golden at B = 8, T = 100 (its recorded trains twice): the
    reference's fused engine, the recorded io, ``fused_run_ref``,
    ``fused_run_emulated`` and the port's fused engine (the run path)."""
    path = GOLDEN / "shd_program_v1.npz"
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        io = {k: np.concatenate([io[k]] * 2) for k in io.files}
    ref = JaxProgram.load(path)
    want = _as_run(JaxMappedEngine(ref.graph, ref.lowered,
                                   JaxSpec(kernel="fused")).run(io["ext"]))
    _same(want, (io["spikes"].transpose(1, 0, 2), io["v_final"],
                 io["packet_counts"].T.astype(np.int32)), "recorded io")
    prog = Program.load(path)
    w = torch.from_numpy(pack_dense(prog.lowered).weight)
    assert w.dtype == torch.int16 and tuple(w.shape) == (1020, 320)
    p = prog.graph.lif
    ext_t = to_torch(io["ext"].transpose(1, 0, 2))
    _same(fused_run_ref(ext_t, w, p), want, "fused_run_ref")
    _same(fused_run_emulated(ext_t, pack_plane(w), p), want,
          "fused_run_emulated")
    eng = prog.engine(CPU)
    assert eng.fused_path == "run"
    _same(_as_run(eng.run(io["ext"])), want, "port engine")


@pytest.mark.parametrize("kind,n_ext,n_int,fits", [
    (2, 700, 320, True),        # the SHD net's int16 plane: 177,280 bytes
    (1, 784, 126, True),        # the MNIST net's int8 plane
    (1, 700, 320, True),        # the paper SHD SRNN's int8 plane
    (4, 700, 320, False),       # the SHD shape as int32: 274,816 bytes
    (2, 3000, 64, False),       # 3,000 inputs: the staged ext is too wide
    (1, 500, 1500, False),      # the 10^5-synapse program's plane
])
def test_shape_rule_mirror(kind, n_ext, n_int, fits):
    smem = run_smem_bytes(kind, n_ext, n_int)
    assert (smem <= torch_fused.RUN_SMEM_LIMIT) == fits
    w = torch.zeros((n_ext + n_int, n_int),
                    dtype={1: torch.int8, 2: torch.int16, 4: torch.int32}[kind])
    assert fused_path(w, n_ext) == ("run" if fits else "step")
    assert fused_path(pack_plane(w), n_ext) == ("run" if fits else "step")
    if (kind, n_ext, n_int) == (2, 700, 320):
        assert smem == 177280
    m_tiles = -(-n_int // 16)
    ranges = run_tiles(m_tiles)
    assert len(ranges) == run_split(m_tiles) <= 8
    assert ranges[0][0] == 0 and ranges[-1][1] == m_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_engine_steps_where_the_plane_does_not_fit(monkeypatch):
    """A plane too large for a cluster takes the per-step path, with the
    same bits: an int32 plane of the SHD shape against the reference's
    fused engine. The engine reads the rule's limit at build: the SHD
    golden with the limit forced to 0 shows ``"step"``."""
    rng = np.random.default_rng(3)
    w = rng.integers(-100_000, 100_000, (1020, 320)).astype(np.int32)
    w[w == 0] = 1
    ext = (rng.random((3, 2, 700)) < 0.2).astype(np.int32)
    jax_eng, port = _engines(w, 700, (2, 50, -4))
    assert port.fused_path == "step"
    _same(_as_run(port.run(ext)), _as_run(jax_eng.run(ext)), "int32 step")
    prog = Program.load(GOLDEN / "shd_program_v1.npz")
    assert prog.engine(CPU).fused_path == "run"
    monkeypatch.setattr(torch_fused, "RUN_SMEM_LIMIT", 0)
    stepped = TorchMappedEngine(prog.graph, prog.lowered, CPU)
    assert stepped.fused_path == "step"


def test_fused_run_writes_outputs_and_starts_from_zero():
    w, ext = _case("int16", 3, 5)
    p = LIFIntParams(*PARAMS[3])
    ext_t = to_torch(ext.transpose(1, 0, 2))
    t_steps, b, _ = ext_t.shape
    n_int = w.shape[1]
    outs = (torch.full((t_steps, b, n_int), 9, dtype=torch.int32),
            torch.full((b, n_int), 9, dtype=torch.int32),
            torch.full((t_steps, b), 9, dtype=torch.int32))
    got = fused_run(ext_t, torch.from_numpy(w), p, spikes_out=outs[0],
                    v_out=outs[1], pkt_out=outs[2])
    assert all(g is o for g, o in zip(got, outs))
    _same(got, [a.numpy() for a in fused_run_ref(ext_t, torch.from_numpy(w),
                                                  p)], "outputs")
    empty = fused_run(ext_t[:0], torch.from_numpy(w), p)
    assert [tuple(a.shape) for a in empty] == [(0, b, n_int), (b, n_int),
                                               (0, b)]
    assert not empty[1].any()


@pytest.mark.parametrize("bad", ["ext_2d", "weight_rows", "weight_dtype",
                                 "ext_dtype", "v_out", "pkt_out", "strided"])
def test_fused_run_rejects(bad):
    ext = torch.zeros((4, 3, 5), dtype=torch.int32)
    w = torch.zeros((9, 4), dtype=torch.int8)
    kw = {}
    if bad == "ext_2d":
        ext = ext[0]
    elif bad == "weight_rows":
        w = torch.zeros((8, 4), dtype=torch.int8)
    elif bad == "weight_dtype":
        w = w.to(torch.float32)
    elif bad == "ext_dtype":
        ext = ext.to(torch.int64)
    elif bad == "v_out":
        kw["v_out"] = torch.zeros((3, 5), dtype=torch.int32)
    elif bad == "pkt_out":
        kw["pkt_out"] = torch.zeros((3, 4), dtype=torch.int32)
    else:
        ext = torch.zeros((4, 5, 3), dtype=torch.int32).transpose(1, 2)
    with pytest.raises(ValueError):
        fused_run(ext, w, LIFIntParams(1, 1, 0), **kw)
