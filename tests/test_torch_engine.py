"""Parity of the port's executors and cycle/energy model with the JAX
package's ``repro.core.engine``.

``run_oracle`` (torch, here on the CPU), ``run_mapped`` (numpy, the
host simulator), ``oracle_packet_counts``, ``MergeAlignmentError``,
``CycleModel`` and ``PowerModel`` of ``repro_torch.core.engine`` against
their reference on the same inputs, made from a seed with numpy: the
golden artifacts (SHD: all samples for the oracle, sample 0 for the
simulator) and feedforward and recurrent programs compiled by the
reference at a small size. Tolerance 0 throughout, dtypes included;
reports are compared dataclass by dataclass.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_ext, make_feedforward, make_hw
from repro.configs.snn_paper import MNIST_HW
from repro.core import HardwareConfig as JaxHardwareConfig
from repro.core import Program as JaxProgram
from repro.core import compile, random_graph
from repro.core import engine as ref
from repro_torch.core import HardwareConfig, OpTables, Program, SNNGraph
from repro_torch.core import engine
from repro_torch.snn.lif import LIFIntParams
from torch_parity import carry

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def programs():
    ff = make_feedforward()
    rec = random_graph(12, 20, 160, seed=3)
    return {kind: compile(g, make_hw(g), max_iters=4000)
            for kind, g in (("feedforward", ff), ("recurrent", rec))}


def _golden(name):
    path = GOLDEN / f"{name}_program_v1.npz"
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        io = {k: io[k] for k in io.files}
    return JaxProgram.load(path), Program.load(path), io


def _same(got, want, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} [{i}]")


def _same_stats(got, want, what=""):
    _same((got["packet_counts"],), (want["packet_counts"],), what)
    assert got["mean_packets_per_step"] == want["mean_packets_per_step"]


def carry_graph(g) -> SNNGraph:
    """A reference ``SNNGraph`` as the port's."""
    return SNNGraph(g.n_inputs, g.n_neurons, g.pre, g.post, g.weight,
                    LIFIntParams(*g.lif), g.output_slice)


def _hw(hw) -> HardwareConfig:
    return HardwareConfig(**dataclasses.asdict(hw))


# -- the oracle -----------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_oracle_matches_reference_on_golden(name):
    want_p, got_p, io = _golden(name)
    ext = io["ext"] if io["ext"].ndim == 3 else io["ext"][None]
    got = engine.run_oracle(got_p.graph, ext, "cpu")
    for b in range(len(ext)):
        want = ref.run_oracle(want_p.graph, ext[b])
        _same((got[0][b], got[1][b]), want, f"{name} sample {b}")
    recorded = (io["spikes"], io["v_final"])
    if io["ext"].ndim == 2:
        recorded = (io["spikes"][None], io["v_final"][None])
    _same(got, recorded, f"{name} recorded")
    _same((engine.oracle_packet_counts(ext, got[0]),),
          (ref.oracle_packet_counts(ext, got[0]),), name)


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
def test_oracle_matches_reference_on_compiled(programs, kind):
    want_p = programs[kind]
    g = carry(want_p).graph
    ext = make_ext(want_p.graph, 5, 11, seed=7)
    got = engine.run_oracle(g, ext, "cpu")
    for b in range(5):
        _same((got[0][b], got[1][b]), ref.run_oracle(want_p.graph, ext[b]),
              f"{kind} sample {b}")
    # 2-D input gives 2-D output, the reference's shapes
    _same(engine.run_oracle(g, ext[0], "cpu"),
          ref.run_oracle(want_p.graph, ext[0]), f"{kind} 2-D")


def test_oracle_sums_non_binary_spikes_exactly():
    """Spikes outside {0, 1} and large weights: the int64 sum and its
    cast to int32 give the reference's bits (no float rounding)."""
    g = random_graph(6, 9, 40, seed=2)
    g.weight[:] = np.where(g.weight > 0, 2 ** 20, -(2 ** 20) + 3)
    ext = np.random.default_rng(4).integers(-3000, 3000, (3, 6, 6)
                                            ).astype(np.int32)
    got = engine.run_oracle(carry_graph(g), ext, "cpu")
    for b in range(3):
        _same((got[0][b], got[1][b]), ref.run_oracle(g, ext[b]), f"{b}")


def test_oracle_packet_counts_match_reference():
    g = random_graph(10, 14, 120, seed=1)
    ext = make_ext(g, 3, 9, seed=2)
    s = np.stack([ref.run_oracle(g, e)[0] for e in ext])
    _same((engine.oracle_packet_counts(ext, s),),
          (ref.oracle_packet_counts(ext, s),), "batched")
    _same((engine.oracle_packet_counts(ext[1], s[1]),),
          (ref.oracle_packet_counts(ext[1], s[1]),), "2-D")
    with pytest.raises(ValueError) as want:
        ref.oracle_packet_counts(ext[0, 0], np.zeros(3))
    with pytest.raises(ValueError) as got:
        engine.oracle_packet_counts(ext[0, 0], np.zeros(3))
    assert str(got.value) == str(want.value)


def test_oracle_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = carry_graph(random_graph(4, 5, 12, seed=0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        engine.run_oracle(g, np.zeros((3, 4), np.int32))


# -- the host simulator ---------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_mapped_matches_reference_on_golden(name):
    want_p, got_p, io = _golden(name)
    ext = io["ext"] if io["ext"].ndim == 2 else io["ext"][0]
    want = ref.run_mapped(want_p.graph, want_p.tables, ext,
                          routing=want_p.lowered.routing)
    got = engine.run_mapped(got_p.graph, got_p.tables, ext,
                            routing=got_p.lowered.routing)
    _same(got[:2], want[:2], name)
    _same_stats(got[2], want[2], name)
    pick = (lambda a: a) if io["ext"].ndim == 2 else (lambda a: a[0])
    _same((got[0], got[1], got[2]["packet_counts"]),
          (pick(io["spikes"]), pick(io["v_final"]),
           pick(io["packet_counts"])), f"{name} recorded")


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
@pytest.mark.parametrize("routing", [True, False])
def test_mapped_matches_reference_on_compiled(programs, kind, routing):
    want_p = programs[kind]
    got_p = carry(want_p)
    for b, e in enumerate(make_ext(want_p.graph, 3, 10, seed=11)):
        want = ref.run_mapped(want_p.graph, want_p.tables, e,
                              routing=want_p.lowered.routing if routing
                              else None)
        got = engine.run_mapped(got_p.graph, got_p.tables, e,
                                routing=got_p.lowered.routing if routing
                                else None)
        _same(got[:2], want[:2], f"{kind} {b}")
        _same_stats(got[2], want[2], f"{kind} {b}")
        _same(got[:2], ref.run_oracle(want_p.graph, e), f"{kind} oracle")


def test_merge_alignment_error_on_corrupted_schedule():
    """The corrupted schedule of the reference's system test: moving one
    Post-End op off its send slot trips the ME-tree alignment check in
    both packages alike, with the same message."""
    g = random_graph(10, 20, 150, seed=5)
    hw = JaxHardwareConfig(n_spus=4, unified_mem_depth=64, concentration=3,
                           max_neurons=64, max_post_neurons=32)
    tables = compile(g, hw, seed=0).tables
    m, _ = tables.pre.shape
    moved = False
    for spu in range(m):
        slots = np.flatnonzero(tables.post_end[spu])
        if len(slots) >= 2:
            a = int(slots[0])
            free = np.flatnonzero(tables.pre[spu] == -1)
            free = free[free != a]
            if len(free):
                t = int(free[0])
                for arr in (tables.pre, tables.post, tables.weight,
                            tables.pre_end, tables.post_end):
                    arr[spu, t] = arr[spu, a]
                    arr[spu, a] = -1 if arr is tables.pre else 0
                moved = True
                break
    assert moved, "the seeded schedule has a movable op"
    ported = OpTables.from_dense(tables.pre, tables.post, tables.weight,
                                 tables.pre_end, tables.post_end,
                                 tables.assign)
    ext = np.ones((2, g.n_inputs), np.int32)
    with pytest.raises(ref.MergeAlignmentError) as want:
        ref.run_mapped(g, tables, ext)
    with pytest.raises(engine.MergeAlignmentError) as got:
        engine.run_mapped(carry_graph(g), ported, ext)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, AssertionError)
    # without the check both run on to the same (wrong) result
    _same(engine.run_mapped(carry_graph(g), ported, ext,
                            check_alignment=False)[:2],
          ref.run_mapped(g, tables, ext, check_alignment=False)[:2],
          "unchecked")


# -- the cycle and power models -------------------------------------------

HWS = {
    "mnist": MNIST_HW,
    "shd": JaxHardwareConfig(n_spus=64, unified_mem_depth=256,
                             concentration=3, weight_bits=9,
                             potential_bits=18, max_neurons=1020,
                             max_post_neurons=320),
    "two_chips": JaxHardwareConfig(n_spus=8, n_chips=2,
                                   inter_chip_hop_cycles=5),
    "slow_clock": JaxHardwareConfig(n_spus=2, clock_mhz=37.5),
}


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("inter_chip", [False, True])
def test_cycle_model_matches_reference(hw, inter_chip):
    jhw = HWS[hw]
    rng = np.random.default_rng(len(hw))
    pkts = rng.integers(0, 400, 23)
    ic = rng.integers(0, 9, 23) if inter_chip else None
    for depth, n_syn in ((661, 92604), (1, 0), (1251, 33000)):
        want = ref.CycleModel(jhw).run(pkts, depth, n_syn,
                                       inter_chip_counts=ic)
        got = engine.CycleModel(_hw(jhw)).run(pkts, depth, n_syn,
                                              inter_chip_counts=ic)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert engine.CycleModel(_hw(jhw)).timestep_cycles(17, depth, 3) \
            == ref.CycleModel(jhw).timestep_cycles(17, depth, 3)
    power = dict(static_w=0.2, spu_dyn_w_per_bit=0.001, fabric_dyn_w=0.03)
    got = engine.CycleModel(_hw(jhw), engine.PowerModel(**power)).run(
        pkts, 50, 1000, inter_chip_counts=ic)
    want = ref.CycleModel(jhw, ref.PowerModel(**power)).run(
        pkts, 50, 1000, inter_chip_counts=ic)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_power_model_matches_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(
        engine.PowerModel)] == [(f.name, f.default) for f in
                                dataclasses.fields(ref.PowerModel)]
    assert [f.name for f in dataclasses.fields(engine.CycleReport)] == \
        [f.name for f in dataclasses.fields(ref.CycleReport)]
    for jhw in HWS.values():
        assert engine.PowerModel().total_w(_hw(jhw)) == \
            ref.PowerModel().total_w(jhw)


def test_mnist_paper_point_matches_reference():
    """The paper's MNIST point (OT depth 661, 10 x 130 packets, 92,604
    synapses) on the reference's ``MNIST_HW``: 149 us and 0.0256 mJ per
    image in the paper."""
    pkts = np.full(10, 130)
    got = engine.CycleModel(_hw(MNIST_HW)).run(pkts, 661, 92604)
    want = ref.CycleModel(MNIST_HW).run(pkts, 661, 92604)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert abs(got.latency_us - 149) / 149 < 0.05
    assert abs(got.energy_mj - 0.02563) / 0.02563 < 0.10


@pytest.mark.parametrize("fault", ["batched", "inter_chip_shape"])
def test_cycle_model_rejections_match_reference(fault):
    hw = JaxHardwareConfig(n_spus=4)
    args = ((np.ones((3, 10), np.int64), 50, 100) if fault == "batched"
            else (np.ones(10, np.int64), 50, 100))
    kw = {} if fault == "batched" else {"inter_chip_counts": np.ones(9)}
    with pytest.raises(ValueError) as want:
        ref.CycleModel(hw).run(*args, **kw)
    with pytest.raises(ValueError) as got:
        engine.CycleModel(_hw(hw)).run(*args, **kw)
    assert str(got.value) == str(want.value)
