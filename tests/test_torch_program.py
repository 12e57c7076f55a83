"""Parity of the port's Program, lowering and engine with the JAX reference.

``repro_torch.core.Program`` (``load``/``from_arrays``, the re-lowered
``LoweredProgram``, ``run`` on the three kernel tiers) against
``repro.core.Program``: the golden artifacts field by field and against
their recorded outputs, and programs compiled in memory by the reference
(feedforward and recurrent) carried across with ``from_arrays``. Every
comparison is bit-exact: tolerance 0, dtypes included. The port runs on
the CPU here (``device="cpu"``): its kernels' plain versions.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_ext, make_feedforward, make_hw
from repro.core import ExecutionSpec as JaxSpec
from repro.core import HardwareConfig as JaxHardwareConfig
from repro.core import Program as JaxProgram
from repro.core import compile, random_graph
from repro_torch.core import ExecutionSpec, HardwareConfig, Program
from repro_torch.core.execution import as_spec
from torch_parity import artifact_arrays, assert_same_run, carry

GOLDEN = Path(__file__).parent / "golden"
TIERS = ("fused", "lif", "reference")
BATCHES = (1, 3, 8, 17)


def cpu(kernel=None) -> ExecutionSpec:
    return ExecutionSpec(kernel=kernel, device="cpu")


@pytest.fixture(scope="module")
def programs():
    ff = make_feedforward()
    rec = random_graph(12, 20, 160, seed=3)
    assert (rec.pre >= rec.n_inputs).any(), "graph must contain recurrence"
    return {kind: compile(g, make_hw(g), max_iters=4000)
            for kind, g in (("feedforward", ff), ("recurrent", rec))}


# -- the artifact -------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_load_matches_reference(name):
    path = GOLDEN / f"{name}_program_v1.npz"
    want, got = JaxProgram.load(path), Program.load(path)
    for f in dataclasses.fields(want.lowered):
        a, b = getattr(got.lowered, f.name), getattr(want.lowered, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    for f in dataclasses.fields(want.tables):
        a, b = getattr(got.tables, f.name), getattr(want.tables, f.name)
        if isinstance(b, np.ndarray):
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    for f in ("pre", "post", "weight"):
        assert getattr(got.graph, f).tobytes() == \
            getattr(want.graph, f).tobytes()
    assert tuple(got.graph.lif) == tuple(want.graph.lif)
    assert got.graph.output_slice == want.graph.output_slice
    assert dataclasses.asdict(got.hw) == dataclasses.asdict(want.hw)
    assert (got.feasible, got.ot_depth, got.n_inputs, got.n_synapses) == \
        (want.feasible, want.ot_depth, want.n_inputs, want.n_synapses)
    assert want.default_engine == "jax" and got.default_engine == "torch"


def test_from_arrays_keeps_report_and_partition_as_read():
    path = GOLDEN / "shd_program_v1.npz"
    with np.load(path) as z:
        header = json.loads(str(z["header"][()]))
        arrays = {k: z[k] for k in z.files if k != "header"}
    prog = Program.from_arrays(header, arrays)
    assert prog.report == header["report"] and prog.part == header["part"]
    for k, a in prog.meta_arrays.items():
        assert a.dtype == arrays[k].dtype
        assert a.tobytes() == arrays[k].tobytes(), k


@pytest.mark.parametrize("fault", ["no_header", "format", "version"])
def test_rejection_messages_match_reference(tmp_path, fault):
    path = tmp_path / "bad.npz"
    with np.load(GOLDEN / "tiny_program_v1.npz") as z:
        header = json.loads(str(z["header"][()]))
        arrays = {k: z[k] for k in z.files if k != "header"}
    if fault == "format":
        header["format"] = "something-else"
    elif fault == "version":
        header["version"] = 2
    if fault != "no_header":
        arrays["header"] = np.asarray(json.dumps(header))
    np.savez(path, **arrays)
    with pytest.raises(ValueError) as want:
        JaxProgram.load(path)
    with pytest.raises(ValueError) as got:
        Program.load(path)
    assert str(got.value) == str(want.value)


def test_hardware_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(HardwareConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(JaxHardwareConfig)]
    assert ours == theirs
    with pytest.raises(ValueError, match="power-of-two SPU count"):
        HardwareConfig(n_spus=12)
    with pytest.raises(ValueError, match="give both mesh dims"):
        HardwareConfig(n_chips=2, mesh_x=2)


# -- running ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "shd"])
@pytest.mark.parametrize("tier", TIERS)
def test_golden_recorded_outputs(name, tier):
    prog = Program.load(GOLDEN / f"{name}_program_v1.npz")
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        got = prog.run(io["ext"], cpu(tier))
        want = (io["spikes"], io["v_final"],
                {"packet_counts": io["packet_counts"],
                 "mean_packets_per_step": float(io["packet_counts"].mean())})
    assert_same_run(got, want, f"{name}/{tier}")


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
@pytest.mark.parametrize("tier", TIERS)
def test_tiers_match_reference(programs, kind, tier):
    ref = programs[kind]
    prog = carry(ref)
    for b in BATCHES:
        ext = make_ext(ref.graph, b, 7, seed=b)
        assert_same_run(prog.run(ext, cpu(tier)),
                        ref.run(ext, JaxSpec(kernel=tier)), f"{kind} B={b}")
    ext2 = make_ext(ref.graph, 1, 9, seed=99)[0]         # [T, n_inputs]
    got = prog.run(ext2, cpu(tier))
    assert got[0].shape == (9, ref.graph.n_internal)
    assert got[1].shape == (ref.graph.n_internal,)
    assert got[2]["packet_counts"].shape == (9,)
    assert_same_run(got, ref.run(ext2, JaxSpec(kernel=tier)), f"{kind} 2-D")


def test_shd_scale_matches_reference():
    path = GOLDEN / "shd_program_v1.npz"
    ref, prog = JaxProgram.load(path), Program.load(path)
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        ext = io["ext"][:2, :8]
        recorded_spikes = io["spikes"][:2, :8]
        recorded_pkts = io["packet_counts"][:2, :8]
    want = ref.run(ext, JaxSpec(kernel="fused"))
    np.testing.assert_array_equal(want[0], recorded_spikes)
    np.testing.assert_array_equal(want[2]["packet_counts"], recorded_pkts)
    for tier in TIERS:
        assert_same_run(prog.run(ext, cpu(tier)), want, tier)


@pytest.mark.parametrize("tier", TIERS)
def test_program_without_internal_neurons_counts_external_spikes(tier):
    """A program with no internal neuron (4 inputs, no synapse) does no
    neuron work; each step's packet count is its non-zero external
    spikes, as the reference's ``"reference"`` tier gives it."""
    from repro.core import SNNGraph as JaxGraph
    from repro.snn.lif import LIFIntParams as JaxLIFIntParams
    none = np.zeros(0, np.int32)
    ref = compile(JaxGraph(n_inputs=4, n_neurons=4, pre=none, post=none,
                           weight=none, lif=JaxLIFIntParams(2, 10, 0)),
                  JaxHardwareConfig())
    ext = np.ones((2, 3, 4), np.int32)
    want = ref.run(ext, JaxSpec(kernel="reference"))
    np.testing.assert_array_equal(want[2]["packet_counts"], [[4, 4, 4],
                                                             [4, 4, 4]])
    got = carry(ref).run(ext, cpu(tier))
    assert_same_run(got, want, tier)
    assert got[0].shape == (2, 3, 0) and got[1].shape == (2, 0)


def test_carried_program_shape_errors(programs):
    prog = carry(programs["feedforward"])
    with pytest.raises(ValueError, match=r"\[B, T, 16\] or \[T, 16\]"):
        prog.run(np.zeros((2, 3, 15), np.int32), cpu())


# -- execution spec, engines, warm-up -----------------------------------------

def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = Program.load(GOLDEN / "tiny_program_v1.npz")
    for spec in (None, ExecutionSpec(), ExecutionSpec(device="cuda")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            prog.run(np.zeros((4, 6), np.int32), spec)
    assert ExecutionSpec(device="cpu").resolve() == \
        ExecutionSpec(kernel="fused", device="cpu")


@pytest.mark.parametrize("engine,note", [("jax", "'torch'"),
                                         ("python", "Queue A item 3"),
                                         ("oracle", "Queue A item 3"),
                                         ("nope", "use one of")])
def test_spec_rejects_other_engines(engine, note):
    with pytest.raises(ValueError, match=note):
        ExecutionSpec(engine=engine)
    with pytest.raises(ValueError, match="unknown kernel"):
        ExecutionSpec(kernel="pallas")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ExecutionSpec(device="meta").resolve()
    with pytest.raises(TypeError):
        as_spec(3)


def test_engines_are_owned_and_keyed_on_resolved_spec():
    prog = Program.load(GOLDEN / "tiny_program_v1.npz")
    eng = prog.engine(cpu())
    assert prog.engine(cpu("fused")) is eng
    assert prog.engine(ExecutionSpec("torch", "fused", "cpu")) is eng
    assert prog.engine(cpu("lif")) is not eng
    assert prog.precompile((1, 4, 4), 5, cpu()) == [(1, 5), (4, 5)]
    assert prog.precompile([4, 1], 5, cpu()) == []
    assert prog.precompile((2,), 5, cpu()) == [(2, 5)]
    with pytest.raises(ValueError, match="positive batch sizes"):
        prog.precompile((0,), 5, cpu())


def test_load_precompiles_when_asked():
    path = GOLDEN / "tiny_program_v1.npz"
    prog = Program.load(path, precompile=(1, 2), timesteps=3, spec=cpu())
    assert prog.precompile((1, 2), 3, cpu()) == []
    with pytest.raises(ValueError, match="timesteps="):
        Program.load(path, precompile=(1,))


def test_artifact_arrays_round_trip_through_save(programs, tmp_path):
    """The in-memory carry and a saved file give the same port Program."""
    ref = programs["recurrent"]
    from_file = Program.load(ref.save(tmp_path / "rec"))
    header, arrays = artifact_arrays(ref)
    in_memory = Program.from_arrays(header, arrays)
    for f in dataclasses.fields(in_memory.lowered):
        a, b = getattr(in_memory.lowered, f.name), getattr(from_file.lowered,
                                                           f.name)
        assert (a.tobytes() == b.tobytes()) if isinstance(a, np.ndarray) \
            else a == b, f.name
    assert in_memory.hw == from_file.hw
