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


def _assert_fields_equal(got, want, what):
    """Dataclass ``got`` (the port's) equals ``want`` (the reference's)
    field by field: arrays by dtype and bytes, nested dataclasses
    recursively, everything else by ``==``."""
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)], what
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (what, f.name)
        elif dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), \
                (what, f.name)
        else:
            assert a == b, (what, f.name)


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_from_arrays_keeps_report_and_partition_as_read(name):
    """The ported ``CompileReport`` and ``PartitionResult`` built by
    ``from_arrays`` equal the reference's ``Program.load`` field by
    field."""
    path = GOLDEN / f"{name}_program_v1.npz"
    with np.load(path) as z:
        header = json.loads(str(z["header"][()]))
        arrays = {k: z[k] for k in z.files if k != "header"}
    prog, want = Program.from_arrays(header, arrays), JaxProgram.load(path)
    _assert_fields_equal(prog.report, want.report, "report")
    _assert_fields_equal(prog.part, want.part, "part")
    assert prog.feasible is want.feasible is True


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
                                         ("python", 'device="cpu"'),
                                         ("oracle", 'device="cpu"'),
                                         ("nope", "use one of")])
def test_spec_rejects_other_engines(monkeypatch, engine, note):
    """Unknown engines are rejected; ``"python"`` runs on the CPU only
    and must be asked for with ``device="cpu"``; ``"oracle"`` resolves
    like ``"torch"``, to the card (absent here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if engine == "oracle":
        with pytest.raises(RuntimeError, match=note):
            ExecutionSpec(engine=engine).resolve()
        assert ExecutionSpec(engine, device="cpu").resolve() == \
            ExecutionSpec(engine, None, "cpu")
    else:
        with pytest.raises(ValueError, match=note):
            ExecutionSpec(engine=engine)
    if engine == "python":
        with pytest.raises(ValueError, match=note):
            ExecutionSpec(engine, device="cuda")
        assert ExecutionSpec(engine, device="cpu").resolve().kernel is None
    if engine in ("python", "oracle"):
        with pytest.raises(ValueError, match="does not apply"):
            ExecutionSpec(engine, kernel="fused", device="cpu")
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
    assert eng._graphs == {}             # the CPU engine stays eager
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


# -- the python and oracle engines ---------------------------------------------

PYTHON = ExecutionSpec(engine="python", device="cpu")
ORACLE = ExecutionSpec(engine="oracle", device="cpu")


@pytest.mark.parametrize("name", ["tiny", "shd"])
@pytest.mark.parametrize("engine", ["python", "oracle"])
def test_engines_reproduce_golden(name, engine):
    """``"python"`` and ``"oracle"`` give the reference's ``run`` and the
    recorded io bit for bit, dtypes included (SHD: sample 0 for the host
    simulator, every sample for the oracle)."""
    path = GOLDEN / f"{name}_program_v1.npz"
    with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
        io = {k: io[k] for k in io.files}
    ext, recorded = io["ext"], (io["spikes"], io["v_final"],
                                io["packet_counts"])
    if engine == "python" and ext.ndim == 3:
        ext, recorded = ext[0], tuple(a[0] for a in recorded)
    got = Program.load(path).run(ext, PYTHON if engine == "python"
                                 else ORACLE)
    assert_same_run(got, JaxProgram.load(path).run(ext, engine), name)
    assert_same_run(got, recorded[:2] + ({
        "packet_counts": recorded[2],
        "mean_packets_per_step": float(recorded[2].mean())},), name)


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
@pytest.mark.parametrize("engine", ["python", "oracle"])
def test_engines_match_reference(programs, kind, engine):
    ref = programs[kind]
    prog = carry(ref)
    spec = PYTHON if engine == "python" else ORACLE
    for b in (1, 3, 8):
        ext = make_ext(ref.graph, b, 7, seed=b)
        got = prog.run(ext, spec)
        assert_same_run(got, ref.run(ext, engine), f"{kind} B={b}")
        assert_same_run(got, prog.run(ext, cpu("fused")), f"{kind} fused")
    ext2 = make_ext(ref.graph, 1, 9, seed=99)[0]
    assert_same_run(prog.run(ext2, spec), ref.run(ext2, engine), "2-D")
    with pytest.raises(ValueError, match=r"\[B, T, "):
        prog.run(np.zeros((2, 3, 1), np.int32), spec)


def test_engine_builds_only_the_torch_engine(monkeypatch):
    prog = Program.load(GOLDEN / "tiny_program_v1.npz")
    with pytest.raises(ValueError, match="torch engine"):
        prog.engine(ORACLE)
    with pytest.raises(ValueError, match="torch engine"):
        prog.precompile((1,), 4, PYTHON)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prog.run(np.zeros((4, 6), np.int32), "oracle")
    with pytest.raises(ValueError, match='device="cpu"'):
        prog.run(np.zeros((4, 6), np.int32), "python")


def test_later_slices_raise():
    """The verifier and the multi-chip accounting, once later slices,
    now run: on the single-chip golden the verifier is clean and every
    chip term is zero (``tests/test_torch_verify.py`` and
    ``tests/test_torch_multichip.py`` hold them to the reference)."""
    prog = Program.load(GOLDEN / "tiny_program_v1.npz")
    assert prog.verify().ok
    assert set(np.unique(prog.chip_span())) <= {0, 1}
    assert not prog.mesh_hops().any()
    ext = np.ones((3, prog.n_inputs), np.int32)
    s, _, _ = prog.run(ext, ORACLE)
    assert not prog.inter_chip_counts(ext, s).any()


# -- profile, init packets, content hash ---------------------------------------

def _loaded_and_carried(programs, name):
    if name in ("tiny", "shd"):
        path = GOLDEN / f"{name}_program_v1.npz"
        return JaxProgram.load(path), Program.load(path)
    return programs[name], carry(programs[name])


def _assert_profile_equal(got, want, what):
    assert dataclasses.asdict(got.cycle) == dataclasses.asdict(want.cycle), \
        what
    assert [dataclasses.asdict(r) for r in got.per_sample] == \
        [dataclasses.asdict(r) for r in want.per_sample], what
    assert dataclasses.asdict(got.resources) == \
        dataclasses.asdict(want.resources), what
    for f in ("latency_us", "power_w", "energy_mj", "energy_per_synapse_nj"):
        assert getattr(got, f) == getattr(want, f), (what, f)


@pytest.mark.parametrize("name", ["tiny", "shd", "feedforward", "recurrent"])
def test_profile_matches_reference(programs, name):
    """``ProfileReport`` equal to the reference's, batched and unbatched,
    with the ``n_synapses=`` override, a power model and
    ``inter_chip_counts``; a raw packet-count array as the stats dict."""
    want_p, got_p = _loaded_and_carried(programs, name)
    rng = np.random.default_rng(3)
    ext = (rng.random((3, 9, got_p.n_inputs)) < 0.3).astype(np.int32)
    _, _, st = got_p.run(ext, cpu("reference"))
    ic = rng.integers(0, 4, st["packet_counts"].shape)
    from repro.core.engine import PowerModel as JaxPowerModel
    from repro_torch.core import PowerModel
    power = dict(static_w=0.3, spu_dyn_w_per_bit=0.002, fabric_dyn_w=0.01)
    for kw_got, kw_want in (
            ({}, {}),
            ({"n_synapses": 2 * got_p.n_synapses},
             {"n_synapses": 2 * want_p.n_synapses}),
            ({"power": PowerModel(**power)},
             {"power": JaxPowerModel(**power)}),
            ({"inter_chip_counts": ic}, {"inter_chip_counts": ic})):
        _assert_profile_equal(got_p.profile(st, **kw_got),
                              want_p.profile(st, **kw_want), (name, kw_got))
        one = {k: (v[0] if isinstance(v, np.ndarray) else v)
               for k, v in kw_got.items()}
        one_w = {k: (v[0] if isinstance(v, np.ndarray) else v)
                 for k, v in kw_want.items()}
        got1 = got_p.profile(st["packet_counts"][0], **one)
        _assert_profile_equal(got1, want_p.profile(
            st["packet_counts"][0], **one_w), (name, "unbatched"))
        assert got1.cycle == got1.per_sample[0]
    with pytest.raises(ValueError, match="inter_chip_counts shape"):
        got_p.profile(st, inter_chip_counts=ic[:, :3])


@pytest.mark.parametrize("name", ["tiny", "shd", "feedforward", "recurrent"])
def test_init_packets_and_content_hash_match_reference(programs, name):
    want_p, got_p = _loaded_and_carried(programs, name)
    pkts = got_p.init_packets()
    assert pkts == want_p.init_packets()
    assert len(pkts) == got_p.report.n_init_packets
    assert got_p.content_hash() == want_p.content_hash()
    if name == "shd":
        assert got_p.content_hash() == ("2b2916b301a3678ffa1bf4427c59838b"
                                        "de159f778e00f7ab9df3106cff54ee01")


# -- save ------------------------------------------------------------------------

def _assert_same_file(a_path, b_path):
    """Same members, equal parsed JSON headers, equal bytes and dtypes of
    every array (``savez_compressed`` stamps members with the clock, so
    two saves' file bytes differ, the reference's own included)."""
    with np.load(a_path) as a, np.load(b_path) as b:
        assert set(a.files) == set(b.files)
        assert json.loads(str(a["header"][()])) == \
            json.loads(str(b["header"][()]))
        for k in a.files:
            if k != "header":
                assert a[k].dtype == b[k].dtype, k
                assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def more_programs():
    """A two-chip compile (post-v1 hw fields in the header) and a
    portfolio compile (a search trace in the header)."""
    from repro.core.mapping.search import SearchConfig
    g = random_graph(12, 20, 160, seed=3)
    return {"two_chips": compile(g, make_hw(g), max_iters=4000, n_chips=2),
            "portfolio": compile(g, make_hw(g), search=SearchConfig(
                restarts=2, max_iters=2000))}


@pytest.mark.parametrize("name", ["tiny", "shd", "feedforward", "recurrent",
                                  "two_chips", "portfolio"])
def test_save_matches_reference(programs, more_programs, name, tmp_path):
    """The port's save gives the reference's header and arrays (and the
    golden file's); each package loads the other's file."""
    want_p, got_p = _loaded_and_carried({**programs, **more_programs}, name)
    ours = got_p.save(tmp_path / "ours")
    theirs = want_p.save(tmp_path / "theirs.npz")
    assert ours.name == "ours.npz"
    _assert_same_file(ours, theirs)
    if name in ("tiny", "shd"):
        _assert_same_file(ours, GOLDEN / f"{name}_program_v1.npz")
    back = JaxProgram.load(ours)
    assert back.default_engine == "jax"
    assert back.content_hash() == want_p.content_hash()
    assert back.init_packets() == want_p.init_packets()
    again = Program.load(theirs)
    assert again.default_engine == "torch"
    _assert_fields_equal(again.report, got_p.report, "report")
    _assert_fields_equal(again.part, got_p.part, "part")
    assert again.hw == got_p.hw and again.content_hash() == \
        got_p.content_hash()
    rng = np.random.default_rng(8)
    ext = (rng.random((2, 6, got_p.n_inputs)) < 0.3).astype(np.int32)
    assert_same_run(again.run(ext, cpu()), back.run(ext, "python"), name)
