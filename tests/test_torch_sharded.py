"""Parity of the port's sharded runner with the JAX reference.

``repro_torch.serve.ShardedRunner`` on ``mesh=("cpu",) * k`` (k shards
run one after another on the CPU, the stand-in for the reference's
forced host devices) against the port's single engine and the
reference's ``program.run`` on the same programs (compiled by the
reference and carried over) and ragged batches: spikes, ``v_final``
and packet counts bit-exact (tolerance 0), with and without the
small-batch fallback (``min_shard=0`` forces the shard path). Mirrors
the sharded tests of ``tests/test_serving.py``.
"""
import numpy as np
import pytest

from conftest import make_ext, make_feedforward, make_hw
from repro.core import compile, random_graph
from repro_torch.core import ExecutionSpec
from repro_torch.serve import ProgramRegistry, ShardedRunner, sharded_runner
from torch_parity import assert_same_run, carry

CPU = ExecutionSpec(device="cpu")
MESHES = [("cpu",) * k for k in (1, 2, 3, 4)]


def ragged_sizes(d: int) -> list[int]:
    """1, D-1, D, 3D+1 for D shards (deduplicated), as the reference's."""
    return sorted({1, max(1, d - 1), d, 3 * d + 1})


@pytest.fixture(scope="module")
def programs():
    ff = make_feedforward()
    rec = random_graph(12, 20, 160, seed=3)
    ref = {"feedforward": compile(ff, make_hw(ff), max_iters=4000),
           "recurrent": compile(rec, make_hw(rec), max_iters=4000)}
    return {k: (p, carry(p)) for k, p in ref.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{len(m)}shards")
@pytest.mark.parametrize("min_shard", [1, 0])
@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
def test_sharded_bit_exact_ragged_batches(programs, kind, min_shard, mesh):
    ref, port = programs[kind]
    runner = ShardedRunner(port, spec=ExecutionSpec(mesh=mesh),
                           min_shard=min_shard)
    assert runner.n_shards == len(mesh)
    for b in ragged_sizes(len(mesh)) + [2 * len(mesh) - 1]:
        ext = make_ext(ref.graph, b, 12, seed=b)
        want = ref.run(ext)                           # the reference, jax
        one = port.run(ext, CPU)                      # the port, one engine
        assert_same_run(one, want, f"{kind} B={b} one engine")
        assert_same_run(runner.run(ext), want, f"{kind} B={b} sharded")
        assert_same_run(port.run(ext, ExecutionSpec(mesh=mesh)), want,
                        f"{kind} B={b} Program.run(mesh=)")


def test_sharded_unbatched_input_squeezes(programs):
    ref, port = programs["recurrent"]
    ext = make_ext(ref.graph, 1, 9, seed=1)[0]       # [T, n_in]
    want = ref.run(ext)
    for mesh in (("cpu",), ("cpu",) * 3):
        got = port.run(ext, ExecutionSpec(mesh=mesh))
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        assert_same_run(got, want, f"{len(mesh)} shards")
        forced = ShardedRunner(port, spec=ExecutionSpec(mesh=mesh),
                               min_shard=0)
        assert_same_run(forced.run(ext), want, f"{len(mesh)} forced")


def test_sharded_runner_owned_and_cached(programs):
    _, port = programs["recurrent"]
    r1 = port.sharded_runner(ExecutionSpec(mesh="auto"))
    assert port.sharded_runner(ExecutionSpec(mesh="auto")) is r1
    mesh = ("cpu",) * 3
    assert port.sharded_runner(mesh) is port.sharded_runner(
        ExecutionSpec(mesh=list(mesh)))              # bare form, a list
    r3 = port.sharded_runner(mesh)
    assert r3.n_shards == 3 and r3.mesh == mesh
    assert r3.padded_size(1) == 3                    # pad-and-mask rule
    assert r3.padded_size(3 * 3 + 1) == 4 * 3
    # one engine per device, the program's own: every shard and the
    # fallback run on the single-device engine of "cpu"
    assert {id(e) for e in r3._shard_engines} == {id(port.engine(CPU))}
    assert r3._engine is port.engine(CPU)
    assert isinstance(sharded_runner(port, mesh), ShardedRunner)


def test_sharded_precompile_mirrors_routing(programs):
    _, port = programs["feedforward"]
    runner = ShardedRunner(port, spec=ExecutionSpec(mesh=("cpu",) * 2))
    # B=1 is below n_shards * min_shard: the single engine warms it; 3 and
    # 4 pad to the same multiple and warm once, at 2 rows per shard
    assert runner.precompile((1, 3, 4), 5) == [(1, 5), (4, 5)]
    assert runner.precompile((1, 3, 4), 5) == []
    assert port.engine(CPU)._warm >= {(1, 5), (2, 5)}
    # the registry routes a mesh spec to the owned runner
    reg = ProgramRegistry()
    reg.register("m", port)
    spec = ExecutionSpec(mesh=("cpu",) * 2)
    run = reg.runner("m", spec)
    assert run.__self__ is port.sharded_runner(spec)
    assert run.__self__.precompile((8,), 5) == [(8, 5)]


def test_sharded_rejects_bad_requests(programs):
    _, port = programs["recurrent"]
    with pytest.raises(ValueError, match="mesh= shards the torch"):
        ExecutionSpec(engine="python", device="cpu", mesh="auto")
    with pytest.raises(ValueError, match="mesh= shards the torch"):
        ExecutionSpec(engine="oracle", mesh=("cpu",))
    with pytest.raises(ValueError, match="only string form"):
        ExecutionSpec(mesh="everything")
    with pytest.raises(ValueError, match="names no device"):
        ExecutionSpec(mesh=())
    with pytest.raises(ValueError, match="leave device to the mesh"):
        ExecutionSpec(device="cuda:0", mesh=("cpu",)).resolve()
    with pytest.raises(TypeError, match="inside spec="):
        ShardedRunner(port, ("cpu",), spec=ExecutionSpec(mesh=("cpu",)))
    with pytest.raises(ValueError, match="ext_spikes shape"):
        port.sharded_runner(("cpu",) * 2).run(np.zeros((4, 5), np.int32))


def test_spec_resolves_the_mesh():
    spec = ExecutionSpec(mesh=["cpu", "cpu"])
    assert spec.mesh == ("cpu", "cpu") and spec.sharded
    r = spec.resolve()
    assert r == r.resolve() and r.device == "cpu" and r.kernel == "fused"
    assert r.single_device() == ExecutionSpec(kernel="fused", device="cpu")
    assert hash(r) == hash(ExecutionSpec(device="cpu", mesh=("cpu", "cpu"))
                           .resolve())
    assert not ExecutionSpec(device="cpu").sharded


def test_distinct_devices_run_in_threads(programs, monkeypatch):
    """Shards on distinct devices run in one thread per device: "cpu" and
    "cpu:0" are two devices here, each with its own engine; the result
    is still the single engine's, and each device's shards ran in the
    thread of that device."""
    import threading

    from repro_torch.serve import sharded as sharded_mod

    ref, port = programs["recurrent"]
    mesh = ("cpu", "cpu:0", "cpu", "cpu:0")
    runner = ShardedRunner(port, spec=ExecutionSpec(mesh=mesh), min_shard=0)
    assert len({id(e) for e in runner._shard_engines}) == 2
    threads = {}
    run_on_device = sharded_mod._run_on_device

    def spy(engine, shards):
        threads.setdefault(str(engine.device), set()).add(
            threading.get_ident())
        return run_on_device(engine, shards)

    monkeypatch.setattr(sharded_mod, "_run_on_device", spy)
    for b in (1, 5, 8, 13):
        ext = make_ext(ref.graph, b, 10, seed=b)
        assert_same_run(runner.run(ext), ref.run(ext), f"B={b}")
    assert set(threads) == {"cpu", "cpu:0"}
    assert threading.get_ident() not in set.union(*threads.values())
