"""The reference's deprecated surface in the port, held to the reference.

* ``spec_from_legacy_kwargs``: each pre-spec kwarg set maps onto the
  spec the reference maps it to (its engine under the port's name, its
  kernel tier, its mesh or none), behind a ``DeprecationWarning`` that
  names the same call and kwargs and the README section; ``sharded=True``
  with another engine raises the reference's message;
* the kwargs on ``Program.run`` / ``engine`` / ``sharded_runner``,
  ``ShardedRunner``, ``sharded_runner``, ``ProgramRegistry.runner`` and
  ``Server``: they warn, delegate to the spec they map to (the same
  owned engine or runner), refuse a spec beside them, and give the
  reference's bits (tolerance 0) and serving metrics;
* ``run_mapped_batched``: warns and builds a fresh engine each call,
  with the reference's outputs;
* ``default_kernel`` and ``enable_persistent_cache`` (the kernels'
  build directory: argument, then ``SUPRASNN_TORCH_CACHE_DIR``, then
  ``kernels/_build``; sticky; nothing is built);
* the AST diff of both packages' public top-level names leaves only what
  has no counterpart by design.

The port runs on the CPU here: ``interpret=True`` is its plain-version
path, as the reference's interpret mode is on a host without a TPU.
"""
import ast
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as ref_serve
import repro_torch.serve as port_serve
from conftest import make_ext, make_feedforward, make_hw
from repro.core.execution import spec_from_legacy_kwargs as ref_legacy
from repro_torch.core import (ExecutionSpec, default_kernel,
                              run_mapped_batched)
from repro_torch.core import aot
from repro_torch.core.execution import AUTO_MESH, spec_from_legacy_kwargs
from repro_torch.kernels import _build
from torch_parity import assert_same_run, carry

ROOT = Path(__file__).resolve().parents[1]
CPU_LIF = ExecutionSpec(kernel="lif", device="cpu")


@pytest.fixture(scope="module")
def ref_program():
    g = make_feedforward()
    return J.compile(g, make_hw(g), max_iters=4000)


@pytest.fixture(scope="module")
def program(ref_program):
    return carry(ref_program)


@pytest.fixture
def no_card(monkeypatch):
    """``mesh="auto"`` resolves to every visible card: none here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _warned(fn, **kwargs):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(**kwargs)
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1, msgs
    return out, msgs[0]


LEGACY = [
    (dict(nu_kernel=True), ExecutionSpec(kernel="lif")),
    (dict(nu_kernel=False), ExecutionSpec(kernel="reference")),
    (dict(sharded=True), ExecutionSpec(mesh=AUTO_MESH)),
    (dict(mesh=("cpu", "cpu")), ExecutionSpec()),   # mesh needs sharded
    (dict(engine="python"), ExecutionSpec(engine="python", device="cpu")),
    (dict(engine="oracle"), ExecutionSpec(engine="oracle")),
    (dict(engine="jax", interpret=True), ExecutionSpec(device="cpu")),
    (dict(engine="jax", interpret=False), ExecutionSpec()),
    (dict(nu_kernel=True, sharded=True, mesh=("cpu", "cpu")),
     ExecutionSpec(kernel="lif", mesh=("cpu", "cpu"))),
    (dict(sharded=True, interpret=True), ExecutionSpec(mesh=("cpu",))),
]


@pytest.mark.parametrize("kwargs,want", LEGACY,
                         ids=[",".join(k) for k, _ in LEGACY])
def test_legacy_kwargs_map_onto_the_reference_specs(kwargs, want):
    got, msg = _warned(spec_from_legacy_kwargs, **kwargs)
    assert got == want
    ref_kwargs = {k: (object() if k == "mesh" else v)
                  for k, v in kwargs.items()}
    ref, ref_msg = _warned(ref_legacy, **ref_kwargs)
    assert {"jax": "torch"}.get(ref.engine, ref.engine) == got.engine
    assert ref.kernel == got.kernel
    assert (ref.mesh is None) == (got.mesh is None)
    if ref.mesh == "auto":
        assert got.mesh in (AUTO_MESH, ("cpu",))
    # the same call and kwargs named, the same README section
    assert msg.split(" is deprecated")[0] == ref_msg.split(" is deprecated")[0]
    assert "(see README 'Migration to ExecutionSpec')" in msg


def test_sharded_with_another_engine_raises_the_reference_message():
    for fn in (spec_from_legacy_kwargs, ref_legacy):
        with pytest.deprecated_call(), \
                pytest.raises(ValueError, match="sharded=True runs the jax"):
            fn(sharded=True, engine="oracle")


def test_default_kernel_is_the_reference():
    assert default_kernel() == J.default_kernel() == "fused"
    assert ExecutionSpec(device="cpu").resolve().kernel == default_kernel()


RUN_KWARGS = [dict(nu_kernel=True, interpret=True),
              dict(nu_kernel=False, interpret=True),
              dict(engine="jax", interpret=True),
              dict(engine="python"),
              dict(engine="oracle", interpret=True)]


@pytest.mark.parametrize("kwargs", RUN_KWARGS,
                         ids=[",".join(k) for k in RUN_KWARGS])
def test_legacy_run_kwargs_delegate_bit_exact(ref_program, program, kwargs):
    ext = make_ext(program.graph, 3, 6, seed=0)
    with pytest.deprecated_call(match="Program.run"):
        got = program.run(ext, **kwargs)
    ref_kwargs = {k: v for k, v in kwargs.items() if k != "interpret"}
    with pytest.deprecated_call():
        want = ref_program.run(ext, **ref_kwargs)
    assert_same_run(got, want, str(kwargs))
    with pytest.deprecated_call():
        spec = spec_from_legacy_kwargs(**kwargs)
    assert_same_run(got, program.run(ext, spec))
    with pytest.raises(TypeError, match="both"):
        program.run(ext, ExecutionSpec(device="cpu"), **kwargs)


def test_legacy_engine_and_runner_kwargs_share_the_owned_objects(
        program, no_card):
    with pytest.deprecated_call(match="Program.engine"):
        eng = program.engine(nu_kernel=True, interpret=True)
    assert eng is program.engine(CPU_LIF)
    with pytest.raises(TypeError, match="both"):
        program.engine(CPU_LIF, nu_kernel=True)
    with pytest.deprecated_call(match="Program.sharded_runner"):
        runner = program.sharded_runner(("cpu", "cpu"), nu_kernel=True)
    assert runner is program.sharded_runner(
        ExecutionSpec(kernel="lif", mesh=("cpu", "cpu")))
    assert runner.n_shards == 2
    with pytest.deprecated_call():
        auto = program.sharded_runner(nu_kernel=False)
    assert auto.spec.mesh == ("cpu",) and auto.spec.kernel == "reference"
    with pytest.raises(TypeError, match="both"):
        program.sharded_runner(ExecutionSpec(mesh=("cpu",)), interpret=True)


def test_legacy_sharded_runner_kwargs_bit_exact(ref_program, program):
    ext = make_ext(program.graph, 5, 6, seed=2)
    want = ref_program.run(ext, J.ExecutionSpec(kernel="lif"))
    for build in (port_serve.ShardedRunner, port_serve.sharded_runner):
        with pytest.deprecated_call(match="ShardedRunner"):
            r = build(program, ("cpu",) * 2, nu_kernel=True, min_shard=0)
        assert r.spec.kernel == "lif" and r.n_shards == 2
        assert_same_run(r.run(ext), want)
    with pytest.raises(TypeError, match="both"):
        port_serve.ShardedRunner(program, spec=CPU_LIF, nu_kernel=True)


def test_legacy_registry_runner_kwargs(ref_program, program, no_card):
    ext = make_ext(program.graph, 4, 6, seed=3)
    ref_reg, port_reg = ref_serve.ProgramRegistry(), port_serve.ProgramRegistry()
    ref_reg.register("m", ref_program)
    port_reg.register("m", program)
    with pytest.deprecated_call(match="ProgramRegistry.runner"):
        got = port_reg.runner("m", sharded=True)(ext)
    with pytest.deprecated_call():
        want = ref_reg.runner("m", sharded=True)(ext)
    assert_same_run(got, want)
    with pytest.raises(TypeError, match="both"):
        port_reg.runner("m", CPU_LIF, sharded=True)


def test_legacy_server_kwargs_serve_the_reference_metrics(ref_program,
                                                          program, no_card):
    g = program.graph
    servers = []
    for serve, prog in ((ref_serve, ref_program), (port_serve, program)):
        reg = serve.ProgramRegistry()
        reg.register("m", prog, policy=serve.BatchPolicy(max_batch=4))
        with pytest.deprecated_call(match="Server"):
            srv = serve.Server(reg, sharded=True,
                               service_model=serve.linear_service_model())
        stream = [serve.Request("m", (np.random.default_rng(k).random(
            (5, g.n_inputs)) < 0.3).astype(np.int32), float(k * 60), 0)
            for k in range(12)]
        servers.append((srv, srv.serve(stream)))
    (ref_srv, want), (port_srv, got) = servers
    assert port_srv.spec == ExecutionSpec(mesh=AUTO_MESH)
    assert got == want
    for a, b in zip(port_srv.last_results["m"].outputs,
                    ref_srv.last_results["m"].outputs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="both"):
        port_serve.Server(port_serve.ProgramRegistry(), spec=CPU_LIF,
                          sharded=True)


def test_run_mapped_batched_warns_and_builds_a_fresh_engine(ref_program,
                                                            program):
    ext = make_ext(program.graph, 4, 6, seed=1)[0]
    with pytest.deprecated_call(match="run_mapped_batched is deprecated"):
        got = run_mapped_batched(program.graph, program.tables, ext,
                                 interpret=True)
    with pytest.deprecated_call(match="run_mapped_batched is deprecated"):
        want = J.run_mapped_batched(ref_program.graph, ref_program.tables,
                                    ext)
    assert_same_run(got, want)
    assert_same_run(got, program.run(ext, CPU_LIF))
    with pytest.deprecated_call():
        ref_tier = run_mapped_batched(program.graph, program.tables, ext,
                                      nu_kernel=False, interpret=True)
    assert_same_run(ref_tier, got)


def test_enable_persistent_cache_resolves_the_build_directory(
        tmp_path, monkeypatch, program):
    monkeypatch.setattr(aot, "_cache_dir", None)
    monkeypatch.delenv(aot.ENV_CACHE_DIR, raising=False)
    d = aot.enable_persistent_cache(str(tmp_path / "kernels"))
    assert d == str(tmp_path / "kernels")
    assert aot.enable_persistent_cache() == d           # sticky afterwards
    assert _build.library_path().parent == Path(d)
    assert not Path(d).exists()                         # nothing built
    # the environment variable, then the default beside the package
    monkeypatch.setattr(aot, "_cache_dir", None)
    monkeypatch.setenv(aot.ENV_CACHE_DIR, str(tmp_path / "env"))
    assert aot.enable_persistent_cache() == str(tmp_path / "env")
    monkeypatch.setattr(aot, "_cache_dir", None)
    monkeypatch.delenv(aot.ENV_CACHE_DIR)
    default = ROOT / "src" / "repro_torch" / "kernels" / "_build"
    assert aot.DEFAULT_CACHE_DIR == str(default)
    # Program.precompile resolves it (the default here)
    monkeypatch.setattr(aot, "_cache_dir", None)
    program.precompile([2], 6, ExecutionSpec(device="cpu"))
    assert aot._cache_dir == str(default)
    assert _build.build_dir() == default
    assert aot.ENV_CACHE_DIR == "SUPRASNN_TORCH_CACHE_DIR"


def _public_names(root: Path) -> set:
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                found = [node.name]
            elif isinstance(node, ast.Assign):
                found = [t.id for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                found = [node.target.id]
            else:
                continue
            names.update(n for n in found if not n.startswith("_"))
    return names


def test_every_public_name_of_the_reference_has_a_counterpart():
    missing = (_public_names(ROOT / "src" / "repro")
               - _public_names(ROOT / "src" / "repro_torch"))
    assert missing == {
        # the Pallas tile sizes and kernels behind kernels/ops.py: the
        # CUDA kernels take their place
        "DEFAULT_BLOCK", "DEFAULT_BLOCK_B", "DEFAULT_BLOCK_POST",
        "DEFAULT_BLOCK_PRE", "DEFAULT_CHUNK", "ssd_pallas", "wkv6_pallas",
        # HLO text has no counterpart without XLA
        "parse_module",
        # core/engine_jax.py's engine, ported as TorchMappedEngine
        "JaxMappedEngine"}
