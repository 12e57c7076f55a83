"""The PyTorch port stands alone: no jax, nothing of the JAX package.

A subprocess with ``jax`` and ``repro`` blocked in ``sys.modules``
imports every module of ``repro_torch``; more subprocesses import each
package that takes part in an import cycle first (the kernel modules
import ``snn.lif``, and ``snn`` launches the kernels; ``kernels.ref``
loops ``models.mamba2.ssd_step``, and the models launch the kernels). An AST scan checks
every import statement of the package and of ``chip_smoke.py``. One more
subprocess, jax still blocked, imports and runs the serving modules
(sharded runner, replay, the serving CLI) and the graphed decode step's
module; another the compiler's back end and the verifier (the graph
generator, the three schedule strategies, the report, the multi-chip
accounting, ``verify``, its CLI and the registry's gate) and every new
module of that slice on its own; another the compiler (``compile`` of
the SHD golden's graph to its content hash, the portfolio search, a
4-chip multilevel compile of a synthetic graph, the deprecated wrapper,
the serving CLI on a missing artifact) and runs what it compiled.
``chip_smoke.py`` must fail, and print no result, without a CUDA card
and outside the repo.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 71       # the slices' modules


@pytest.mark.parametrize("first", ["repro_torch.kernels",
                                   "repro_torch.kernels.spike_accum",
                                   "repro_torch.snn", "repro_torch.snn.train",
                                   "repro_torch.core", "repro_torch.kernels.ref",
                                   "repro_torch.kernels.ssd",
                                   "repro_torch.models.mamba2",
                                   "repro_torch.models.model",
                                   "repro_torch.launch.serve",
                                   "repro_torch.serve",
                                   "repro_torch.launch.serve_snn",
                                   "repro_torch.train.steps",
                                   "repro_torch.analysis",
                                   "repro_torch.analysis.verify",
                                   "repro_torch.analysis.memory",
                                   "repro_torch.core.scheduling",
                                   "repro_torch.core.mapping",
                                   "repro_torch.core.mapping.search",
                                   "repro_torch.core.mapping.multilevel",
                                   "repro_torch.core.program",
                                   "repro_torch.core.compiler",
                                   "repro_torch.core.passes",
                                   "repro_torch.core.schedule",
                                   "repro_torch.configs.snn_paper",
                                   "repro_torch.kernels.launches"])
def test_import_order_does_not_matter(first):
    code = (f"import {first}\n"
            "from repro_torch.snn import forward, quantize\n"
            "from repro_torch.kernels import lif_update, spike_accum, ssd\n"
            "from repro_torch.kernels.ref import ssd_ref, wkv6_ref\n"
            "from repro_torch.models.model import prefill\n"
            "assert callable(forward) and callable(quantize)\n"
            "assert callable(lif_update) and callable(spike_accum)\n"
            "assert callable(ssd) and callable(prefill)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


SERVING_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np, torch
import repro_torch.serve as S
from repro_torch.core import ExecutionSpec, Program
from repro_torch.launch import serve_snn
from repro_torch.train.steps import (GraphedServeStep, StaticServeStep,
                                     make_graphed_serve_step)
assert set(S.__all__) >= {"ShardedRunner", "sharded_runner", "AsyncServer",
                          "CompletedRequest", "ShedError", "QueueFullError",
                          "DeadlineMissError", "ArrivalTrace", "SoakReport",
                          "replay"}
tiny = sys.argv[1]
prog = Program.load(tiny)
ext = np.ones((3, 5, prog.n_inputs), np.int32)
got = S.sharded_runner(prog, ("cpu",) * 2, min_shard=0).run(ext)
want = prog.run(ext, ExecutionSpec(device="cpu"))
assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
rep = S.replay(S.ArrivalTrace.poisson(500.0, 1.0, seed=1), S.BatchPolicy(),
               S.linear_service_model())
assert rep.stage_sum_exact and rep.requests > 0
m = serve_snn.main(["--artifact", tiny, "--requests", "6", "--timesteps",
                    "4", "--device", "cpu"])
assert m["requests"] == 6
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_serving_imports_and_runs_without_jax():
    tiny = ROOT / "tests" / "golden" / "tiny_program_v1.npz"
    out = subprocess.run([sys.executable, "-c", SERVING_WITHOUT_JAX,
                          str(tiny)],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


BACK_END_WITHOUT_JAX = """
import dataclasses, io, contextlib, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np
first = sys.argv[1]
__import__(first)
from repro_torch.analysis import CODES
from repro_torch.analysis.verify import main, verify
from repro_torch.configs.snn_paper import SHD_HW
from repro_torch.core import Program, random_graph
from repro_torch.core.passes import build_report
from repro_torch.core.schedule import schedule as shim_schedule
from repro_torch.core.scheduling import schedule
from repro_torch.serve import ProgramRegistry
shd = Program.load(sys.argv[2])
assert dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18) == shd.hw
g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
assert np.array_equal(g.weight, shd.graph.weight)
for method in ("slack", "consecutive", "load_balance"):
    t = schedule(g, shd.tables.assign, shd.hw, method=method)
    assert t.depth >= 1
assert shim_schedule is schedule
t = schedule(g, shd.tables.assign, shd.hw)
assert np.array_equal(t.pre, shd.tables.pre)
rep = build_report(g, shd.hw, t, shd.part, method="framework",
                   compile_seconds=0.0)
assert rep.resources == shd.report.resources
assert verify(shd).ok and len(CODES) >= 23
shd.hw = dataclasses.replace(shd.hw, n_chips=4)
assert shd.mesh_hops().any() and shd.chip_span().max() <= 4
ProgramRegistry().register("shd", Program.load(sys.argv[2]), verify=True)
with contextlib.redirect_stdout(io.StringIO()):
    assert main([sys.argv[2]]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("first", ["repro_torch.analysis.verify",
                                   "repro_torch.core.scheduling.vectorized",
                                   "repro_torch.core.mapping.hypergraph",
                                   "repro_torch.core.baselines"])
def test_back_end_and_verifier_run_without_jax(first):
    shd = ROOT / "tests" / "golden" / "shd_program_v1.npz"
    out = subprocess.run([sys.executable, "-c", BACK_END_WITHOUT_JAX, first,
                          str(shd)],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


COMPILE_WITHOUT_JAX = """
import dataclasses, io, contextlib, sys, tempfile, warnings
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np
first = sys.argv[1]
__import__(first)
from repro_torch.configs.snn_paper import SHD_HW
from repro_torch.core import (ExecutionSpec, Program, SearchConfig, compile,
                              compile_snn, random_graph)
from repro_torch.core.scale import scale_hw, synthetic_graph
from repro_torch.launch import serve_snn
g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
hw = dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18)
shd = compile(g, hw, max_iters=20000)
assert shd.content_hash() == sys.argv[2], shd.content_hash()
assert shd.content_hash() == Program.load(sys.argv[3]).content_hash()
small = random_graph(12, 24, 800, seed=3)
hws = dataclasses.replace(hw, n_spus=8, unified_mem_depth=14, max_neurons=64,
                          max_post_neurons=32)
prog = compile(small, hws, search=SearchConfig(workers=1))
assert prog.report.method == "portfolio" and prog.feasible
ext = (np.random.default_rng(0).random((2, 6, 12)) < 0.3).astype(np.int32)
cpu = ExecutionSpec(device="cpu")
s, v, st = prog.run(ext, cpu)
so, vo, _ = prog.run(ext, ExecutionSpec(engine="oracle", device="cpu"))
assert np.array_equal(s, so) and np.array_equal(v, vo)
big = synthetic_graph(4000, topology="mixed", skew=1.0, seed=0)
hw4 = scale_hw(big, n_chips=4, spus_per_chip=4)
hw1 = dataclasses.replace(hw4, n_spus=hw4.spus_per_chip, n_chips=1)
p4 = compile(big, hw1, method="multilevel", n_chips=4)
assert p4.hw.n_chips == 4 and p4.verify().ok
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    tables, report, part = compile_snn(small, hws, max_iters=2000)
assert any(issubclass(x.category, DeprecationWarning) for x in w)
with tempfile.TemporaryDirectory() as tmp:
    with contextlib.redirect_stdout(io.StringIO()):
        m = serve_snn.main(["--artifact", tmp + "/absent", "--requests", "4",
                            "--timesteps", "4", "--device", "cpu"])
    assert m["requests"] == 4
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""

# the SHD golden's content hash (tests/golden/shd_program_v1.npz)
SHD_HASH = "2b2916b301a3678ffa1bf4427c59838bde159f778e00f7ab9df3106cff54ee01"


@pytest.mark.parametrize("first", ["repro_torch.core.program",
                                   "repro_torch.core.mapping.strategies"])
def test_compiler_compiles_and_runs_without_jax(first):
    shd = ROOT / "tests" / "golden" / "shd_program_v1.npz"
    out = subprocess.run([sys.executable, "-c", COMPILE_WITHOUT_JAX, first,
                          SHD_HASH, str(shd)],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {mod}"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
