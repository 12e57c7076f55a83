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
the serving CLI on a missing artifact) and runs what it compiled;
another imports the four dense LM configs and runs a reduced dense
model's prefill and stacked and unrolled decode on the CPU, and the LM
serving CLI; another imports the checkpoints, the straggler monitor and
the training CLI and trains a reduced qwen2-1.5b 2 steps on the CPU,
checkpointed, then resumes it one more; another (one per module it
imports first) imports the MoE layer and the four configs of the MoE,
audio and VLM families, and runs each reduced model's prefill, stacked
and unrolled decode, the static serve step, and both CLIs; another
imports the mesh side (sharding rules, compression, elastic re-mesh,
meshes, strategies, specs) and runs a reduced ruled train step on a
one-rank gloo mesh, equal to the plain step; another (one per module it
imports first) imports the dry run, its counter and the public kernel
wrappers, calls the wrappers and runs a reduced model's dry-run cell
(``train_4k`` on the 256-rank fake group) through the CLI; another (one
per module it imports first) imports the paper's examples and runs the
quickstart and a narrow SHD SRNN's ``deploy``; another (one per module
it imports first) imports the whole-run kernel's module and runs
``fused_run``'s plain version, its emulation, the shape rule and the
fused engine's run path.
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
    assert int(out.stdout.split()[-1]) >= 75       # the slices' modules


@pytest.mark.parametrize("first", ["repro_torch.kernels",
                                   "repro_torch.kernels.spike_accum",
                                   "repro_torch.snn", "repro_torch.snn.train",
                                   "repro_torch.core", "repro_torch.kernels.ref",
                                   "repro_torch.kernels.ssd",
                                   "repro_torch.models.mamba2",
                                   "repro_torch.models.model",
                                   "repro_torch.models.moe",
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
                                   "repro_torch.kernels.launches",
                                   "repro_torch.distributed",
                                   "repro_torch.distributed.checkpoint",
                                   "repro_torch.launch.train",
                                   "repro_torch.optimizer.adam",
                                   "repro_torch.distributed.sharding",
                                   "repro_torch.distributed.elastic",
                                   "repro_torch.launch.specs",
                                   "repro_torch.launch.strategy",
                                   "repro_torch.launch.dryrun",
                                   "repro_torch.launch.hlo_analysis",
                                   "repro_torch.kernels.ops",
                                   "repro_torch.distributed.tensor_parallel",
                                   "repro_torch.launch.quickstart",
                                   "repro_torch.launch.mnist_end_to_end",
                                   "repro_torch.launch.shd_srnn",
                                   "repro_torch.launch.serve_batched",
                                   "repro_torch.launch.lm_pretrain"])
def test_import_order_does_not_matter(first):
    code = (f"import {first}\n"
            "from repro_torch.snn import forward, quantize\n"
            "from repro_torch.kernels import lif_update, spike_accum, ssd\n"
            "from repro_torch.kernels.ref import (ssd_ref, wkv6_ref,\n"
            "    spike_accum_ref, lif_update_ref)\n"
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


DENSE_WITHOUT_JAX = """
import contextlib, io, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import importlib
import torch
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
names = ["stablelm-12b", "glm4-9b", "chatglm3-6b", "qwen2-1.5b"]
for name in names:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    assert mod.CONFIG is get_config(name) and mod.CONFIG.family == "dense"
    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    logits, st = M.prefill(params, cfg, tokens[:, :8])
    assert st["main"]["k"].shape[:3] == (cfg.n_layers, 2, 8)
    st = serve._grow_cache(cfg, st, 2, 10, "cpu")
    unrolled = serve._grow_cache(cfg, {"len": st["len"], "main": {
        k: [t[:, :8].clone() for t in v] for k, v in st["main"].items()}},
        2, 10, "cpu")
    lg, _ = M.decode_step(params, cfg, tokens[:, 8:], st)
    lg_u, st_u = M.decode_step(params, cfg, tokens[:, 8:], unrolled,
                               unroll=True)
    assert torch.equal(lg, lg_u) and isinstance(st_u["main"]["k"], list)
    assert bool(lg.isfinite().all())
    with contextlib.redirect_stdout(io.StringIO()):
        toks = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    assert toks.shape == (2, 3)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_dense_lm_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", DENSE_WITHOUT_JAX],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


FAMILIES_WITHOUT_JAX = """
import contextlib, importlib, io, sys, tempfile
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
__import__(sys.argv[1])
import torch
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve, train
from repro_torch.models import model as M
from repro_torch.models.moe import moe_mlp, route_topk
from repro_torch.train.steps import StaticServeStep, make_serve_step
families = {"qwen3-moe-30b-a3b": "moe", "deepseek-v3-671b": "moe",
            "musicgen-medium": "audio", "qwen2-vl-7b": "vlm"}
for name, family in families.items():
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    assert mod.CONFIG is get_config(name) and mod.CONFIG.family == family
    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tokens = torch.randint(0, cfg.vocab_size, (2, 9, *k),
                           generator=torch.Generator().manual_seed(1))
    logits, st = M.prefill(params, cfg, tokens[:, :8])
    st = serve._grow_cache(cfg, st, 2, 10, "cpu")
    unrolled = {"len": st["len"], **{p: {key: [t.clone() for t in v]
                                         for key, v in st[p].items()}
                                     for p in ("dense", "main") if p in st}}
    lg, _ = M.decode_step(params, cfg, tokens[:, 8:], M.tree_map(
        torch.clone, st))
    lg_u, st_u = M.decode_step(params, cfg, tokens[:, 8:], unrolled,
                               unroll=True)
    assert torch.equal(lg, lg_u) and bool(lg.isfinite().all())
    assert all(isinstance(c, list) for c in st_u["main"].values())
    step = StaticServeStep(cfg, params, "cpu")
    step.precompile(2, 10)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    a, _ = step(params, tok[:, None], M.tree_map(torch.clone, st))
    b, _ = make_serve_step(cfg)(params, tok[:, None], st)
    assert torch.equal(a, b)
    with contextlib.redirect_stdout(io.StringIO()):
        toks = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "5", "--gen", "3"])
        assert toks.shape == (2, 3, *k)
        with tempfile.TemporaryDirectory() as d:
            losses = train.main(["--arch", name, "--reduced", "--device",
                                 "cpu", "--batch", "2", "--seq", "8",
                                 "--steps", "1", "--ckpt-dir", d])
    assert len(losses) == 1
assert callable(moe_mlp) and callable(route_topk)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("first", ["repro_torch.models.moe",
                                   "repro_torch.configs.deepseek_v3_671b"])
def test_moe_audio_and_vlm_families_run_without_jax(first):
    out = subprocess.run([sys.executable, "-c", FAMILIES_WITHOUT_JAX, first],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


TRAIN_WITHOUT_JAX = """
import contextlib, io, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import torch
import repro_torch.distributed as D
import repro_torch.distributed.checkpoint
import repro_torch.distributed.straggler
from repro_torch.launch import train
from repro_torch.train import TrainHParams, init_opt_state, make_train_step
assert set(D.__all__) >= {"save_checkpoint", "load_checkpoint", "latest_step",
                          "CheckpointManager", "StragglerMonitor",
                          "StepJournal"}
assert len(D.__all__) == 20            # the reference's __all__ whole
with tempfile.TemporaryDirectory() as d:
    args = ["--arch", "qwen2-1.5b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", d]
    with contextlib.redirect_stdout(io.StringIO()):
        losses = train.main(args + ["--steps", "2"])
        more = train.main(args + ["--steps", "3", "--resume"])
    assert len(losses) == 2 and len(more) == 1 and D.latest_step(d) == 2
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_training_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", TRAIN_WITHOUT_JAX],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


MESH_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import torch
import torch.distributed as dist
import repro_torch.distributed.compression as C
import repro_torch.distributed.elastic as E
import repro_torch.distributed.sharding as SH
import repro_torch.launch.mesh as LM
import repro_torch.launch.specs as SP
import repro_torch.launch.strategy as ST
from repro_torch.configs import SHAPES, all_cells, get_config, get_reduced
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     make_train_step)
assert len(all_cells()) == 32
LM.init_distributed("cpu", store=dist.HashStore(), rank=0, world_size=1)
mesh = LM.make_debug_mesh()
assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
assert tuple(LM.make_serving_mesh().shape) == (1, 1)
try:
    LM.make_debug_mesh(2)              # more ranks than the group has
except ValueError:
    pass
else:
    raise AssertionError("a 2-rank mesh on a 1-rank group")
cfg = get_reduced("qwen2-1.5b")
rules = ST.make_mesh_rules(mesh, ST.pick_strategy(cfg, SHAPES["train_4k"]))
hp = TrainHParams(loss_chunk=8)
out = []
for r in (rules, None):
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    params, opt, met = make_train_step(cfg, r, hp)(
        params, init_opt_state(params, hp), synthetic_batch(cfg, 2, 16, 0))
    out.append((float(met["loss"]), SH.gather_tree(params)))
assert out[0][0] == out[1][0]
assert torch.equal(out[0][1]["embed"], out[1][1]["embed"])
big = get_config("deepseek-v3-671b")
st = ST.pick_strategy(big, SHAPES["train_4k"])
p, o = SP.model_specs(big, ST.make_mesh_rules(LM.make_production_mesh(), st),
                      st.hparams)
assert p["embed"].shard_shape == (129280 // 16, 7168 // 16)
g = {"w": torch.randn(3, 700)}
comp, deq, err = C.compress_error_feedback(g, C.init_error(g))
assert comp.q["w"].dtype == torch.int8 and err["w"].shape == (3, 700)
assert E.plan_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
dist.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_mesh_side_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", MESH_WITHOUT_JAX],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


DRYRUN_WITHOUT_JAX = """
import contextlib, io, json, sys, tempfile
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
__import__(sys.argv[1])
import torch
import repro_torch.configs as CF
import repro_torch.core as C
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.snn.lif import LIFIntParams
assert {"ENGINES", "KERNELS"} <= set(C.__all__)
_, c = analyze(lambda w, x: x @ w, torch.ones(8, 8), torch.ones(8, 8))
assert c["flops"] == 2 * 8 ** 3
v, s = ops.lif_update_int(torch.zeros(4, dtype=torch.int32),
                          torch.full((4,), 20, dtype=torch.int32),
                          LIFIntParams(2, 15, 0), block=(16, 256))
assert s.tolist() == [1, 1, 1, 1]
assert ops.spike_accum(torch.ones(2, 3), torch.ones(3, 4),
                       interpret=True).sum() == 24
dryrun.get_config = CF.get_reduced      # a reduced cell, full-size shapes
with tempfile.TemporaryDirectory() as d:
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                     "--mesh", "single", "--out", d])
    r = json.load(open(d + "/qwen2-1.5b_train_4k_single.json"))
assert r["chips"] == 256 and r["cost"]["flops_per_device"] > 0
assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
assert not torch.distributed.is_initialized()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


TENSOR_PARALLEL_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshRules, batch_split,
                                              gather_tree, mesh_rules)
from repro_torch.launch import serve
from repro_torch.launch.mesh import init_distributed
from repro_torch.launch.strategy import pick_strategy
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import mamba2, rwkv
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     make_prefill_step, make_serve_step,
                                     make_train_step)
init_distributed("cpu", store=dist.HashStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
cfg = get_reduced("qwen3-moe-30b-a3b")
rules = MeshRules(mesh, pick_strategy(cfg, SHAPES["train_4k"]).logical_rules)
with mesh_rules(rules), batch_split(None):
    plan = TP.plan_for(cfg)
assert plan.tp is None and plan.ep is None and not plan.vocab
hp = TrainHParams(loss_chunk=8)
out = []
for r in (rules, None):        # a one-rank tp_ep mesh: the plain step
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params, hp)
    params, opt, met = make_train_step(cfg, r, hp)(
        params, opt, synthetic_batch(cfg, 4, 16, 0))
    out.append((float(met["loss"]), gather_tree(params)))
assert out[0][0] == out[1][0]
a, b = M.flat_tree(out[0][1]), M.flat_tree(out[1][1])
assert all(torch.equal(a[k], b[k]) for k in b)
params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
toks = torch.randint(0, cfg.vocab_size, (2, 8))
got = make_prefill_step(cfg, rules)(params, {"tokens": toks})
want = make_prefill_step(cfg)(params, {"tokens": toks})
assert torch.equal(got[0], want[0])
assert torch.equal(got[1]["main"]["k"], want[1]["main"]["k"])
# MLA, Mamba-2 with the shared block, RWKV-6: one train step, a prefill
# and two decode steps under tp_ep rules on (1, 1), the plain ones bit
# for bit
import repro_torch.launch.dryrun, repro_torch.launch.specs
for arch in ("deepseek-v3-671b", "zamba2-7b", "rwkv6-3b"):
    cfg = get_reduced(arch)
    rules = MeshRules(mesh, pick_strategy(
        cfg, SHAPES["train_4k"], override_profile="tp_ep").logical_rules)
    with mesh_rules(rules), batch_split(None):
        plan = TP.plan_for(cfg)
    assert plan.tp is None and not (plan.heads or plan.cap)
    out = []
    for r in (rules, None):
        params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = init_opt_state(params, hp)
        params, opt, met = make_train_step(cfg, r, hp)(
            params, opt, synthetic_batch(cfg, 4, 16, 0))
        logits, st = make_prefill_step(cfg, r)(params, {"tokens": toks})
        st = serve._grow_cache(cfg, st, 2, 10, "cpu", r)
        step, seq = make_serve_step(cfg, r), []
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        for _ in range(2):
            nxt, st = step(params, nxt[:, None], st)
            seq.append(nxt)
        out.append((float(met["loss"]), gather_tree(params), logits, seq,
                    st))
    assert out[0][0] == out[1][0], arch
    for i in (1, 4):
        a, b = M.flat_tree(out[0][i]), M.flat_tree(out[1][i])
        assert all(torch.equal(a[k], b[k]) for k in b), (arch, i)
    assert torch.equal(out[0][2], out[1][2]), arch
    assert all(torch.equal(x, y) for x, y in zip(out[0][3], out[1][3]))
dist.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_tensor_parallel_runs_without_jax():
    """The ruled steps' compute split on a one-rank (1, 1) mesh under
    qwen3-moe's tp_ep rules: nothing split, the plain step bit for bit
    (loss, every parameter; the prefill's logits and cache); and so for
    deepseek-v3 (MLA), zamba2-7b (Mamba-2, the shared block) and
    rwkv6-3b (a train step, the prefill, two decode steps, the state),
    with every module the split touches imported without jax."""
    out = subprocess.run([sys.executable, "-c", TENSOR_PARALLEL_WITHOUT_JAX],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


@pytest.mark.parametrize("first", ["repro_torch.launch.dryrun",
                                   "repro_torch.kernels.ops"])
def test_dry_run_and_ops_run_without_jax(first):
    out = subprocess.run([sys.executable, "-c", DRYRUN_WITHOUT_JAX, first],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


PAPER_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
__import__(sys.argv[1])
import numpy as np, torch
from repro_torch.configs.snn_paper import SHD_HW
from repro_torch.core import ExecutionSpec
from repro_torch.launch import (lm_pretrain, mnist_end_to_end, quickstart,
                                serve_batched, shd_srnn)
from repro_torch.snn import QuantConfig
from repro_torch.snn.models import init_params
assert callable(serve_batched.main) and callable(lm_pretrain.main)
assert shd_srnn.deploy is mnist_end_to_end.deploy
r = quickstart.main(["--device", "cpu"])
assert r["joint_depth"] > 0 and r["device"] == "cpu"
cfg = shd_srnn.shd_config(hidden=24, timesteps=8)
p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
ext = (np.random.default_rng(0).random((3, 8, 700)) < 0.2).astype(np.int32)
runs = [shd_srnn.deploy(p, cfg, SHD_HW, QuantConfig(7, 12), ext,
                        labels=np.zeros(3, np.int32), spec=spec,
                        max_iters=2000)
        for spec in (ExecutionSpec(device="cpu"),
                     ExecutionSpec(engine="oracle", device="cpu"))]
assert all(np.array_equal(a, b) for a, b in zip(runs[0]["outputs"][:2],
                                                runs[1]["outputs"][:2]))
assert runs[0]["latency_us"] == runs[1]["latency_us"]
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("first", ["repro_torch.launch.quickstart",
                                   "repro_torch.launch.mnist_end_to_end",
                                   "repro_torch.launch.shd_srnn"])
def test_paper_examples_run_without_jax(first):
    """The quickstart on the CPU and the SHD SRNN's deploy (a narrow
    hidden layer) on the fused tier's plain version and the oracle, with
    the paper's examples imported without jax, each module first."""
    out = subprocess.run([sys.executable, "-c", PAPER_WITHOUT_JAX, first],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


FUSED_RUN_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np, torch
first = sys.argv[1]
__import__(first)
from repro_torch.core import ExecutionSpec, Program
from repro_torch.kernels.fused_step import (fused_path, fused_run,
    fused_run_emulated, fused_run_ref, pack_dense, pack_plane,
    run_smem_bytes)
prog = Program.load(sys.argv[2])
w = torch.from_numpy(pack_dense(prog.lowered).weight)
assert fused_path(w, prog.n_inputs) == "run"
assert run_smem_bytes(4, 700, 320) > 232448
rng = np.random.default_rng(0)
ext = torch.from_numpy((rng.random((6, 3, prog.n_inputs)) < 0.3)
                       .astype(np.int32))
p = prog.graph.lif
want = fused_run_ref(ext, w, p)
for got in (fused_run(ext, w, p), fused_run_emulated(ext, pack_plane(w), p)):
    assert all(torch.equal(a, b) for a, b in zip(got, want))
eng = prog.engine(ExecutionSpec(device="cpu"))
assert eng.fused_path == "run"
s, v, st = eng.run(ext.numpy().transpose(1, 0, 2))
assert np.array_equal(s, want[0].numpy().transpose(1, 0, 2))
assert np.array_equal(v, want[1].numpy())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("first", ["repro_torch.kernels.fused_step",
                                   "repro_torch.core.engine_torch"])
def test_fused_run_runs_without_jax(first):
    """The whole-run kernel's module imported without jax, each module
    first: ``fused_run``'s plain version and its emulation agree, the
    shape rule's mirror answers, and the fused engine takes the run
    path on the tiny golden on the CPU."""
    tiny = ROOT / "tests" / "golden" / "tiny_program_v1.npz"
    out = subprocess.run([sys.executable, "-c", FUSED_RUN_WITHOUT_JAX, first,
                          str(tiny)],
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
