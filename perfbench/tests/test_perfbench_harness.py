"""The harness end to end on the CPU: a cell, a mix, a configuration and
a metric added as new files are found by name; the command refuses to
run without a card, and a run refuses in a directory that holds the
benchmark alone; nothing a run loads is JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.cell import run_cell  # noqa: E402
FAST = {"pool": 8, "batch": 8, "ring": 2, "warmup_calls": 1,
        "sampled_calls": 2}


def _copy_benchmark(dst: Path) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def _run(root: Path, *args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(root / "perfbench" / "run.py"),
                           *args], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration (with its input generator), a mix (on the engine's
    ``"lif"`` tier), a cell and a metric added as files and entries,
    nothing edited."""
    _copy_benchmark(tmp_path)
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "mnist-sfnn.json").read_text())
    cfg["name"] = "mnist-sfnn-again"
    cfg["inputs"] = {"generator": "mnist_rate_again", "n_classes": 10}
    shutil.copy(pb / "generators" / "mnist_rate.py",
                pb / "generators" / "mnist_rate_again.py")
    (pb / "configs" / "mnist-sfnn-again.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "offline-b8.json").write_text(json.dumps(
        {"loop": "offline", "kernel": "lif", **FAST}))
    (pb / "metrics" / "calls.count.py").write_text(
        "def read(ctx):\n    return ctx.window.calls\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mnist-sfnn-again", "source": "x",
                             "file": "perfbench/configs/"
                                     "mnist-sfnn-again.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mnist-sfnn-again.offline-b8",
                               "config": "mnist-sfnn-again",
                               "traffic": "offline-b8", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "calls.count", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["mnist-sfnn-again.offline-b8"]})
    first = bench["end_to_end"][0]
    first["workloads"].append("mnist-sfnn-again.offline-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(tmp_path, "mnist-sfnn-again.offline-b8", 2**31 + 77, 0.3,
                   False, time.perf_counter(), device="cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"calls.count", first["name"],
                                   "setup_s"}
    assert out["metrics"]["calls.count"]["value"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"]["missing"] == {"value": 0, "limit": 0}


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    r = _run(ROOT, "--workload", "shd-srnn.stream-b1", "--seed", "1",
             "--seconds", "1", "--trace", "0", timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


ALONE = r"""
import sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
from perfbench.cell import run_cell
print(run_cell(root, "shd-srnn.stream-b1", 1, 0.2, False,
               time.perf_counter(), device="cpu"))
"""


def test_benchmark_alone_does_not_run(tmp_path):
    """With only ``BENCHMARK.json`` and ``perfbench/`` (no program), a
    run fails before it has a result (the card's look skipped)."""
    _copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", ALONE, str(tmp_path)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "repro_torch" in r.stderr


ISOLATION = r"""
import sys, time
for name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[name] = None            # an import of any of them raises
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from pathlib import Path
import importlib, pkgutil
root = Path(sys.argv[1])
import perfbench
for m in pkgutil.iter_modules(perfbench.__path__):
    importlib.import_module("perfbench." + m.name)
from perfbench import spec
bench = spec.load_benchmark(root)
for kind in ("end_to_end", "per_layer"):
    for m in bench[kind]:
        spec.reader(root, m["name"])
from perfbench.cell import run_cell
small = {"clients": 4, "pool": 8, "warmup_requests_per_client": 1,
         "ring": 2, "warmup_calls": 1, "sampled_calls": 2}
for c in bench["workloads"]:
    r = run_cell(root, c["name"], 5, 0.2, True, time.perf_counter(),
                 device="cpu", mix_override=small)
    assert r["correct"], r
for name in ("jax", "jaxlib", "flax", "repro"):
    del sys.modules[name]
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "repro"}))
print("repro_torch" in top)
"""


def test_no_jax_and_no_reference_package_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", ISOLATION, str(ROOT)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-2:] == ["[]", "True"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from perfbench import cell
    stub = type(sys)("stub")
    monkeypatch.setitem(sys.modules, "repro_torch_like", stub)
    monkeypatch.setitem(sys.modules, "reprox.core", stub)
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", None)   # a blocker
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", stub)
    assert "repro" in cell.forbidden_modules()


def test_a_forbidden_module_loaded_late_withholds_the_result(
        monkeypatch, capsys):
    """A module of the JAX package loaded by anything after the window
    (the reference, a metric's reader) is found just before the result
    would be printed: the command exits non-zero and prints none."""
    import torch

    import perfbench.cell
    from perfbench import run

    def fake_run_cell(*a, **kw):
        monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(perfbench.cell, "run_cell", fake_run_cell)
    rc = run.main(["--workload", "shd-srnn.stream-b1", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "repro" in out.err


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["shd-srnn.stream-b1"])
def test_cell_on_card(cuda_device, cell):
    r = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 1),
             "--seconds", "1", "--trace", "1", timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
