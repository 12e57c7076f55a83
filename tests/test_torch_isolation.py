"""The PyTorch port stands alone: no jax, nothing of the JAX package.

A subprocess with ``jax`` and ``repro`` blocked in ``sys.modules``
imports every module of ``repro_torch``; more subprocesses import each
package that takes part in an import cycle first (the kernel modules
import ``snn.lif``, and ``snn`` launches the kernels; ``kernels.ref``
loops ``models.mamba2.ssd_step``, and the models launch the kernels). An AST scan checks
every import statement of the package and of ``chip_smoke.py``.
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
    assert int(out.stdout.split()[-1]) >= 45       # the slices' modules


@pytest.mark.parametrize("first", ["repro_torch.kernels",
                                   "repro_torch.kernels.spike_accum",
                                   "repro_torch.snn", "repro_torch.snn.train",
                                   "repro_torch.core", "repro_torch.kernels.ref",
                                   "repro_torch.kernels.ssd",
                                   "repro_torch.models.mamba2",
                                   "repro_torch.models.model",
                                   "repro_torch.launch.serve"])
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
