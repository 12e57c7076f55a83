"""Parity of the port's serving CLI with the reference's.

``repro_torch.launch.serve_snn.main`` against the reference
``examples/serve_snn.py`` ``main`` (loaded by path) on
``tests/golden/tiny_program_v1.npz`` with the same argv (the port's
with ``--device cpu``): their metrics dicts are equal (tolerance 0),
for a plain run, an overload run that sheds, a replayed ``--trace``
and a ``--sharded`` run; a missing artifact raises and names ROADMAP
Queue A item 7 (the port has no compiler to build one).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as ref_serve
from repro_torch.launch import serve_snn

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "golden" / "tiny_program_v1.npz"
BASE = ["--artifact", str(TINY), "--requests", "24", "--timesteps", "8",
        "--seed", "7"]


def _load_example():
    path = ROOT / "examples" / "serve_snn.py"
    spec = importlib.util.spec_from_file_location("serve_snn_example", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    return _load_example()


def _trace(tmp_path):
    path = tmp_path / "trace.npz"
    ref_serve.ArrivalTrace.bursty(3000.0, 0.02, seed=4, n_streams=2,
                                  burst_factor=6.0, period_s=0.01,
                                  duty=0.2).save(path)
    return str(path)


@pytest.mark.parametrize("extra", [
    [],
    ["--max-queue", "2", "--deadline-us", "1500", "--shed", "drop-oldest"],
    ["--batch-max", "4", "--max-wait-us", "400", "--shed", "degrade",
     "--max-queue", "3", "--arrival-us", "80"],
    "trace",
], ids=["plain", "overload", "degrade", "trace"])
def test_metrics_equal_reference(reference, tmp_path, extra):
    if extra == "trace":
        extra = ["--trace", _trace(tmp_path), "--max-queue", "4"]
    want = reference.main(BASE + extra)
    got = serve_snn.main(BASE + extra + ["--device", "cpu"])
    assert got == want
    if "--shed" in extra and "drop-oldest" in extra:
        assert got["shed"]["queue_full"] > 0           # the run sheds


def test_sharded_run_equals_reference(reference, monkeypatch):
    want = reference.main(BASE + ["--sharded"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = serve_snn.main(BASE + ["--sharded"])         # mesh="auto": the CPU
    assert got == want


def test_seed_determinism():
    m1 = serve_snn.main(BASE + ["--device", "cpu"])
    m2 = serve_snn.main(BASE + ["--device", "cpu"])
    assert (m1["p50_ms"], m1["p99_ms"], m1["buckets"]) == \
        (m2["p50_ms"], m2["p99_ms"], m2["buckets"])
    m3 = serve_snn.main(BASE[:-1] + ["8", "--device", "cpu"])
    assert (m3["p50_ms"], m3["p99_ms"]) != (m1["p50_ms"], m1["p99_ms"])


def test_missing_artifact_names_the_compiler_item(tmp_path):
    with pytest.raises(FileNotFoundError, match="Queue A item 7"):
        serve_snn.main(["--artifact", str(tmp_path / "absent"),
                        "--device", "cpu"])
    assert not (tmp_path / "absent.npz").exists()      # nothing compiled


def test_default_artifact_is_the_shd_golden():
    assert serve_snn.DEFAULT_ARTIFACT == ROOT / "tests" / "golden" / \
        "shd_program_v1.npz"
    assert serve_snn.DEFAULT_ARTIFACT.is_file()
    with np.load(serve_snn.DEFAULT_ARTIFACT) as z:
        assert "header" in z.files
