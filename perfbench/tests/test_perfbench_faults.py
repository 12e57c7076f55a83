"""The comparison calls a broken run not correct: the control (the
reference with its potentials in a narrower register) in the program's
place, and each fault planted in the timed path underneath: a step that
leaves its state unchanged, half of the batch left out, an answer
altered where it is produced. The chip's look is skipped (the CPU's
plain kernels); the rest of a run is driven as the command drives it, at
the configurations' full widths and smaller mixes: the benchmark's cells,
and the mixes that ``PERF.md`` keeps for later cells, added as entries
to a copy of the benchmark."""
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import control  # noqa: E402
from perfbench.cell import run_cell  # noqa: E402

SMALL = {"clients": 4, "pool": 8, "warmup_requests_per_client": 1,
         "ring": 2, "warmup_calls": 1, "sampled_calls": 2}
KEPT = {"shd-srnn.offline-b32": ("offline-b32", {"batch": 8}),
        "shd-srnn.serve-c32": ("serve-c32", {})}
CELLS = ["shd-srnn.stream-b1", *KEPT]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark with the kept mixes' cells added as entries."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (mix, _) in KEPT.items():
        bench["workloads"].append({"name": name, "config": "shd-srnn",
                                   "traffic": mix, "chips": 1, "why": "x"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _run(root, cell, seed=2**31 + 5, substitute=None):
    small = {**SMALL, **KEPT.get(cell, (None, {}))[1]}
    return run_cell(root, cell, seed, 0.3, False, time.perf_counter(),
                    device="cpu", mix_override=small, substitute=substitute)


def _off(r):
    return {k: v["value"] for k, v in r["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"] is True
    batch = KEPT.get(cell, (None, {"batch": 1}))[1].get("batch")
    want = (SMALL["sampled_calls"] * batch if batch else SMALL["clients"])
    assert r["info"]["rows_compared"] >= want
    assert set(_off(r).values()) == {0}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    r = _run(root, cell, substitute=control.substitute(root))
    assert r["correct"] is False
    assert _off(r)["spikes_off"] > 0


class _HalfBatch:
    """The program, run on the first half of each batch; the rest of the
    rows come back zero."""

    def __init__(self, program):
        self.program = program
        self.default_engine = program.default_engine

    def precompile(self, *a):
        return self.program.precompile(*a)

    def run(self, ext, spec=None):
        ext = np.asarray(ext)
        half = len(ext) // 2
        s, v, st = self.program.run(ext[:max(half, 1)], spec)
        p = st["packet_counts"]
        pad = lambda a: np.concatenate(
            [a[:half], np.zeros((len(ext) - half,) + a.shape[1:], a.dtype)])
        return pad(s), pad(v), {"packet_counts": pad(p)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from repro_torch.core import engine_torch
    sub = None
    if fault == "state_unchanged":
        step = engine_torch.fused_step

        def stuck(ext_t, s_prev, v, *a, **kw):
            v0 = v.clone()
            step(ext_t, s_prev, v, *a, **kw)
            v.copy_(v0)
        monkeypatch.setattr(engine_torch, "fused_step", stuck)
    elif fault == "half_batch":
        sub = lambda program, net, cfg: _HalfBatch(program)
    else:
        fin = engine_torch.finalize_outputs

        def altered(spikes, v, pkts, squeeze):
            spikes = np.array(spikes)
            spikes[0, 0, 0] ^= 1
            return fin(spikes, v, pkts, squeeze)
        monkeypatch.setattr(engine_torch, "finalize_outputs", altered)
    r = _run(root, cell, substitute=sub)
    assert r["correct"] is False, fault
    assert max(_off(r).values()) > 0


class _CachedByArray:
    """The program behind a cache keyed by the input array's identity:
    what no batch job, whose every call brings new data, would see."""

    def __init__(self, program):
        self.program = program
        self.default_engine = program.default_engine
        self.cache = {}

    def precompile(self, *a):
        return self.program.precompile(*a)

    def run(self, ext, spec=None):
        if id(ext) not in self.cache:
            self.cache[id(ext)] = self.program.run(ext, spec)
        return self.cache[id(ext)]


@pytest.mark.parametrize("cell", ["shd-srnn.stream-b1",
                                  "shd-srnn.offline-b32"])
def test_a_cache_keyed_by_the_input_array_is_not_correct(root, cell):
    r = _run(root, cell,
             substitute=lambda program, net, cfg: _CachedByArray(program))
    assert r["correct"] is False
    assert _off(r)["spikes_off"] > 0
