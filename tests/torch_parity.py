"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

The port (``repro_torch``) and the JAX reference (``repro``) are fed the
same numpy arrays; results come back as numpy and are compared there.
Tests that need a CUDA card carry the ``cuda`` marker and take the
:func:`cuda_device` fixture, which skips when no card is present (the
decision is made when the test runs, never at import).
"""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Program as TorchProgram

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def to_torch(a, device=CPU, dtype=torch.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def artifact_arrays(program) -> tuple[dict, dict]:
    """The JSON header and arrays a reference ``Program.save`` writes:
    the reference's own save of ``program`` to a temporary file, read
    back, so a carried program profiles and saves as the reference's."""
    with tempfile.TemporaryDirectory() as tmp:
        with np.load(program.save(Path(tmp) / "artifact")) as z:
            header = json.loads(str(z["header"][()]))
            arrays = {k: z[k] for k in z.files if k != "header"}
    return header, arrays


def carry(program) -> TorchProgram:
    """Carry a reference Program compiled in memory into the port."""
    return TorchProgram.from_arrays(*artifact_arrays(program))


def assert_same_run(got, want, what="") -> None:
    """Bit-exact equality of two ``(spikes, v_final, stats)`` results,
    dtypes included (tolerance 0)."""
    for name, a, b in (("spikes", got[0], want[0]), ("v_final", got[1], want[1]),
                       ("packet_counts", got[2]["packet_counts"],
                        want[2]["packet_counts"])):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    assert got[2]["mean_packets_per_step"] == want[2]["mean_packets_per_step"]


# -- the compiler: the same graph in both packages, the same artifact ---------

#: the report's wall-time fields; everything else in a saved header is
#: a function of the compile's inputs
WALL_REPORT = ("compile_seconds", "phase_seconds", "phase_alloc_mb")


def port_graph(g):
    """The port's graph of a reference graph's arrays."""
    from repro_torch.core.graph import SNNGraph
    from repro_torch.snn.lif import LIFIntParams
    return SNNGraph(g.n_inputs, g.n_neurons, g.pre, g.post, g.weight,
                    LIFIntParams(*tuple(g.lif)), tuple(g.output_slice))


def read_artifact(path) -> tuple[dict, dict]:
    """The JSON header and arrays of a saved artifact."""
    with np.load(path) as z:
        header = json.loads(str(z["header"][()]))
        arrays = {k: z[k] for k in z.files if k != "header"}
    return header, arrays


def without_wall_times(header: dict) -> dict:
    """``header`` with the wall-time fields taken out: the report's
    ``compile_seconds`` / ``phase_seconds`` / ``phase_alloc_mb``, and the
    search trace's ``seconds`` and each candidate's."""
    h = json.loads(json.dumps(header))
    rep = h["report"]
    for k in WALL_REPORT:
        rep.pop(k, None)
    if rep.get("search"):
        rep["search"].pop("seconds")
        for c in rep["search"]["candidates"]:
            c.pop("seconds")
    return h


def assert_same_saved(got, want) -> None:
    """Two saved artifacts: every array equal in dtype, shape and bytes,
    the header equal but for wall times, the same profiled phases."""
    hg, ag = read_artifact(got)
    hw_, aw = read_artifact(want)
    assert sorted(ag) == sorted(aw)
    for k in aw:
        assert ag[k].dtype == aw[k].dtype, k
        assert ag[k].shape == aw[k].shape, k
        assert ag[k].tobytes() == aw[k].tobytes(), k
    assert without_wall_times(hg) == without_wall_times(hw_)
    assert set(hg["report"].get("phase_seconds", ())) == \
        set(hw_["report"].get("phase_seconds", ()))


def assert_same_artifact(got, want, tmp_path, name="p") -> None:
    """The port's Program saves the reference's npz."""
    assert_same_saved(got.save(Path(tmp_path) / f"{name}_port"),
                      want.save(Path(tmp_path) / f"{name}_ref"))


def assert_same_partition(a, b) -> None:
    """Two ``PartitionResult``s equal field for field, dtypes included."""
    for f in ("assign", "scores"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.feasible, a.iterations, a.perturbations) == \
        (b.feasible, b.iterations, b.perturbations)
    assert a.score_history == b.score_history


def port_hw(hw):
    """The port's ``HardwareConfig`` of a reference one's fields."""
    import dataclasses

    from repro_torch.core.memory_model import HardwareConfig
    return HardwareConfig(**dataclasses.asdict(hw))
