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
