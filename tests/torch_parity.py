"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

The port (``repro_torch``) and the JAX reference (``repro``) are fed the
same numpy arrays; results come back as numpy and are compared there.
Tests that need a CUDA card carry the ``cuda`` marker and take the
:func:`cuda_device` fixture, which skips when no card is present (the
decision is made when the test runs, never at import).
"""
from __future__ import annotations

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
    """The JSON header and arrays a reference ``Program.save`` writes,
    built in memory from the reference ``program``."""
    g, hw, t, rep, part = (program.graph, program.hw, program.tables,
                           program.report, program.part)
    header = {
        "format": "suprasnn-program", "version": 1,
        "default_engine": program.default_engine,
        "graph": {"n_inputs": int(g.n_inputs),
                  "n_neurons": int(g.n_neurons),
                  "output_slice": [int(x) for x in g.output_slice],
                  "lif": {"leak_shift": int(g.lif.leak_shift),
                          "v_threshold": int(g.lif.v_threshold),
                          "v_reset": int(g.lif.v_reset)}},
        "hw": {"n_spus": hw.n_spus, "unified_mem_depth": hw.unified_mem_depth,
               "concentration": hw.concentration,
               "weight_bits": hw.weight_bits,
               "potential_bits": hw.potential_bits,
               "max_neurons": hw.max_neurons,
               "max_post_neurons": hw.max_post_neurons,
               "clock_mhz": hw.clock_mhz},
        "report": {"method": rep.method, "feasible": bool(rep.feasible),
                   "ot_depth": int(rep.ot_depth)},
        "part": {"feasible": bool(part.feasible),
                 "iterations": int(part.iterations),
                 "perturbations": int(part.perturbations)},
    }
    arrays = {
        "g_pre": g.pre, "g_post": g.post, "g_weight": g.weight,
        "t_pre": t.pre, "t_post": t.post, "t_weight": t.weight,
        "t_pre_end": t.pre_end, "t_post_end": t.post_end,
        "t_assign": t.assign, "part_assign": part.assign,
        "part_scores": part.scores,
        "part_history": np.asarray(part.score_history, np.float64),
        "rep_scores": rep.scores,
        "rep_spu_synapse_counts": rep.spu_synapse_counts,
        "rep_spu_post_counts": rep.spu_post_counts,
        "rep_spu_weight_counts": rep.spu_weight_counts,
    }
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
