"""Regenerate the SHD-scale golden artifact and its recorded outputs.

Compiles the paper's SHD-scale recurrent net (700 inputs, 320 internal
neurons, ~33k synapses with 9-bit weights in [-255, 255]; the graph of
``benchmarks/partitioner_throughput.py::fig13_shd_instance``) onto the
paper's SHD hardware (``configs/snn_paper.py::SHD_HW``, 64 SPUs) with
``weight_bits=9, potential_bits=18``, and writes:

* ``shd_program_v1.npz``: the saved :class:`repro.core.Program`;
* ``shd_program_v1_io.npz``: ``ext`` [4, 100, 700] at rate 0.1 from
  ``default_rng(0)`` and the reference's spikes, final potentials and
  packet counts, after the ``"fused"`` and ``"reference"`` tiers agree.

Run from the repo root with the JAX package on the path:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/golden/make_shd_program.py
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from repro.configs.snn_paper import SHD_HW
from repro.core import ExecutionSpec, compile, random_graph

HERE = Path(__file__).parent
BATCH, TIMESTEPS, RATE = 4, 100, 0.1


def main() -> None:
    g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
    hw = dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18)
    program = compile(g, hw, max_iters=20000)
    if not program.feasible:
        raise SystemExit("SHD-scale graph did not map feasibly onto SHD_HW")
    path = program.save(HERE / "shd_program_v1.npz")

    rng = np.random.default_rng(0)
    ext = (rng.random((BATCH, TIMESTEPS, g.n_inputs)) < RATE).astype(np.int32)
    s, v, st = program.run(ext, ExecutionSpec(kernel="fused"))
    s_r, v_r, st_r = program.run(ext, ExecutionSpec(kernel="reference"))
    if not (np.array_equal(s, s_r) and np.array_equal(v, v_r)
            and np.array_equal(st["packet_counts"], st_r["packet_counts"])):
        raise SystemExit("fused and reference tiers disagree")
    np.savez_compressed(HERE / "shd_program_v1_io.npz", ext=ext, spikes=s,
                        v_final=v, packet_counts=st["packet_counts"])
    print(f"{path}: ot_depth={program.ot_depth} "
          f"synapses={program.n_synapses} spike_rate={s.mean():.4f}")


if __name__ == "__main__":
    main()
