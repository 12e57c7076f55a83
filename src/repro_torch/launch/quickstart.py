"""Quickstart: the whole SupraSNN flow on a toy network — compile ONCE
into a ``Program`` artifact, then run / profile / save / load it; port
of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The eight steps and their printed lines are the reference's; the port's
engines stand in for its three: ``"torch"`` (the card's kernels, the
default), ``"oracle"`` (the dense integer LIF, on the same device) and
``"python"`` (the host simulator, always on the CPU). The program runs
on the card unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core import (SCHEDULE_STRATEGIES, ExecutionSpec,
                              HardwareConfig, Program, SearchConfig,
                              compile, random_graph)
from repro_torch.core.execution import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the engines run (default: the card)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    oracle = ExecutionSpec(engine="oracle", device=device)
    host = ExecutionSpec(engine="python", device="cpu")
    fused = ExecutionSpec(device=device)

    # 1. an irregular spiking network: 16 inputs, 32 internal neurons,
    #    300 nonzero synapses (paper Fig. 2b style)
    g = random_graph(n_inputs=16, n_internal=32, n_synapses=300, seed=0)

    # 2. a SupraSNN hardware instance: 8 SPUs, 48 Unified-Memory lines
    #    each, K=3 weights packed per line (paper Table 2 block)
    hw = HardwareConfig(n_spus=8, unified_mem_depth=48, concentration=3,
                        max_neurons=64, max_post_neurons=32)

    # 3. compile = the pass pipeline (partition -> schedule -> validate ->
    #    lower, paper §6 / Fig. 8) producing ONE artifact
    program = compile(g, hw)
    rep = program.report
    print(f"feasible={program.feasible}  operation-table depth="
          f"{program.ot_depth}  SPU loads={rep.spu_synapse_counts.tolist()}")

    # 4. 20 timesteps on the dense integer-LIF oracle and the host
    #    simulator of the mapped program: bit-exact (deterministic
    #    commit, paper §4.3)
    ext = (np.random.default_rng(0).random((20, 16)) < 0.3).astype(np.int32)
    s_oracle, _, _ = program.run(ext, oracle)
    s_mapped, _, stats = program.run(ext, host)
    assert np.array_equal(s_oracle, s_mapped), "determinism violated!"
    print(f"bit-exact over {s_oracle.size} neuron-timesteps "
          f"({int(s_oracle.sum())} spikes)")

    # 5. cycle-accurate latency/energy + FPGA resources in one call
    prof = program.profile(stats)
    print(f"latency={prof.latency_us:.1f} us  "
          f"energy={prof.energy_mj * 1e3:.3f} uJ"
          f"  ({prof.energy_per_synapse_nj:.3f} nJ/synapse)"
          f"  BRAMs={prof.resources.brams}")

    # 6. the batched torch engine: 8 spike trains in one call, the whole
    #    run ONE fused kernel launch (the default tier; the toy plane fits
    #    a cluster's shared memory); the "lif" tier gives the same bits
    ext_b = (np.random.default_rng(1).random((8, 20, 16)) < 0.3
             ).astype(np.int32)
    s_b, _, stats_b = program.run(ext_b, fused)
    s_lif, _, _ = program.run(ext_b, ExecutionSpec(kernel="lif",
                                                   device=device))
    assert np.array_equal(s_b, s_lif), "kernel tiers must be bit-exact"
    for i in range(8):
        assert np.array_equal(s_b[i], program.run(ext_b[i], oracle)[0])
    print(f"batched engine: {s_b.shape[0]} samples in one call, bit-exact "
          f"across kernel tiers; "
          f"mean packets/step={stats_b['mean_packets_per_step']:.1f}")

    # 7. persist the artifact: load never re-runs the stochastic
    #    partitioner and round-trips bit-exactly; precompile= prepares
    #    the serving bucket at load time (a CUDA graph on the card)
    with tempfile.TemporaryDirectory() as tmp:
        path = program.save(Path(tmp) / "toy_program")
        loaded = Program.load(path, precompile=[8], timesteps=20,
                              spec=fused)
    s_l, _, _ = loaded.run(ext_b, fused)
    assert np.array_equal(s_l, s_b), "artifact round-trip must be bit-exact"
    print(f"saved+loaded {path.name}: outputs identical, "
          f"{len(loaded.init_packets())} init packets")

    # 8. scheduling is pluggable (paper §6.3): schedule_method= picks the
    #    post transmit-order strategy, and compile(search=...) co-optimizes
    #    the JOINT (mapping, schedule strategy) pair
    depths = {name: compile(g, hw, schedule_method=name).ot_depth
              for name in SCHEDULE_STRATEGIES}
    joint = compile(g, hw, search=SearchConfig(restarts=4, early_exit=False))
    print(f"per-strategy OT depths={depths}  joint pick="
          f"{joint.report.search.selected.strategy}+"
          f"{joint.report.schedule_method} at depth {joint.ot_depth}")
    return {"device": device, "feasible": bool(program.feasible),
            "ot_depth": int(program.ot_depth),
            "spu_loads": rep.spu_synapse_counts.tolist(),
            "spikes": int(s_oracle.sum()),
            "latency_us": float(prof.latency_us),
            "energy_mj": float(prof.energy_mj),
            "brams": float(prof.resources.brams),
            "mean_packets_per_step": float(
                stats_b["mean_packets_per_step"]),
            "init_packets": len(loaded.init_packets()),
            "strategy_depths": depths,
            "joint": f"{joint.report.search.selected.strategy}+"
                     f"{joint.report.schedule_method}",
            "joint_depth": int(joint.ot_depth)}


if __name__ == "__main__":
    main()
