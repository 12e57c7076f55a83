"""Micro-batching SNN serving CLI — a thin command line over
``repro_torch.serve``; port of ``examples/serve_snn.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_snn [--artifact PATH]
        [--requests 64] [--batch-max 8] [--max-wait-us 0]
        [--max-queue 0] [--deadline-us 0] [--shed reject]
        [--trace PATH.npz] [--arrival-us 300] [--seed 0]
        [--sharded | --device cpu] [--measured]

A serving process ``Program.load``s a compiled artifact (default: the
SHD-scale golden ``tests/golden/shd_program_v1.npz``), registers it,
and drains a Poisson request stream through the library micro-batcher
(:class:`~repro_torch.serve.batcher.MicroBatcher`): FIFO queue,
power-of-two batch buckets, pad-and-mask, per-request latency accounting
on a simulated microsecond clock. A missing artifact is compiled first
(:func:`build_artifact`: a toy-MNIST-shaped graph on 16 SPUs, the
reference's), saved there, and then loaded like any other.

Request spike trains AND Poisson arrivals come from ONE
``np.random.Generator(--seed)``, and service times default to the
deterministic linear model, so two runs with the same seed report
identical p50/p99, and the same argv gives the reference's metrics dict.
``--measured`` swaps in real wall-clock engine times; ``--sharded``
runs each batch data-parallel over every visible card
(``ExecutionSpec(mesh="auto")``, :mod:`repro_torch.serve.sharded`).
The engine runs on the card unless ``--device cpu`` is given.

Overload knobs map straight onto ``BatchPolicy``: ``--max-queue`` bounds
the waiting queue, ``--deadline-us`` sets the per-request dispatch
deadline, ``--shed`` picks reject / drop-oldest /
degrade-to-smaller-bucket. ``--trace`` replays a recorded
:class:`~repro_torch.serve.replay.ArrivalTrace` (.npz, either package's)
instead of the synthetic Poisson arrivals; shed and per-stage accounting
are printed whenever a policy can shed.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repro_torch.core import (ExecutionSpec, HardwareConfig, Program,
                              compile, random_graph)
from repro_torch.serve import (ArrivalTrace, BatchPolicy, MicroBatcher,
                               ProgramRegistry, linear_service_model)

DEFAULT_ARTIFACT = (Path(__file__).resolve().parents[3] / "tests" / "golden"
                    / "shd_program_v1.npz")


def build_artifact(path: Path) -> Path:
    """Compile-once step: a toy-MNIST-shaped graph onto 16 SPUs."""
    g = random_graph(n_inputs=64, n_internal=48, n_synapses=900, seed=0)
    hw = HardwareConfig(n_spus=16, unified_mem_depth=64, concentration=3,
                        max_neurons=g.n_neurons,
                        max_post_neurons=g.n_internal)
    program = compile(g, hw, max_iters=20000)
    print(f"compiled: feasible={program.feasible} "
          f"OT depth={program.ot_depth} "
          f"({program.report.compile_seconds:.1f}s partition+schedule)")
    return program.save(path)


def run_demo(args) -> dict:
    """Load -> register -> drain the seeded stream; return the metrics."""
    path = Path(args.artifact)
    if path.suffix != ".npz":          # Program.save appends .npz
        path = path.with_name(path.name + ".npz")
    if not path.exists():
        path = build_artifact(path)
    registry = ProgramRegistry()
    program: Program = registry.load("demo", path)  # no re-partitioning
    print(f"loaded {path.name}: {program.n_synapses} synapses on "
          f"{program.hw.n_spus} SPUs, OT depth {program.ot_depth}")

    # ONE generator drives both the spike trains and the arrival process
    rng = np.random.default_rng(args.seed)
    if args.trace:
        trace = ArrivalTrace.load(args.trace)
        arrivals = trace.arrivals_us
        n_req = trace.n_requests
        print(f"replaying {trace.kind} trace: {n_req} requests over "
              f"{trace.duration_s:.1f}s ({trace.offered_qps:.0f} qps)")
    else:
        n_req = args.requests
        arrivals = np.cumsum(rng.exponential(args.arrival_us, n_req))
    reqs = (rng.random((n_req, args.timesteps, program.n_inputs))
            < 0.25).astype(np.int32)

    policy = BatchPolicy(max_batch=args.batch_max,
                         max_wait_us=args.max_wait_us,
                         max_queue=args.max_queue,
                         deadline_us=args.deadline_us,
                         shed=args.shed)
    spec = (ExecutionSpec(mesh="auto") if args.sharded
            else ExecutionSpec(device=args.device))
    runner = registry.runner("demo", spec)
    batcher = MicroBatcher(
        policy, runner=runner,
        service_model=None if args.measured else linear_service_model())
    res = batcher.drain(arrivals, reqs)
    m = res.metrics()
    print(f"served {m['requests']} requests in {m['batches']} batches, "
          f"buckets {dict(sorted(m['buckets'].items()))}")
    print(f"latency p50 {m['p50_ms']:.2f} ms  p99 {m['p99_ms']:.2f} ms  "
          f"throughput {m['throughput_rps']:.0f} req/s")
    if policy.max_queue or policy.deadline_us:
        st = m["stages_us"]
        print(f"shed {m['shed']} ({m['shed_frac']:.1%}), "
              f"{m['degraded_batches']} degraded batches")
        print(f"stages (us): queue {st['queue_wait']:.1f}  "
              f"fill {st['batch_fill']:.1f}  pad {st['pad']:.1f}  "
              f"compute {st['compute']:.1f}")
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=str(DEFAULT_ARTIFACT))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-max", type=int, default=8)
    ap.add_argument("--max-wait-us", type=float, default=0.0)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the waiting queue (0 = unbounded); "
                         "overflow is handled by --shed")
    ap.add_argument("--deadline-us", type=float, default=0.0,
                    help="per-request dispatch deadline from arrival "
                         "(0 = none); late requests are shed, not late")
    ap.add_argument("--shed", default="reject",
                    choices=["reject", "drop-oldest", "degrade",
                             "degrade-to-smaller-bucket"],
                    help="overload policy when the queue is full")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a saved ArrivalTrace .npz instead of "
                         "synthetic Poisson arrivals")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--arrival-us", type=float, default=300.0,
                    help="mean Poisson inter-arrival time")
    ap.add_argument("--seed", type=int, default=0,
                    help="one np.random.Generator seed for spike trains "
                         "AND arrivals: same seed, same p50/p99")
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--sharded", action="store_true",
                       help="run batches data-parallel over every visible "
                            "card")
    where.add_argument("--device", default=None,
                       help="cuda (the default) or cpu")
    ap.add_argument("--measured", action="store_true",
                    help="use wall-clock engine times instead of the "
                         "deterministic linear service model")
    return run_demo(ap.parse_args(argv))


if __name__ == "__main__":
    main()
