#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path on the card and fails (exit code 1) on any
error or mismatch; it imports neither jax nor the JAX package. Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, started together) and print ptxas' report;
3. each kernel against its plain torch version on the card, bit-exact
   (``torch.equal``, tolerance 0): ``fused_step`` on int8 (910 x 126)
   and int16 (1020 x 320) planes at B in {1, 3, 8, 17} with negative
   potentials and recurrent inputs, ``lif_update_int`` at
   leak_shift in {1, 2, 4}; each case timed (per call on the card's
   clock, the host's enqueue time, the card's time alone with the
   enqueue hidden) beside its plain version's, one PyTorch library call's and
   the card's bound; then each kernel's record at the serving shape on
   the SHD-scale artifact's own plane;
4. the golden artifacts (``tests/golden``), all three tiers on the
   card, against their recorded outputs;
5. serve 32 seeded Poisson requests (T = 100) of the SHD-scale artifact
   through ``ProgramRegistry`` and ``MicroBatcher`` in measured mode,
   once on the default ``"fused"`` tier and once on ``"lif"``, each run
   with the launch counts set to 0 just before and read just after, and
   every request's outputs checked against the ``"reference"`` tier.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT_OPS_PER_S = 1979e12          # H100 SXM int8 tensor-core peak: the
#                                  card's top integer rate, so ops / it is
#                                  a lower bound for any integer work
TIMESTEPS = 100
N_REQUESTS = 32
SERVE_BATCH = 8


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 100, repeats: int = 7) -> float:
    """Median over ``repeats`` CUDA-event timings of ``iters`` calls
    back to back: the time per call on the card's clock, which is the
    host's enqueue time wherever the host is the slower of the two."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn, iters: int = 300) -> float:
    """Host time per call to enqueue ``fn`` (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_us(fn, iters: int = 50, repeats: int = 5) -> float:
    """The card's own time per call of ``fn``, with the host's enqueue
    time hidden: a spin kernel holds the stream while the host enqueues
    ``iters`` calls, which then run back to back between two events.
    Fails if the host took longer to enqueue than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(40_000_000)          # ~20 ms at 2 GHz
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        expect(enqueue_ms < ev[0].elapsed_time(ev[1]),
               f"enqueue took {enqueue_ms:.2f} ms, longer than the spin")
        times.append(ev[1].elapsed_time(ev[2]) / iters * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
               if a.numel() else 0)


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            print("  ptxas:", line.strip())


def time_fused(ext, prev, v, w, p) -> dict:
    """``fused_step``'s times on these inputs beside its plain version's,
    a float32 ``torch.matmul`` of the contraction alone (exact: every
    sum is below 2**24) and the card's bound."""
    from repro_torch.kernels.fused_step import fused_step, fused_step_ref
    b, n_int = v.shape
    s_all = torch.cat([ext, prev], 1)
    s_f, w_f = s_all.float(), w.float()
    v_k = v.clone()
    s_out = torch.empty_like(v)
    pkt_out = torch.empty((b,), dtype=torch.int32, device=v.device)
    rec = {
        "ms": median_ms(lambda: fused_step(ext, prev, v_k, w, p,
                                           spikes_out=s_out,
                                           pkt_out=pkt_out)),
        "host_us": host_us(lambda: fused_step(ext, prev, v_k, w, p,
                                              spikes_out=s_out,
                                              pkt_out=pkt_out)),
        "device_us": device_us(lambda: fused_step(ext, prev, v_k, w, p,
                                                  spikes_out=s_out,
                                                  pkt_out=pkt_out)),
        "plain_ms": median_ms(lambda: fused_step_ref(ext, prev, v, w, p)),
        "library_ms": median_ms(lambda: torch.matmul(s_f, w_f)),
    }
    # bytes: the W rows of the neurons that fired (a row no batch row
    # fired is never read), the spike plane, v read and written, spikes
    # and packets written; operations: a multiply and an add for each
    # (fired pre neuron, post neuron) pair of each batch row
    rows_fired = int((s_all != 0).any(0).sum().item())
    nnz = int((s_all != 0).sum().item())
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        rows_fired * n_int * w.element_size() + s_all.numel() * 4
        + b * n_int * 4 * 3 + b * 4, 2 * nnz * n_int)
    return rec


def time_lif(v, cur, p) -> dict:
    """``lif_update_int``'s times (in place, as the engine calls it)
    beside its plain version's and the card's bound; no single PyTorch
    call computes the LIF step."""
    from repro_torch.kernels.lif_update import (lif_update_int,
                                                lif_update_int_ref)
    v_k, s_out = v.clone(), torch.empty_like(v)
    rec = {
        "ms": median_ms(lambda: lif_update_int(v_k, cur, p,
                                               out=(v_k, s_out))),
        "host_us": host_us(lambda: lif_update_int(v_k, cur, p,
                                                  out=(v_k, s_out))),
        "device_us": device_us(lambda: lif_update_int(v_k, cur, p,
                                                      out=(v_k, s_out))),
        "plain_ms": median_ms(lambda: lif_update_int_ref(v, cur, p)),
        "library_ms": None,
    }
    # v and current read, v and spikes written; about 5 integer
    # operations per element (shift, two adds, compare, select)
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * v.numel() * 4,
                                                5 * v.numel())
    return rec


def print_times(what: str, rec: dict) -> None:
    lib = ("n/a" if rec["library_ms"] is None
           else f"{rec['library_ms'] * 1e3:.2f} us")
    print(f"  {what}: kernel {rec['ms'] * 1e3:.2f} us (host "
          f"{rec['host_us']:.2f} us/call, device {rec['device_us']:.2f} "
          f"us/launch), plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
          f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']})")


def phase_kernels(dev: torch.device) -> dict:
    """Kernels vs plain versions (bit-exact) and their times, then each
    kernel's record at the serving shape on the SHD-scale artifact."""
    from repro_torch.core import Program
    from repro_torch.kernels.fused_step import (fused_step, fused_step_ref,
                                                pack_dense)
    from repro_torch.kernels.lif_update import (lif_update_int,
                                                lif_update_int_ref)
    from repro_torch.snn.lif import LIFIntParams

    rng = np.random.default_rng(0)
    fused_step.launches = lif_update_int.launches = 0

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    planes = {"int8 910x126": (784, 126, torch.int8, 127),
              "int16 1020x320": (700, 320, torch.int16, 1000)}
    err = {"fused_step": 0, "lif_update_int": 0}
    for name, (n_ext, n_int, wdt, wmax) in planes.items():
        w = t(rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)), wdt)
        for i, b in enumerate((1, 3, 8, 17)):
            p = LIFIntParams(leak_shift=(1, 2, 4)[i % 3],
                             v_threshold=(15, 40, 0, -3)[i],
                             v_reset=(0, -5, 0, 2)[i])
            ext = t(rng.random((b, n_ext)) < 0.15)
            prev = t(rng.random((b, n_int)) < 0.35)   # recurrent input
            v0 = t(rng.integers(-3000, 3000, (b, n_int)))
            v_r, s_r, pkt_r = fused_step_ref(ext, prev, v0, w, p)
            v_k = v0.clone()
            _, s_k, pkt_k = fused_step(ext, prev, v_k, w, p)
            torch.cuda.synchronize()
            for what, a, r in (("v", v_k, v_r), ("spikes", s_k, s_r),
                               ("packets", pkt_k, pkt_r)):
                e = max_err(a, r)
                err["fused_step"] = max(err["fused_step"], e)
                expect(torch.equal(a, r), f"fused_step {name} B={b}: {what} "
                       f"differs from fused_step_ref (max |err| {e})")
            print(f"fused_step {name} B={b} {p}: bit-exact "
                  f"(spike rate {s_k.float().mean().item():.3f})")
            print_times("times", time_fused(ext, prev, v0, w, p))
    for shape in ((8, 320), (17, 126), (320,)):
        for ls in (1, 2, 4):
            p = LIFIntParams(leak_shift=ls, v_threshold=20, v_reset=-4)
            v0 = t(rng.integers(-5000, 5000, shape))
            cur = t(rng.integers(-300, 300, shape))
            v_r, s_r = lif_update_int_ref(v0, cur, p)
            v_k, s_k = lif_update_int(v0, cur, p)
            v_i = v0.clone()                           # the in-place form
            lif_update_int(v_i, cur, p, out=(v_i, torch.empty_like(v_i)))
            torch.cuda.synchronize()
            for what, a, r in (("v", v_k, v_r), ("spikes", s_k, s_r),
                               ("v in place", v_i, v_r)):
                e = max_err(a, r)
                err["lif_update_int"] = max(err["lif_update_int"], e)
                expect(torch.equal(a, r), f"lif_update_int {shape} ls={ls}: "
                       f"{what} differs (max |err| {e})")
            print(f"lif_update_int {shape} leak_shift={ls}: bit-exact")
        print_times("times", time_lif(v0, cur, p))
    print(f"comparison launches (not counted below): fused_step "
          f"{fused_step.launches}, lif_update_int {lif_update_int.launches}")

    # each kernel's record: the SHD-scale artifact's own int16 plane and
    # LIF parameters at the serving batch, spikes at the recorded rates
    program = Program.load(GOLDEN / "shd_program_v1.npz")
    p = program.graph.lif
    b, n_ext, n_int = SERVE_BATCH, program.n_inputs, program.lowered.n_internal
    w = t(pack_dense(program.lowered).weight, torch.int16)
    with np.load(GOLDEN / "shd_program_v1_io.npz") as io:
        ext_rate, int_rate = io["ext"].mean(), io["spikes"].mean()
    ext = t(rng.random((b, n_ext)) < ext_rate)
    prev = t(rng.random((b, n_int)) < int_rate)
    v = t(rng.integers(-3000, p.v_threshold, (b, n_int)))
    cur = t(rng.integers(-300, 300, (b, n_int)))
    recs = {"fused_step": time_fused(ext, prev, v, w, p),
            "lif_update_int": time_lif(v, cur, p)}
    for name, rec in recs.items():
        print_times(f"{name} B={b} on the SHD-scale artifact", rec)
        rec["max_abs_err"] = err[name]
    return recs


def phase_golden() -> None:
    from repro_torch.core import ExecutionSpec, Program
    for name in ("tiny", "shd"):
        program = Program.load(GOLDEN / f"{name}_program_v1.npz")
        with np.load(GOLDEN / f"{name}_program_v1_io.npz") as io:
            for tier in ("fused", "lif", "reference"):
                s, v, st = program.run(io["ext"], ExecutionSpec(kernel=tier))
                for what, a, r in (("spikes", s, io["spikes"]),
                                   ("v_final", v, io["v_final"]),
                                   ("packet_counts", st["packet_counts"],
                                    io["packet_counts"])):
                    expect(a.dtype == r.dtype and np.array_equal(a, r),
                           f"golden {name} tier {tier}: {what} differs")
            print(f"golden {name} (ext {io['ext'].shape}): fused, lif, "
                  f"reference match the recorded outputs on the card")


def phase_serve() -> dict[str, int]:
    """Serve the SHD-scale artifact on the fused and lif tiers; return
    each kernel's launches in the run of its tier."""
    from repro_torch.core import ExecutionSpec
    from repro_torch.kernels.fused_step import fused_step
    from repro_torch.kernels.lif_update import lif_update_int
    from repro_torch.serve import BatchPolicy, MicroBatcher, ProgramRegistry

    policy = BatchPolicy(max_batch=SERVE_BATCH)
    registry = ProgramRegistry()
    program = registry.load("shd", GOLDEN / "shd_program_v1.npz",
                            precompile=policy, timesteps=TIMESTEPS)
    rng = np.random.default_rng(1)
    requests = (rng.random((N_REQUESTS, TIMESTEPS, program.n_inputs))
                < 0.1).astype(np.int32)
    arrivals = np.cumsum(rng.exponential(1000.0, N_REQUESTS))
    s_ref, v_ref, st_ref = program.run(requests,
                                       ExecutionSpec(kernel="reference"))
    launches = {}
    for tier, runner in (("fused", registry.runner("shd")),
                         ("lif", registry.runner(
                             "shd", ExecutionSpec(kernel="lif")))):
        if tier == "lif":                  # warm before the counted run
            runner.precompile(policy.buckets, TIMESTEPS)
        batcher = MicroBatcher(policy, runner=runner, service_model=None)
        fused_step.launches = lif_update_int.launches = 0
        t0 = time.perf_counter()
        res = batcher.drain(arrivals, requests)
        wall = time.perf_counter() - t0
        counts = {"fused_step": fused_step.launches,
                  "lif_update_int": lif_update_int.launches}
        kernel = "fused_step" if tier == "fused" else "lif_update_int"
        other = "lif_update_int" if tier == "fused" else "fused_step"
        steps = len(res.batches) * TIMESTEPS
        expect(res.n_served == N_REQUESTS, f"{tier}: {res.n_shed} shed")
        expect(counts[kernel] == steps,
               f"{tier}: {kernel} launched {counts[kernel]} times, want "
               f"{len(res.batches)} batches x {TIMESTEPS} = {steps}")
        expect(counts[other] == 0, f"{tier}: {other} launched too")
        s, v, pk = res.outputs
        expect(np.array_equal(s, s_ref) and np.array_equal(v, v_ref)
               and np.array_equal(pk, st_ref["packet_counts"]),
               f"{tier}: served outputs differ from the reference tier")
        m = res.metrics()
        print(f"serve {tier}: {N_REQUESTS} requests in {len(res.batches)} "
              f"batches {m['buckets']}, {counts[kernel]} {kernel} launches "
              f"({counts[kernel] / N_REQUESTS:.1f} per request); "
              f"p50 {m['p50_ms']:.3f} ms p99 {m['p99_ms']:.3f} ms "
              f"throughput {m['throughput_rps']:.1f} req/s "
              f"(simulated arrivals, measured service); wall {wall:.3f} s; "
              f"outputs match the reference tier")
        launches[kernel] = counts[kernel]
    return launches


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core  # noqa: F401  (fails outside the repo)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_card()
    phase_build()
    recs = phase_kernels(dev)
    phase_golden()
    launches = phase_serve()
    meta = {
        "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                       "src/repro/kernels/fused_step.py:122"),
        "lif_update_int": ("src/repro_torch/kernels/csrc/lif_update.cu",
                           "src/repro/kernels/lif_update.py:76"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
