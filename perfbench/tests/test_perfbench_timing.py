"""The interval arithmetic and the trace reading, on synthetic
intervals, and the readers that use them."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import cell, peaks, spec, timing, workload  # noqa: E402
from perfbench.timing import Interval, Trace  # noqa: E402


def test_union_covered_gaps():
    merged = timing.union([(5, 7), (0, 2), (1, 3), (6, 6.5), (9, 9)])
    assert merged == [(0, 3), (5, 7)]
    assert timing.covered(merged, 0, 10) == 5
    assert timing.covered(merged, 2, 6) == 2
    assert timing.covered(merged, 3, 5) == 0
    assert timing.gaps(merged, -1, 10) == [(-1, 0), (3, 5), (7, 10)]
    assert timing.gaps(merged, 1, 6) == [(3, 5)]


def _ev(name, cat, start_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_us,
            "dur": dur_us, "tid": tid}


def _trace():
    base = 1_700_000_000_000.0
    ev = [_ev("bench.loop", "user_annotation", base, 10_000),
          _ev("engine.run", "user_annotation", base + 500, 5_000),
          _ev("aten::copy_", "cpu_op", base + 800, 1_000),
          _ev("aten::copy_", "cpu_op", base + 8_000, 0.1, tid=2),
          _ev("Memcpy HtoD", "gpu_memcpy", base + 2_000, 500, tid=7),
          _ev("fused_run_kernel", "kernel", base + 2_500, 1_000, tid=7),
          # overlaps the first: a union, not a sum
          _ev("fused_run_kernel", "kernel", base + 3_000, 1_000, tid=8),
          _ev("Memcpy DtoH", "gpu_memcpy", base + 6_000, 1_000, tid=7),
          _ev("gpu annotation", "gpu_user_annotation", base, 10_000),
          _ev("other", "user_annotation", base, 1),
          {"ph": "M", "name": "process_name"}]
    return Trace.from_chrome(ev, {"bench.loop", "engine.run"})


def test_trace_reading_and_breakdown():
    tr = _trace()
    assert [d.name for d in tr.device] == ["Memcpy HtoD", "fused_run_kernel",
                                           "fused_run_kernel", "Memcpy DtoH"]
    assert [s.name for s in tr.spans] == ["bench.loop", "engine.run"]
    merged = tr.device_union()
    assert merged == pytest.approx([(0.002, 0.004), (0.006, 0.007)])
    b = cell.breakdown(tr, merged, 0.0, 0.010)
    names = dict(b["device_ops"])
    assert names["fused_run_kernel"] == pytest.approx(0.002)
    # idle 0-2 ms (at 1 ms: engine.run's copy_), 4-6 (at 5 ms:
    # engine.run), 7-10 (at 8.5 ms: the loop alone)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"engine.run/aten::copy_": 0.002, "engine.run": 0.002,
         "bench.loop": 0.003})


def _ctx(tr, mix, calls=2, batch=32):
    unit = "samples" if mix["loop"] == "offline" else "requests"
    win = workload.Window(0.0, 0.010, calls, 0, calls * batch, unit, calls)
    net = {"synapses": 39658, "timesteps": 100, "n_inputs": 700,
           "n_internal": 320, "weight_bits": 7, "batch": batch}
    return cell.Ctx({}, {}, mix, net, 1.0, 0.5, win, "bench.loop", tr,
                    None, ROOT)


def test_readers_on_a_synthetic_trace():
    ctx = _ctx(_trace(), {"loop": "offline"})
    read = lambda m: spec.reader(ROOT, m).read(ctx)
    assert read("device.idle") == pytest.approx(70.0)
    assert read("device.idle.serve") == read("device.idle")
    assert read("engine.copy_ms") == pytest.approx(1.5 / 2)
    # engine.run 0.5-5.5 ms, the device busy 2-4 of it
    assert read("engine.host_ms") == pytest.approx(3.0)
    k = spec.kernel(ROOT, "fused_run")
    bound = peaks.bound_s(k.bytes_moved(ctx.net, 32),
                          k.operations(ctx.net, 32))
    assert read("fused_run_roofline") == pytest.approx(100 * bound / 1e-3)
    assert read("samples_per_s") == pytest.approx(64 / 0.010)
    assert read("serve_rps") is None
    assert read("mfu") == pytest.approx(
        100 * 2 * 39658 * 100 * 64 / 0.010 / peaks.INT8_OPS_PER_S)


def test_readers_find_nothing_untraced():
    ctx = _ctx(None, {"loop": "offline"})
    for m in ("device.idle", "engine.copy_ms", "engine.host_ms",
              "fused_run_roofline", "serve.overhead_ms", "serve.p95_ms"):
        assert spec.reader(ROOT, m).read(ctx) is None, m
    ctx = _ctx(Trace([], [Interval("bench.loop", 0, 1)], []),
               {"loop": "offline"})
    assert spec.reader(ROOT, "device.idle").read(ctx) is None
    assert spec.reader(ROOT, "fused_run_roofline").read(ctx) is None


def test_call_latency_reader():
    ctx = _ctx(None, {"loop": "offline"}, calls=3, batch=1)
    read = lambda: spec.reader(ROOT, "latency_p50_ms").read(ctx)
    assert read() is None                       # no call timed
    ctx.window.latencies_s = [0.001, 0.004, 0.002]
    assert read() == pytest.approx(2.0)
    ctx.window.unit = "requests"                # a server's requests
    assert read() is None


def test_serve_readers():
    ctx = _ctx(None, {"loop": "closed_serve"})
    ctx.window = workload.Window(0.0, 2.0, 100, 0, 80, "requests", 0,
                                 batches=10.0,
                                 latencies_s=[i / 1000 for i in range(80)])
    ctx.direct_ms = 50.0
    assert spec.reader(ROOT, "serve_rps").read(ctx) == 40.0
    assert spec.reader(ROOT, "serve.overhead_ms").read(ctx) == 150.0
    assert spec.reader(ROOT, "serve.p95_ms").read(ctx) == pytest.approx(
        75.05)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.load_benchmark(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.reader(ROOT, m["name"]), "read"), m["name"]
    for c in bench["workloads"]:
        cfg = spec.config(ROOT, bench, c["config"])
        assert hasattr(spec.loop(ROOT, spec.traffic(ROOT, c["traffic"])
                                 ["loop"]), "measure")
        assert hasattr(spec.reference(ROOT, cfg["reference"]), "run")
        kinds = [spec.cell_metrics(bench, c["name"], k)
                 for k in ("end_to_end", "per_layer")]
        assert "setup_s" in [m["name"] for m in kinds[0]]
        assert len(kinds[0]) >= 2 and kinds[1]


def test_clock_gap_pairs_marks_with_their_host_copies():
    from perfbench.timing import Interval, clock_gap
    marks = [Interval("engine.run", 1.0, 2.0), Interval("engine.run", 3.0, 4.0),
             Interval("bench.loop", 0.5, 5.0)]
    own = [Interval("engine.run", 11.0, 12.0),
           Interval("engine.run", 13.004, 14.0),
           Interval("bench.loop", 10.5, 15.0),
           Interval("serve.loop", 10.0, 11.0)]     # no mark: not paired
    assert abs(clock_gap(marks, own, -10.0) - 0.004) < 1e-12
    assert clock_gap(marks[:1], own, -10.0) is None   # counts differ
