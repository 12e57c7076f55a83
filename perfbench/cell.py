"""One run of one cell: set-up, the measured window, the reading of the
metrics, and the comparison that decides ``correct``.

Set-up (``setup_s``, from the process's start to the window's opening)
draws the network from the seed, compiles it (``repro_torch.core
.compile`` on the configuration's hardware), makes the pool of inputs,
captures the shapes the mix uses and warms them. The comparison runs
after the window has closed and the device's peak has been read, on the
host, and is not counted in ``setup_s``.
"""
from __future__ import annotations

import bisect
import dataclasses
import resource
import statistics
import sys
import time
from pathlib import Path

from perfbench import check, inputs, network, peaks, spec, timing, workload

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """What a metric's reader reads."""
    cell: dict
    cfg: dict
    mix: dict
    net: dict                        # synapses, timesteps, n_inputs, ...
    setup_s: float
    compile_s: float
    window: workload.Window
    window_span: str
    trace: timing.Trace | None
    direct_ms: float | None
    root: Path
    peaks = peaks

    def kernel(self, name: str):
        return spec.kernel(self.root, name)

    def traced_window(self) -> tuple[float, float] | None:
        """The window on the profiler's clock, or None untraced."""
        if self.trace is None:
            return None
        spans = self.trace.spans_named(self.window_span)
        return (spans[0].start, spans[-1].end) if spans else None


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden (an entry
    set to None blocks an import; it is no module). The command asks
    just before it prints the result, so that whatever the window, the
    reference and the metrics' readers loaded is seen."""
    return sorted({m.split(".")[0] for m, mod in list(sys.modules.items())
                   if mod is not None and m.split(".")[0] in FORBIDDEN})


def device_info(device: str, n: int) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(n))}


def _direct_ms(program, run_spec, batch, device: str) -> float:
    """Wall ms of one direct ``Program.run`` on ``batch``: the median of
    calls back to back (each ends in its copies to the host)."""
    call = lambda: program.run(batch, run_spec)
    if device != "cpu":
        return timing.median_ms(call, iters=20, repeats=5)
    times = []
    for _ in range(5):
        t = time.perf_counter()
        call()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _rusage_delta(a, b) -> dict:
    """The host CPU seconds that the process used over the window."""
    return {"user_s": b.ru_utime - a.ru_utime,
            "sys_s": b.ru_stime - a.ru_stime}


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             mix_override: dict | None = None, substitute=None,
             stamps: list | None = None) -> dict:
    """Set up, measure and check one cell; returns the result line's
    dict. ``substitute(program, net, cfg)`` puts another program in the
    program's place (the control and the planted faults of the tests);
    ``mix_override`` changes sizes of the mix (the tests' small runs);
    ``stamps`` are the caller's named moments of set-up before this."""
    import torch
    from repro_torch.core import ExecutionSpec, HardwareConfig, compile

    stamps = list(stamps or []) + [("import_program",
                                    time.perf_counter())]
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], cell_name, "workload")
    cfg = spec.config(root, bench, cell["config"])
    mix = {**spec.traffic(root, cell["traffic"]), **(mix_override or {})}
    tracer = timing.Tracer(trace)

    net = network.draw_network(cfg, seed)
    t = time.perf_counter()
    program = compile(network.to_program_input(net),
                      HardwareConfig(**cfg["hardware"]),
                      max_iters=cfg["compile"]["max_iters"])
    compile_s = time.perf_counter() - t
    stamps.append(("network_and_compile", time.perf_counter()))
    if substitute is not None:
        program = substitute(program, net, cfg)
    run_spec = ExecutionSpec(kernel=mix.get("kernel"), device=device)
    pool = inputs.make_pool(root, cfg, network.rng_for(seed, 2), mix["pool"])
    driver = spec.loop(root, mix["loop"])(program, run_spec, pool, mix,
                                          seed, tracer)
    stamps.append(("inputs", time.perf_counter()))
    driver.prepare()
    stamps.append(("capture", time.perf_counter()))

    opened, usage = [], []

    def on_open():
        if device != "cpu":
            torch.cuda.synchronize()
        usage.append(resource.getrusage(resource.RUSAGE_SELF))
        opened.append(time.perf_counter())
        stamps.append(("warm_up", opened[0]))
        tracer.start()

    win = driver.measure(seconds, on_open)
    tr = tracer.stop(driver.span)
    dev = device_info(device, cell["chips"])
    usage.append(resource.getrusage(resource.RUSAGE_SELF))
    direct = (_direct_ms(program, run_spec, driver.direct_input(), device)
              if trace else None)

    ref = spec.reference(root, cfg["reference"])
    exp = check.expected(ref, net, pool)
    tally = check.Tally()
    driver.compare(exp, tally)

    shape = {"synapses": network.expected_synapses(cfg),
             "timesteps": cfg["timesteps"],
             "n_inputs": cfg["layer_sizes"][0],
             "n_internal": sum(cfg["layer_sizes"][1:]),
             "weight_bits": cfg["weight_bits"],
             "batch": mix.get("batch")}
    ctx = Ctx(cell, cfg, mix, shape, opened[0] - t_start, compile_s, win,
              driver.span, tr, direct, root)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell_name, kind):
        value = spec.reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": tally.correct() and win.failed == 0,
              "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        lo, hi = ctx.traced_window()
        merged = tr.device_union()
        result["device"]["busy_s"] = timing.covered(merged, lo, hi)
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = breakdown(tr, merged, lo, hi)
    parts, last = {}, t_start
    for name, at in stamps:
        parts[name] = at - last
        last = at
    result["info"] = {"setup_parts_s": parts, **driver.info(),
                      "by_second": win.by_second(driver.per_call),
                      "rows_compared": tally.rows,
                      "window_s": win.seconds, "calls": win.calls,
                      "completed": win.completed,
                      "synapses_drawn": net.n_synapses,
                      "host_rss_peak_bytes": usage[1].ru_maxrss * 1024,
                      "window_rusage": _rusage_delta(*usage),
                      "trace_clock_gap_ms": (tr.clock_gap_s * 1e3 if tr and
                                             tr.clock_gap_s is not None
                                             else None),
                      "ot_depth": int(program.ot_depth)
                      if hasattr(program, "ot_depth") else None}
    result["checks"] = tally.checks()
    return result


class _Labels:
    """What the host was doing at a moment: the innermost benchmark span
    open then, and the outermost host op inside it on its thread."""

    def __init__(self, tr: timing.Trace):
        self.by_name: dict[str, list] = {}
        for s in tr.spans:
            self.by_name.setdefault(s.name, []).append(s)
        self.starts = {k: [s.start for s in v]
                       for k, v in self.by_name.items()}
        self.ops = tr.ops
        self.op_starts = [o.start for o in tr.ops]

    def at(self, t: float, lookback: int = 256) -> str:
        inner = None
        for name, spans in self.by_name.items():
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and spans[i].end >= t and (inner is None
                                                 or spans[i].dur < inner.dur):
                inner = spans[i]
        if inner is None:
            return "no span"
        op = None
        j = bisect.bisect_right(self.op_starts, t) - 1
        while j >= 0 and lookback:
            o = self.ops[j]
            if o.start < inner.start:
                break
            if o.thread == inner.thread and o.end >= t:
                op = o              # earlier start: an outer op
            j -= 1
            lookback -= 1
        return inner.name + (f"/{op.name}" if op is not None else "")


def breakdown(tr: timing.Trace, merged, lo: float, hi: float) -> dict:
    by_op: dict[str, float] = {}
    for d in tr.device:
        if d.end > lo and d.start < hi:
            by_op[d.name] = by_op.get(d.name, 0.0) + (min(d.end, hi)
                                                      - max(d.start, lo))
    by_gap: dict[str, float] = {}
    labels = _Labels(tr)
    for a, b in timing.gaps(merged, lo, hi):
        key = labels.at((a + b) / 2)
        by_gap[key] = by_gap.get(key, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
