"""The kernel wrappers' launch counters (``repro_torch.kernels.launches``)
on the CPU: no count is lost when 8 threads count at once (the sharded
runner launches from one thread per card), a recording diverts only its
own thread's counts, and every wrapper counts through the helper. Every
CUDA graph capture of the port runs with Python's cyclic collector
paused (``_build.gc_paused``): a graph it frees mid-capture invalidates
the capture."""
from __future__ import annotations

import gc
import importlib
import inspect
import re
import sys
import threading

import pytest

from repro_torch.kernels import _build, launches

THREADS, PER_THREAD = 8, 20_000


def _kernel():
    def kernel():
        pass
    kernel.launches = 0
    return kernel


def test_no_count_lost_across_threads():
    kernel = _kernel()
    start = threading.Barrier(THREADS)

    def work():
        start.wait(timeout=60)
        for _ in range(PER_THREAD):
            launches.count_launch(kernel)
        launches.count_launch(kernel, 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as it can
    try:
        threads = [threading.Thread(target=work) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == THREADS * (PER_THREAD + 3)


def test_recording_diverts_only_its_own_thread():
    kernel, other = _kernel(), _kernel()
    seen = []

    def elsewhere():
        launches.count_launch(kernel, 5)
        seen.append(kernel.launches)

    with launches.recording() as rec:
        launches.count_launch(kernel)
        launches.count_launch(kernel, 2)
        launches.count_launch(other)
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
        with launches.recording() as inner:
            launches.count_launch(other, 7)
        launches.count_launch(other)
    assert rec == {kernel: 3, other: 2} and inner == {other: 7}
    assert seen == [5] and kernel.launches == 5 and other.launches == 0
    launches.count_launch(kernel)
    assert kernel.launches == 6


def test_recording_ends_on_an_error():
    kernel = _kernel()
    with pytest.raises(RuntimeError):
        with launches.recording():
            raise RuntimeError("capture failed")
    launches.count_launch(kernel)
    assert kernel.launches == 1


@pytest.mark.parametrize("module", [
    "kernels.fused_step", "kernels.lif_update", "kernels.spike_accum",
    "kernels.ssd", "kernels.wkv6", "core.engine_torch"])
def test_every_wrapper_counts_through_the_helper(module):
    src = inspect.getsource(importlib.import_module(f"repro_torch.{module}"))
    assert not re.search(r"\.launches\s*\+=", src)
    assert "count_launch(" in src


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_paused_restores_the_collector(enabled):
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with _build.gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with _build.gc_paused():
                raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("module", ["core.engine_torch", "train.steps"])
def test_every_capture_pauses_the_collector(module):
    src = inspect.getsource(importlib.import_module(f"repro_torch.{module}"))
    captures = re.findall(r"with ([^:]*?)torch\.cuda\.graph\(", src, re.S)
    assert captures and all("gc_paused()" in c for c in captures)
