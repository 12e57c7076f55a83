"""Parity of the port's asyncio server with the JAX reference.

``repro_torch.serve.AsyncServer`` mirrors the ``AsyncServer`` tests of
``tests/test_serving.py``: lifecycle, an unknown model, reject and
drop-oldest backpressure, a deadline miss and a stop without drain on a
sleeping service model, with the reference's ``_eventually`` timeouts;
in engine mode every output is bit-exact (tolerance 0) with
``program.run`` and with the reference ``AsyncServer``'s outputs on the
same requests, and every ``CompletedRequest``'s stage sum equals its
latency exactly. The port's engine runs on the CPU here
(``spec=ExecutionSpec(device="cpu")``).
"""
import asyncio

import numpy as np
import pytest
import torch

import repro.serve as ref_serve
import repro_torch.serve as port_serve
from conftest import make_feedforward, make_hw
from repro.core import compile
from repro_torch.core import ExecutionSpec
from repro_torch.serve import (AsyncServer, BatchPolicy, DeadlineMissError,
                               QueueFullError, Request, ShedError,
                               linear_service_model)
from torch_parity import carry

CPU = ExecutionSpec(device="cpu")
SLOW_50MS = linear_service_model(50_000.0, 0.0)


async def _eventually(pred, timeout=5.0):
    """Poll until ``pred()`` — bounds timing races without sleeps
    tuned to scheduler luck (the reference's helper)."""
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(0.005)


@pytest.fixture(scope="module")
def programs():
    g = make_feedforward()
    ref = compile(g, make_hw(g), max_iters=4000)
    return ref, carry(ref)


def _registry(program, pkg=port_serve):
    reg = pkg.ProgramRegistry()
    reg.register("m", program)
    return reg


def _ext(program, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((6, program.graph.n_inputs)) < 0.3).astype(np.int32)


def _req(program, seed=0):
    return Request("m", _ext(program, seed), 0.0, stream=seed)


def _stage_sum(c):
    return ((c.queue_wait_us + c.fill_wait_us) + c.pad_us) + c.compute_us


def test_serves_with_bit_exact_stages(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(_registry(port),
                          policy=BatchPolicy(max_batch=4, max_wait_us=3000.0),
                          service_model=linear_service_model(2000.0, 100.0))
        async with srv:
            done = await asyncio.gather(
                *[srv.submit(_req(port, i)) for i in range(8)])
        for c in done:
            assert _stage_sum(c) == c.latency_us        # bit-exact
            assert c.model == "m" and c.bucket in (1, 2, 4)
            assert 1 <= c.batch_size <= 4 and not c.degraded
            assert c.outputs is None                   # no engine ran
        assert sorted(c.stream for c in done) == list(range(8))
        m = srv.metrics()
        assert m["total"]["requests"] == 8
        assert m["total"]["timeline"] == "real"
        assert m["total"]["shed"] == {"queue_full": 0, "deadline": 0}
        assert set(m["total"]["stages_us"]) == {"queue_wait", "batch_fill",
                                                "pad", "compute"}
    asyncio.run(main())


def test_lifecycle_and_unknown_model(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(_registry(port), service_model=SLOW_50MS)
        with pytest.raises(RuntimeError, match="not started"):
            await srv.submit(_req(port))
        async with srv:
            with pytest.raises(KeyError, match="nope"):
                await srv.submit(Request("nope", np.zeros((4, 2), np.int32),
                                         0.0))
            with pytest.raises(RuntimeError, match="already started"):
                await srv.start()
    asyncio.run(main())


def test_reject_backpressure(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(
            _registry(port),
            policy=BatchPolicy(max_batch=1, max_queue=1, shed="reject"),
            service_model=SLOW_50MS)
        async with srv:
            t1 = asyncio.create_task(srv.submit(_req(port, 1)))
            await _eventually(lambda: srv._dequeued["m"] == 1)
            t2 = asyncio.create_task(srv.submit(_req(port, 2)))
            await _eventually(lambda: len(srv._queues["m"]) == 1)
            with pytest.raises(QueueFullError, match="queue full"):
                await srv.submit(_req(port, 3))
            done = await asyncio.gather(t1, t2)
        assert [c.stream for c in done] == [1, 2]      # FIFO survivors
        m = srv.metrics()
        assert m["total"]["shed"] == {"queue_full": 1, "deadline": 0}
        assert m["total"]["shed_frac"] == pytest.approx(1 / 3)
    asyncio.run(main())


def test_drop_oldest_fails_the_old_await(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(
            _registry(port),
            policy=BatchPolicy(max_batch=1, max_queue=1, shed="drop-oldest"),
            service_model=SLOW_50MS)
        async with srv:
            t1 = asyncio.create_task(srv.submit(_req(port, 1)))
            await _eventually(lambda: srv._dequeued["m"] == 1)
            t2 = asyncio.create_task(srv.submit(_req(port, 2)))
            await _eventually(lambda: len(srv._queues["m"]) == 1)
            t3 = asyncio.create_task(srv.submit(_req(port, 3)))
            r1, r2, r3 = await asyncio.gather(t1, t2, t3,
                                              return_exceptions=True)
        assert r1.stream == 1 and r3.stream == 3       # newest survived
        assert isinstance(r2, QueueFullError)          # oldest was shed
        assert "drop-oldest" in str(r2)
    asyncio.run(main())


def test_deadline_miss_raises(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(
            _registry(port),
            policy=BatchPolicy(max_batch=1, deadline_us=10_000.0),
            service_model=linear_service_model(60_000.0, 0.0))
        async with srv:
            t1 = asyncio.create_task(srv.submit(_req(port, 1)))
            await _eventually(lambda: srv._dequeued["m"] == 1)
            t2 = asyncio.create_task(srv.submit(_req(port, 2)))
            r1, r2 = await asyncio.gather(t1, t2, return_exceptions=True)
        assert r1.stream == 1
        assert isinstance(r2, DeadlineMissError)
        assert srv.metrics()["total"]["deadline_misses"] == 1
    asyncio.run(main())


def test_stop_without_drain_sheds_pending(programs):
    _, port = programs

    async def main():
        srv = AsyncServer(_registry(port), policy=BatchPolicy(max_batch=1),
                          service_model=SLOW_50MS)
        await srv.start()
        t1 = asyncio.create_task(srv.submit(_req(port, 1)))
        await _eventually(lambda: srv._dequeued["m"] == 1)
        t2 = asyncio.create_task(srv.submit(_req(port, 2)))
        await _eventually(lambda: len(srv._queues["m"]) == 1)
        await srv.stop(drain=False)
        r1, r2 = await asyncio.gather(t1, t2, return_exceptions=True)
        assert r1.stream == 1                          # in flight: finished
        assert isinstance(r2, ShedError)               # queued: shed
        assert not isinstance(r2, (QueueFullError, DeadlineMissError))
    asyncio.run(main())


def test_engine_mode_outputs_bit_exact(programs):
    """Engine mode: the port's outputs equal program.run and the
    reference AsyncServer's outputs on the same requests."""
    ref, port = programs
    exts = [_ext(port, i) for i in range(7)]

    async def serve(srv, pkg):
        async with srv:
            return await asyncio.gather(*[
                srv.submit(pkg.Request("m", e, 0.0, stream=i))
                for i, e in enumerate(exts)])

    policy = dict(max_batch=4, max_wait_us=5000.0)
    got = asyncio.run(serve(AsyncServer(_registry(port),
                                        policy=BatchPolicy(**policy),
                                        spec=CPU), port_serve))
    want = asyncio.run(serve(ref_serve.AsyncServer(
        _registry(ref, ref_serve), policy=ref_serve.BatchPolicy(**policy)),
        ref_serve))
    by_ref = {c.stream: c for c in want}
    for c in got:
        assert _stage_sum(c) == c.latency_us
        s, v, st = port.run(exts[c.stream], CPU)
        r = by_ref[c.stream]
        for a, b in ((c.outputs[0], s), (c.outputs[1], v),
                     (c.outputs[2], st["packet_counts"]),
                     (c.outputs[0], r.outputs[0]),
                     (c.outputs[1], r.outputs[1]),
                     (c.outputs[2], r.outputs[2])):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    assert sorted(c.stream for c in got) == list(range(len(exts)))


def test_engine_mode_resolves_the_device_at_start(programs, monkeypatch):
    """The runner and its device resolve at start: with no card and the
    device left to default, start raises (no fallback to the CPU); on
    the CPU the executor thread runs with that device."""
    _, port = programs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        srv = AsyncServer(_registry(port))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await srv.start()
        srv = AsyncServer(_registry(port), spec=CPU)
        async with srv:
            assert srv._runners["m"][1] == torch.device("cpu")
    asyncio.run(main())


def test_engine_error_fails_the_batch_and_serving_goes_on(programs):
    _, port = programs

    class Failing(AsyncServer):
        calls = 0

        def _run_engine(self, runner, batch, device):
            Failing.calls += 1
            if Failing.calls == 1:
                raise RuntimeError("engine fault")
            return super()._run_engine(runner, batch, device)

    async def main():
        srv = Failing(_registry(port), policy=BatchPolicy(max_batch=1),
                      spec=CPU)
        async with srv:
            r1 = await asyncio.gather(srv.submit(_req(port, 1)),
                                      return_exceptions=True)
            r2 = await srv.submit(_req(port, 2))
        assert isinstance(r1[0], RuntimeError) and "engine fault" in str(r1[0])
        assert r2.stream == 2 and r2.outputs is not None
        assert srv.metrics()["total"]["requests"] == 1
    asyncio.run(main())
