"""Parity of the port's serving layer with the JAX reference.

``repro_torch.serve`` (``MicroBatcher``, ``drain_together``, ``Server``,
``ProgramRegistry``) against ``repro.serve`` on the same arrivals,
policies and requests, under a deterministic ``linear_service_model()``:
every ``DrainResult`` array (latencies, dispatch and completion times,
the per-stage queue/fill/pad/compute split, served and shed codes and
times), every batch record and every served output is identical, and so
is every number of ``Server.serve``'s metrics. Tolerance 0 throughout.
The port's engine runs on the CPU here (``device="cpu"``).
"""
import dataclasses

import numpy as np
import pytest

import repro.serve as ref_serve
import repro_torch.serve as port_serve
from conftest import make_ext, make_feedforward, make_hw
from repro.core import compile, random_graph
from repro_torch.core import ExecutionSpec
from torch_parity import carry

CPU = ExecutionSpec(device="cpu")
POLICIES = [
    dict(max_batch=4),
    dict(max_batch=4, max_wait_us=300.0),
    dict(max_batch=8, max_wait_us=1000.0, buckets=(2, 8)),
    dict(max_batch=4, max_queue=3, shed="reject"),
    dict(max_batch=4, max_queue=3, shed="drop-oldest"),
    dict(max_batch=8, max_queue=5, shed="degrade"),
    dict(max_batch=4, max_wait_us=200.0, deadline_us=900.0),
]


def _arrivals(n, mean_gap_us, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(mean_gap_us, n))


def assert_same_drain(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "batches":
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b]
        elif f.name == "outputs":
            assert (a is None) == (b is None)
            if b is not None:
                for x, y in zip(a, b):
                    assert np.asarray(x).dtype == np.asarray(y).dtype
                    np.testing.assert_array_equal(x, y)
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.metrics() == want.metrics()
    assert got.shed_counts() == want.shed_counts()


@pytest.fixture(scope="module")
def models():
    ff = make_feedforward()
    rec = random_graph(12, 20, 160, seed=3)
    return {"ff": compile(ff, make_hw(ff), max_iters=4000),
            "rec": compile(rec, make_hw(rec), max_iters=4000)}


@pytest.mark.parametrize("policy", POLICIES)
def test_simulated_drain_matches_reference(policy):
    arr = _arrivals(200, 120.0, seed=len(str(policy)))
    model = dict(base_us=150.0, per_sample_us=40.0)
    want = ref_serve.MicroBatcher(
        ref_serve.BatchPolicy(**policy),
        service_model=ref_serve.linear_service_model(**model)).drain(arr)
    got = port_serve.MicroBatcher(
        port_serve.BatchPolicy(**policy),
        service_model=port_serve.linear_service_model(**model)).drain(arr)
    assert_same_drain(got, want)


@pytest.mark.parametrize("kind", ["ff", "rec"])
@pytest.mark.parametrize("policy", [POLICIES[1], POLICIES[4]])
def test_served_outputs_match_reference(models, kind, policy):
    ref = models[kind]
    ext = make_ext(ref.graph, 23, 6, seed=5)
    arr = _arrivals(23, 150.0, seed=1)
    ref_reg, port_reg = ref_serve.ProgramRegistry(), port_serve.ProgramRegistry()
    ref_reg.register(kind, ref)
    port_reg.register(kind, carry(ref))
    want = ref_serve.MicroBatcher(
        ref_serve.BatchPolicy(**policy), runner=ref_reg.runner(kind),
        service_model=ref_serve.linear_service_model()).drain(arr, ext)
    got = port_serve.MicroBatcher(
        port_serve.BatchPolicy(**policy), runner=port_reg.runner(kind, CPU),
        service_model=port_serve.linear_service_model()).drain(arr, ext)
    assert_same_drain(got, want)
    served = np.flatnonzero(got.served)
    assert len(served) and len(served) == len(got.outputs[0])


def test_drain_together_matches_reference():
    policies = [POLICIES[1], POLICIES[3], POLICIES[5]]
    arrs = [_arrivals(60, 90.0, seed=s) for s in range(3)]

    def run(serve):
        items = [(serve.MicroBatcher(serve.BatchPolicy(**p),
                                     service_model=serve.linear_service_model()),
                  a, None) for p, a in zip(policies, arrs)]
        return serve.drain_together(items)

    for got, want in zip(run(port_serve), run(ref_serve)):
        assert_same_drain(got, want)


@pytest.mark.parametrize("timeline", ["shared", "per-engine"])
def test_server_metrics_match_reference(models, timeline):
    order = np.random.default_rng(2).permutation(30)   # Server sorts
    streams = []
    for serve in (ref_serve, port_serve):
        stream = []
        for k in order:
            name = ("ff", "rec")[k % 2]
            g = models[name].graph
            ext = (np.random.default_rng(k).random((5, g.n_inputs)) < 0.3
                   ).astype(np.int32)
            stream.append(serve.Request(name, ext, float(k * 70), k % 3))
        streams.append(stream)
    ref_reg, port_reg = ref_serve.ProgramRegistry(), port_serve.ProgramRegistry()
    for name, prog in models.items():
        policy = dict(max_batch=4, max_wait_us=100.0)
        ref_reg.register(name, prog,
                         policy=ref_serve.BatchPolicy(**policy))
        port_reg.register(name, carry(prog),
                          policy=port_serve.BatchPolicy(**policy))
    want_srv = ref_serve.Server(
        ref_reg, service_model=ref_serve.linear_service_model(),
        timeline=timeline)
    got_srv = port_serve.Server(
        port_reg, service_model=port_serve.linear_service_model(),
        spec=CPU, timeline=timeline)
    want = want_srv.serve(streams[0])
    got = got_srv.serve(streams[1])
    assert got == want
    for name in models:
        assert_same_drain(got_srv.last_results[name],
                          want_srv.last_results[name])


def test_registry_surface(models, tmp_path):
    reg = port_serve.ProgramRegistry()
    policy = port_serve.BatchPolicy(max_batch=2)
    prog = reg.load("rec", models["rec"].save(tmp_path / "rec"),
                    precompile=policy, timesteps=4, spec=CPU, policy=policy)
    assert reg.names() == ("rec",) and "rec" in reg and len(reg) == 1
    assert reg.get("rec") is prog and reg.policy("rec") is policy
    runner = reg.runner("rec", CPU)
    assert runner.precompile((1, 2), 4) == []          # warmed at insert
    assert runner.precompile((3,), 4) == [(3, 4)]
    assert reg.register("again", prog, verify=True) is prog   # clean
    assert reg.unregister("again") is prog
    with pytest.raises(ValueError):
        reg.register("rec", prog)
    assert reg.unregister("rec") is prog and len(reg) == 0
