"""Parity of the port's trace replay with the JAX reference.

``repro_torch.serve.replay`` (``ArrivalTrace``, ``SoakReport``,
``replay``) against ``repro.serve.replay`` on the same traces, policies
and deterministic service models: the generated traces, every
``SoakReport`` number, its ``fingerprint()``, the shed counts and every
per-queue stage array are identical (tolerance 0), for Poisson and
bursty traces at two seeds, on the shared and on per-engine clocks; a
trace saved by either package loads in the other. Mirrors
``tests/test_serving_soak.py``. Pure numpy: no engine runs.
"""
import dataclasses

import numpy as np
import pytest

import repro.serve as ref_serve
import repro_torch.serve as port_serve

POLICIES = {
    "overload": dict(max_batch=8, max_wait_us=200.0, max_queue=64,
                     deadline_us=20_000.0, shed="reject"),
    "drop-oldest": dict(max_batch=4, max_wait_us=100.0, max_queue=16,
                        shed="drop-oldest"),
    "degrade": dict(max_batch=8, max_queue=24, shed="degrade"),
}
SERVICE = dict(base_us=200.0, per_sample_us=25.0)


def _trace(pkg, kind, seed):
    if kind == "poisson":
        return pkg.ArrivalTrace.poisson(6000.0, 4.0, seed=seed, n_streams=4)
    return pkg.ArrivalTrace.bursty(3000.0, 4.0, seed=seed, n_streams=8,
                                   burst_factor=8.0, period_s=0.5, duty=0.15)


def assert_same_report(got, want):
    assert got.fingerprint() == want.fingerprint()
    for f in dataclasses.fields(want):
        if f.name != "results":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.shed_frac == want.shed_frac
    assert got.deadline_miss_frac == want.deadline_miss_frac
    assert got.results.keys() == want.results.keys()
    for name, w in want.results.items():
        g = got.results[name]
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name == "batches":
                assert [dataclasses.asdict(x) for x in a] == \
                    [dataclasses.asdict(x) for x in b]
            elif f.name != "outputs":
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert g.shed_counts() == w.shed_counts()
        np.testing.assert_array_equal(g.stage_sum(), w.stage_sum())


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_replay_matches_reference(kind, seed, policy):
    ref_tr, port_tr = _trace(ref_serve, kind, seed), _trace(port_serve, kind,
                                                              seed)
    np.testing.assert_array_equal(port_tr.arrivals_us, ref_tr.arrivals_us)
    np.testing.assert_array_equal(port_tr.streams, ref_tr.streams)
    assert (port_tr.kind, port_tr.seed, port_tr.duration_us) == \
        (ref_tr.kind, ref_tr.seed, ref_tr.duration_us)
    want = ref_serve.replay(ref_tr, ref_serve.BatchPolicy(**POLICIES[policy]),
                            ref_serve.linear_service_model(**SERVICE))
    got = port_serve.replay(port_tr,
                            port_serve.BatchPolicy(**POLICIES[policy]),
                            port_serve.linear_service_model(**SERVICE))
    assert got.stage_sum_exact and want.stage_sum_exact
    assert_same_report(got, want)


@pytest.mark.parametrize("shared", [True, False])
def test_multi_model_replay_matches_reference(shared):
    def traces(pkg):
        return {"a": _trace(pkg, "poisson", 1), "b": _trace(pkg, "bursty", 2)}

    def policies(pkg):
        return {"a": pkg.BatchPolicy(**POLICIES["overload"]),
                "b": pkg.BatchPolicy(**POLICIES["drop-oldest"])}

    def models(pkg):
        return {"a": pkg.linear_service_model(**SERVICE),
                "b": pkg.linear_service_model(150.0, 40.0)}

    want = ref_serve.replay(traces(ref_serve), policies(ref_serve),
                            models(ref_serve), shared=shared)
    got = port_serve.replay(traces(port_serve), policies(port_serve),
                            models(port_serve), shared=shared)
    assert_same_report(got, want)
    assert got.requests == sum(r.n_requests for r in got.results.values())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_traces_load_across_packages(tmp_path, writer):
    src, dst = ((ref_serve, port_serve) if writer == "reference"
                else (port_serve, ref_serve))
    for i, tr in enumerate([src.ArrivalTrace.bursty(500.0, 3.0, seed=9,
                                                    n_streams=3),
                            src.ArrivalTrace(np.array([0.0, 5.0, 5.0]),
                                             np.array([0, 1, 0]), 10.0)]):
        path = tmp_path / f"trace{i}.npz"
        tr.save(path)
        back = dst.ArrivalTrace.load(path)
        np.testing.assert_array_equal(back.arrivals_us, tr.arrivals_us)
        np.testing.assert_array_equal(back.streams, tr.streams)
        assert (back.duration_us, back.kind, back.seed) == \
            (tr.duration_us, tr.kind, tr.seed)
        again = tmp_path / f"again{i}.npz"
        back.save(again)
        assert again.read_bytes() == path.read_bytes()   # byte-compatible


def test_replay_validation_and_slo_bars():
    tr = port_serve.ArrivalTrace.poisson(500.0, 2.0, seed=1)
    with pytest.raises(ValueError, match="service_model"):
        port_serve.replay(tr, port_serve.BatchPolicy())
    with pytest.raises(ValueError, match="no policy"):
        port_serve.replay({"a": tr, "b": tr}, {"a": port_serve.BatchPolicy()},
                          port_serve.linear_service_model())
    with pytest.raises(ValueError, match="at least one"):
        port_serve.replay({}, port_serve.BatchPolicy(),
                          port_serve.linear_service_model())
    with pytest.raises(ValueError, match="nondecreasing"):
        port_serve.ArrivalTrace(np.array([1.0, 0.5]), np.zeros(2), 10.0)
    with pytest.raises(ValueError, match="duty"):
        port_serve.ArrivalTrace.bursty(100.0, 1.0, duty=1.5)
    rep = port_serve.replay(_trace(port_serve, "bursty", 3),
                            port_serve.BatchPolicy(**POLICIES["overload"]),
                            port_serve.linear_service_model(**SERVICE))
    want = ref_serve.replay(_trace(ref_serve, "bursty", 3),
                            ref_serve.BatchPolicy(**POLICIES["overload"]),
                            ref_serve.linear_service_model(**SERVICE))
    for bounds in (dict(slo_p99_ms=1e9, max_shed_frac=1.0),
                   dict(slo_p99_ms=1e-6, max_shed_frac=0.0,
                        max_deadline_miss_frac=0.0)):
        assert rep.check(**bounds) == want.check(**bounds)
    assert rep.shed_frac > 0.0                       # overload really bites
    with pytest.raises(AssertionError, match="soak SLO violated"):
        rep.assert_slo(max_shed_frac=0.0)
