"""The port's multi-chip accounting against the reference's, bit for bit,
on the CPU: programs compiled by the reference for 2 and 4 chips
(``repro.core.scale.scale_hw``, a 2 x 1 chain and a 2 x 2 mesh), saved
and loaded by the port. ``Program.chip_span``, ``mesh_hops`` and
``inter_chip_counts`` (of the port's own run), the hypergraph module's
``HyperView``, ``multicast_dests``, ``mapping_traffic`` and
``inter_chip_packet_counts``, and ``profile(stats,
inter_chip_counts=...)`` equal the reference's; at one chip the chip
terms vanish and the profile is the single-chip one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from conftest import make_ext
from repro.core import Program as JaxProgram
from repro.core import compile as jax_compile
from repro.core import random_graph as jax_random_graph
from repro.core.mapping import hypergraph as JH
from repro.core.scale import scale_hw
from repro_torch.core import ExecutionSpec, Program
from repro_torch.core.mapping import hypergraph as H

CPU = ExecutionSpec(device="cpu")


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"chips{n}")
def programs(request, tmp_path_factory):
    """A reference-compiled program on ``n`` chips, in both packages."""
    n = request.param
    g = jax_random_graph(24, 40, 900, seed=3)
    hw = scale_hw(g, n_chips=n, spus_per_chip=4)
    jp = jax_compile(g, hw, method="hypergraph")
    path = jp.save(tmp_path_factory.mktemp("multichip") / f"chips{n}")
    return n, Program.load(path), JaxProgram.load(path)


def test_hw_and_static_accounting(programs):
    n, p, jp = programs
    assert p.hw.n_chips == n and p.hw.mesh_dims == jp.hw.mesh_dims
    for fn in ("chip_span", "mesh_hops"):
        got, want = getattr(p, fn)(), getattr(jp, fn)()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)
    assert (p.chip_span() > 1).any() == (n > 1)
    assert (p.mesh_hops() > 0).any() == (n > 1)
    g, a = p.graph, p.tables.assign
    np.testing.assert_array_equal(H.multicast_dests(g, a, p.hw.n_spus),
                                  JH.multicast_dests(jp.graph, a,
                                                     jp.hw.n_spus))
    assert H.mapping_traffic(g, a, p.hw) == \
        JH.mapping_traffic(jp.graph, a, jp.hw)
    hv, jhv = H.hyper_view(g), JH.hyper_view(jp.graph)
    for f in dataclasses.fields(hv):
        np.testing.assert_array_equal(getattr(hv, f.name),
                                      getattr(jhv, f.name), err_msg=f.name)
    assert hv.n_posts == jhv.n_posts
    np.testing.assert_array_equal(hv.fanin(0), jhv.fanin(0))


def test_run_counts_and_profile(programs):
    n, p, jp = programs
    ext = make_ext(p.graph, 3, 12, rate=0.4, seed=n)
    s, v, stats = p.run(ext, CPU)
    js, jv, jstats = jp.run(ext, "oracle")
    np.testing.assert_array_equal(s, js)
    for batched in (True, False):
        e, sp = (ext, s) if batched else (ext[0], s[0])
        got = p.inter_chip_counts(e, sp)
        want = jp.inter_chip_counts(e, sp)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            H.inter_chip_packet_counts(e, sp, p.chip_span()),
            JH.inter_chip_packet_counts(e, sp, jp.chip_span()))
    ic = p.inter_chip_counts(ext, s)
    assert (ic.sum() > 0) == (n > 1)
    got = p.profile(stats, inter_chip_counts=ic)
    want = jp.profile(jstats, inter_chip_counts=ic)
    assert dataclasses.asdict(got.cycle) == dataclasses.asdict(want.cycle)
    assert [dataclasses.asdict(r) for r in got.per_sample] == \
        [dataclasses.asdict(r) for r in want.per_sample]
    single = p.profile(stats)
    if n == 1:
        assert dataclasses.asdict(got.cycle) == \
            dataclasses.asdict(single.cycle)
    else:
        assert got.cycle.cycles_total > single.cycle.cycles_total
    with pytest.raises(ValueError, match="inter_chip_counts shape"):
        p.profile(stats, inter_chip_counts=ic[:, :-1])


def test_verify_is_clean_on_every_chip_count(programs):
    _, p, jp = programs
    rep, want = p.verify(), jp.verify()
    assert rep.ok and not rep.diagnostics, rep.summary()
    assert rep.stats == want.stats


def test_rejects_malformed_spike_arrays():
    g = jax_random_graph(4, 6, 20, seed=1)
    with pytest.raises(ValueError, match="matching"):
        H.inter_chip_hop_counts(np.zeros((3, 4)), np.zeros((2, 3, 6)),
                                np.zeros(g.n_neurons))
