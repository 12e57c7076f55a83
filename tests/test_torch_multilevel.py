"""The port's compiler-scale mapping (``hypergraph``, ``multilevel``,
``scale`` and the portfolio search) against the reference's, bit for
bit, on the CPU:

* ``coarsen_graph``: the cluster map, the synapse map, the level count
  and the coarse graph;
* ``hypergraph_partition``, ``refine_mapping`` (and its
  ``RefineStats``), ``balance_loads`` (and its stats) and
  ``place_chips`` on 1 and 4 chips;
* ``multilevel_partition`` forced down its coarsen path with a small
  ``coarse_target`` (the greedy seed alone and raced against a capped
  framework seed), on 1 and 4 chips;
* ``synthetic_graph`` for all three topologies and ``scale_hw``;
* ``portfolio_search``: the trace (but for ``seconds``), the winner and
  its tables; one run fanned over two spawned workers equals the
  inline one, and a binding budget keeps the reference's properties
  (the exhausted flag, a prefix of the fixed candidate order).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

import repro.core as J
from conftest import make_hw
from repro.core.mapping import hypergraph as JH
from repro.core.mapping import multilevel as JML
from repro.core.mapping.search import portfolio_search as jax_portfolio
from repro.core import scale as JS
from repro_torch.core import SearchConfig, portfolio_search
from repro_torch.core import scale as S
from repro_torch.core.mapping import hypergraph as H
from repro_torch.core.mapping import multilevel as ML
from repro_torch.core.mapping.search import framework_partition
from torch_parity import (assert_same_partition, port_graph, port_hw,
                          without_wall_times)


def _graph_hw(n_chips, m=16):
    """``tests/test_multilevel.py``'s 3000-synapse graph, M SPUs over
    ``n_chips`` chips, in both packages."""
    jg = J.random_graph(24, 48, 3000, seed=7)
    jhw = dataclasses.replace(make_hw(jg, m=m, k=3), n_chips=n_chips)
    return jg, jhw, port_graph(jg), port_hw(jhw)


def _assert_arrays(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _trace_rows(trace) -> dict:
    return without_wall_times(
        {"report": {"search": trace.to_json()}})["report"]["search"]


# -- coarsening ----------------------------------------------------------------

@pytest.mark.parametrize("coarse_target", [500, 1200])
def test_coarsen_graph_equals_reference(coarse_target):
    jg, jhw, g, hw = _graph_hw(1, m=8)
    cg = ML.coarsen_graph(g, hw, coarse_target=coarse_target)
    jcg = JML.coarsen_graph(jg, jhw, coarse_target=coarse_target)
    assert (cg.n_clusters, cg.levels) == (jcg.n_clusters, jcg.levels)
    assert cg.levels >= 1
    _assert_arrays(cg.cluster, jcg.cluster, "cluster")
    _assert_arrays(cg.syn_map, jcg.syn_map, "syn_map")
    for f in ("pre", "post", "weight"):
        _assert_arrays(getattr(cg.graph, f), getattr(jcg.graph, f), f)
    assert (cg.graph.n_inputs, cg.graph.n_neurons) == \
        (jcg.graph.n_inputs, jcg.graph.n_neurons)


# -- the greedy partitioner, refinement, balancing, placement ------------------

@pytest.mark.parametrize("n_chips", [1, 4])
@pytest.mark.parametrize("balance", [True, False])
def test_hypergraph_partition_equals_reference(n_chips, balance):
    jg, jhw, g, hw = _graph_hw(n_chips)
    assert_same_partition(H.hypergraph_partition(g, hw, balance=balance),
                          JH.hypergraph_partition(jg, jhw, balance=balance))


@pytest.mark.parametrize("n_chips", [1, 4])
def test_refine_mapping_equals_reference(n_chips):
    jg = J.random_graph(20, 40, 1500, seed=1)
    jhw = J.HardwareConfig(n_spus=8, unified_mem_depth=40, concentration=3,
                           max_neurons=128, max_post_neurons=64,
                           n_chips=n_chips)
    a0 = np.random.default_rng(1).integers(0, 8, jg.n_synapses) \
        .astype(np.int32)
    got, st = H.refine_mapping(port_graph(jg), port_hw(jhw), a0.copy(),
                               passes=3)
    want, jst = JH.refine_mapping(jg, jhw, a0.copy(), passes=3)
    _assert_arrays(got, want, "assign")
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.moves > 0


@pytest.mark.parametrize("n_chips", [1, 4])
def test_balance_loads_equals_reference(n_chips):
    jg, jhw, g, hw = _graph_hw(n_chips)
    start = JH.hypergraph_partition(jg, jhw, balance=False).assign
    got, st = H.balance_loads(g, hw, start.copy())
    want, jst = JH.balance_loads(jg, jhw, start.copy())
    _assert_arrays(got, want, "assign")
    assert st == jst


@pytest.mark.parametrize("n_chips", [1, 4])
def test_place_chips_equals_reference(n_chips):
    jg, jhw, g, hw = _graph_hw(n_chips)
    start = JH.hypergraph_partition(jg, jhw).assign
    got = ML.place_chips(g, hw, start.copy())
    _assert_arrays(got, JML.place_chips(jg, jhw, start.copy()))
    if n_chips == 1:
        _assert_arrays(got, start)
    _assert_arrays(H.mesh_hops(g, got, hw), JH.mesh_hops(jg, got, jhw))


# -- the multilevel partitioner ------------------------------------------------

@pytest.mark.parametrize("n_chips", [1, 4])
@pytest.mark.parametrize("restarts", [1, 2])
def test_multilevel_coarsen_path_equals_reference(n_chips, restarts):
    jg, jhw, g, hw = _graph_hw(n_chips)
    kw = dict(seed=0, coarse_target=500, max_iters=3000, restarts=restarts)
    got = ML.multilevel_partition(g, hw, **kw)
    assert_same_partition(got, JML.multilevel_partition(jg, jhw, **kw))
    assert got.feasible


# -- the scale generators ------------------------------------------------------

@pytest.mark.parametrize("topology", S.TOPOLOGIES)
def test_synthetic_graph_and_scale_hw_equal_reference(topology):
    assert S.TOPOLOGIES == JS.TOPOLOGIES
    kw = dict(topology=topology, skew=1.0, seed=3)
    g, jg = S.synthetic_graph(20_000, **kw), JS.synthetic_graph(20_000, **kw)
    for f in ("pre", "post", "weight"):
        _assert_arrays(getattr(g, f), getattr(jg, f), f)
    assert (g.n_inputs, g.n_neurons, tuple(g.output_slice),
            tuple(g.lif)) == (jg.n_inputs, jg.n_neurons,
                              tuple(jg.output_slice), tuple(jg.lif))
    g.validate()
    for chips, mesh in ((1, {}), (4, {}), (2, dict(mesh_x=2, mesh_y=1))):
        hw = S.scale_hw(g, n_chips=chips, spus_per_chip=8, **mesh)
        jhw = JS.scale_hw(jg, n_chips=chips, spus_per_chip=8, **mesh)
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)


# -- the portfolio search ------------------------------------------------------

def _portfolio_instance():
    jg = J.random_graph(16, 32, 500, seed=8)
    jhw = J.HardwareConfig(n_spus=8, unified_mem_depth=4096,
                           concentration=3, max_neurons=256,
                           max_post_neurons=128)
    return jg, jhw, port_graph(jg), port_hw(jhw)


def _assert_same_portfolio(got, want):
    (part, trace, tables), (jpart, jtrace, jtables) = got, want
    assert_same_partition(part, jpart)
    assert _trace_rows(trace) == _trace_rows(jtrace)
    assert trace.budget_exhausted == jtrace.budget_exhausted
    assert (tables is None) == (jtables is None)
    if tables is not None:
        for f in ("pre", "post", "weight", "pre_end", "post_end", "assign"):
            _assert_arrays(getattr(tables, f), getattr(jtables, f), f)


@pytest.mark.parametrize("cfg", [
    dict(restarts=2, max_iters=2000, early_exit=False),
    dict(restarts=3, max_iters=2000, extra_strategies=("multilevel",)),
    dict(restarts=1, max_iters=2000, include_baselines=False,
         extra_strategies=()),
], ids=["no-early-exit", "multilevel-extra", "framework-only"])
def test_portfolio_search_equals_reference(cfg):
    jg, jhw, g, hw = _portfolio_instance()
    got = portfolio_search(g, hw, SearchConfig(**cfg))
    _assert_same_portfolio(got, jax_portfolio(jg, jhw, J.SearchConfig(**cfg)))
    assert got[1].selected.ot_depth == got[2].depth


def test_portfolio_search_on_a_tight_instance_equals_reference():
    jg = J.random_graph(12, 24, 800, seed=3)
    jhw = J.HardwareConfig(n_spus=8, unified_mem_depth=14, concentration=3,
                           max_neurons=64, max_post_neurons=32)
    cfg = dict(restarts=4, max_iters=30000)
    got = portfolio_search(port_graph(jg), port_hw(jhw), SearchConfig(**cfg))
    _assert_same_portfolio(got, jax_portfolio(jg, jhw,
                                              J.SearchConfig(**cfg)))
    assert got[1].n_feasible >= 1


def test_portfolio_two_workers_equal_inline_and_reference():
    jg, jhw, g, hw = _portfolio_instance()
    cfg = dict(restarts=2, max_iters=2000, early_exit=False)
    pooled = portfolio_search(g, hw, SearchConfig(**cfg, workers=2))
    inline = portfolio_search(g, hw, SearchConfig(**cfg, workers=1))
    want = jax_portfolio(jg, jhw, J.SearchConfig(**cfg, workers=1))
    _assert_same_portfolio(pooled, inline)
    _assert_same_portfolio(pooled, want)


def test_budget_keeps_a_prefix_of_the_candidate_order():
    jg = J.random_graph(12, 24, 800, seed=3)
    hw = port_hw(J.HardwareConfig(n_spus=8, unified_mem_depth=5,
                                  concentration=3, max_neurons=64,
                                  max_post_neurons=32))   # unsatisfiable
    g = port_graph(jg)
    t0 = time.perf_counter()
    _, _, exhausted = framework_partition(
        g, hw, seed=0, restarts=16, max_iters=10 ** 8, early_exit=False,
        deadline=t0 + 0.15)
    assert exhausted and time.perf_counter() - t0 < 0.65
    _, trace, _ = portfolio_search(g, hw, SearchConfig(
        restarts=2, max_iters=10 ** 8, include_baselines=False,
        budget_seconds=0.2))
    assert trace.budget_exhausted and not trace.n_feasible
    assert trace.seconds < 5.0
    part, trace, _ = portfolio_search(g, hw, SearchConfig(
        restarts=4, max_iters=10 ** 8, budget_seconds=1.0, workers=2))
    order = (list(J.BASELINES) + ["hypergraph"] + ["framework"] * 4)
    names = [c.strategy for c in trace.candidates]
    assert trace.budget_exhausted and part is not None
    assert 1 <= len(names) < len(order) and names == order[:len(names)]
    assert [c.seed for c in trace.candidates
            if c.strategy == "framework"] == \
        list(range(len([n for n in names if n == "framework"])))
