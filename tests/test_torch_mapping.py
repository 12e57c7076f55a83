"""The port's mapping search (``repro_torch.core.mapping``) against the
reference's, bit for bit, on the CPU:

* the partitioning-tree geometry: ``walk`` on batched draws,
  ``leaf_paths`` and ``lca_depths``;
* ``Books``: every occupancy plane, the presence counters and the
  Eq. (10) scores after one sequence of ``move_group`` / ``move_one`` /
  ``rebuild`` calls;
* ``framework_partition`` and ``partition`` (assignment, scores,
  iterations, perturbations, ``score_history``) in the modes of
  ``tests/test_mapping.py``: recurrent and feed-forward seeds, the
  sampled scan with perturbations, the nudge move mode, an infeasible
  budget exhaustion and a lockstep restart population; the preserved
  ``partition_legacy`` loop equals both;
* every registered strategy's ``PartitionResult``, in the registry's
  order;
* the registry's errors, with the reference's messages.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as J
from repro.core import mapping as JM
from repro.core.graph import SNNGraph as JaxGraph
from repro.snn.lif import LIFIntParams as JaxLIF
from repro_torch.core import (BASELINES, STRATEGIES, compile, get_strategy,
                              partition, register_strategy)
from repro_torch.core import mapping as M
from repro_torch.core.mapping.strategies import BaselineStrategy
from torch_parity import assert_same_partition, port_graph, port_hw


def feedforward_graph(seed=1, n_in=24, n_out=16, n_syn=300):
    """``tests/test_mapping.py``'s pure feed-forward graph."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(n_in * n_out, size=n_syn, replace=False)
    pre = (flat // n_out).astype(np.int32)
    post = (flat % n_out + n_in).astype(np.int32)
    w = rng.integers(1, 8, n_syn).astype(np.int32) * \
        rng.choice([-1, 1], n_syn).astype(np.int32)
    return JaxGraph(n_in, n_in + n_out, pre, post, w,
                    JaxLIF(leak_shift=2, v_threshold=15, v_reset=0),
                    output_slice=(n_in, n_in + n_out))


def hw_pair(**kw):
    hw = J.HardwareConfig(**kw)
    return hw, port_hw(hw)


HW8 = dict(n_spus=8, unified_mem_depth=24, concentration=3,
           max_neurons=256, max_post_neurons=128)
TIGHT = dict(n_spus=8, unified_mem_depth=11, concentration=3,
             max_neurons=64, max_post_neurons=32)
FF = dict(n_spus=4, unified_mem_depth=16, concentration=3, max_neurons=64,
          max_post_neurons=32)

# (graph, hw, keyword) cases of tests/test_mapping.py:53-136
MODES = {
    "recurrent-s0": (lambda: J.random_graph(16, 32, 900, seed=2), HW8,
                     dict(seed=0, max_iters=20000)),
    "recurrent-s3": (lambda: J.random_graph(16, 32, 900, seed=2), HW8,
                     dict(seed=3, max_iters=20000)),
    "recurrent-s11": (lambda: J.random_graph(16, 32, 900, seed=2), HW8,
                      dict(seed=11, max_iters=20000)),
    "feedforward-s0": (feedforward_graph, FF, dict(seed=0, max_iters=20000)),
    "feedforward-s7": (feedforward_graph, FF, dict(seed=7, max_iters=20000)),
    "sampled-perturbed": (lambda: J.random_graph(12, 24, 800, seed=3), TIGHT,
                          dict(seed=0, max_iters=60000, scan_cap=24,
                               stagnation_window=120)),
    "nudge": (lambda: J.random_graph(16, 32, 600, seed=2),
              dict(HW8, unified_mem_depth=30),
              dict(seed=0, move_mode="nudge", max_iters=8000)),
    "infeasible-budget": (lambda: J.random_graph(12, 24, 800, seed=3), TIGHT,
                          dict(seed=0, max_iters=300)),
}


# -- the tree geometry ---------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3, 6])
def test_tree_geometry_equals_reference(depth):
    rng = np.random.default_rng(depth)
    m = 1 << depth
    p = rng.random((3, m - 1, 257))
    r = rng.random((3, m - 1, 257))
    got, want = M.walk(p, r, depth), JM.walk(p, r, depth)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(M.walk(p[1], r[1], depth), got[1])
    for a, b in zip(M.leaf_paths(depth), JM.leaf_paths(depth)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a, b = M.lca_depths(depth), JM.lca_depths(depth)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# -- the occupancy books -------------------------------------------------------

def test_books_planes_equal_after_moves():
    jg = J.random_graph(16, 32, 700, seed=4)
    jhw, hw = hw_pair(**dict(HW8, unified_mem_depth=26))
    g = port_graph(jg)
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 8, (2, jg.n_synapses)).astype(np.int32)
    books, jbooks = M.Books(g, hw, assign.copy()), JM.Books(jg, jhw,
                                                           assign.copy())
    live = assign.copy()
    for step in range(40):
        rr = step % 2
        if step % 3 == 0:                   # one whole fan-in group
            q = int(rng.choice(jg.post))
            src = int(rng.integers(0, 8))
            syns = np.flatnonzero((jg.post == q) & (live[rr] == src))
            dst = int((src + 1 + rng.integers(0, 7)) % 8)
            books.move_group(rr, syns, src, dst)
            jbooks.move_group(rr, syns, src, dst)
            live[rr, syns] = dst
        else:
            syn = int(rng.integers(0, jg.n_synapses))
            src = int(live[rr, syn])
            dst = int((src + 1 + rng.integers(0, 7)) % 8)
            books.move_one(rr, syn, src, dst)
            jbooks.move_one(rr, syn, src, dst)
            live[rr, syn] = dst
        if step == 20:
            books.rebuild(1, live[1])
            jbooks.rebuild(1, live[1])
    for f in ("cnt_post", "cnt_w", "n_posts", "n_weights", "np_post",
              "np_w", "w_vals", "w_id", "post"):
        a, b = getattr(books, f), getattr(jbooks, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(books.scores(), jbooks.scores())
    for rr in (0, 1):
        np.testing.assert_array_equal(books.scores_r(rr),
                                      jbooks.scores_r(rr))
        assert books.total_usage_r(rr) == jbooks.total_usage_r(rr)
    # the moved books are the ground truth of the moved assignment
    fresh = M.Books(g, hw, live)
    np.testing.assert_array_equal(fresh.cnt_post, books.cnt_post)
    np.testing.assert_array_equal(fresh.n_weights, books.n_weights)


# -- the framework search ------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_framework_partition_equals_reference(mode):
    make, hw_kw, kw = MODES[mode]
    jg = make()
    jhw, hw = hw_pair(**hw_kw)
    want = J.partition(jg, jhw, **kw)
    got = partition(port_graph(jg), hw, **kw)
    assert_same_partition(got, want)
    assert got.assign.flags.c_contiguous
    if mode == "sampled-perturbed":
        assert got.perturbations > 0
    if mode == "infeasible-budget":
        assert not got.feasible


@pytest.mark.parametrize("mode", ["feedforward-s7", "infeasible-budget"])
def test_legacy_loop_equals_reference_and_the_vectorized_core(mode):
    make, hw_kw, kw = MODES[mode]
    jg = make()
    jhw, hw = hw_pair(**hw_kw)
    got = M.partition_legacy(port_graph(jg), hw, **kw)
    assert_same_partition(got, JM.partition_legacy(jg, jhw, **kw))
    assert_same_partition(got, partition(port_graph(jg), hw, **kw))


@pytest.mark.parametrize("early_exit", [False, True])
def test_restart_population_equals_reference(early_exit):
    jg = J.random_graph(12, 24, 700, seed=5)
    jhw, hw = hw_pair(**dict(TIGHT, unified_mem_depth=13))
    kw = dict(seed=10, restarts=3, max_iters=4000, early_exit=early_exit)
    win, results, exhausted = M.framework_partition(port_graph(jg), hw, **kw)
    jwin, jresults, jexhausted = JM.framework_partition(jg, jhw, **kw)
    assert exhausted == jexhausted
    assert len(results) == len(jresults)
    for a, b in zip(results, jresults):
        assert_same_partition(a, b)
    assert_same_partition(win, jwin)


# -- the strategy registry -----------------------------------------------------

def test_registry_order_equals_reference():
    assert list(STRATEGIES) == list(J.STRATEGIES)
    assert list(BASELINES) == list(J.BASELINES)


@pytest.mark.parametrize("name", list(J.STRATEGIES))
def test_every_strategy_equals_reference(name):
    jg = J.random_graph(16, 32, 900, seed=2)
    jhw, hw = hw_pair(**dict(HW8, unified_mem_depth=40))
    kw = dict(seed=1, max_iters=3000, restarts=2, workers=1)
    got = get_strategy(name).partition(port_graph(jg), hw, **kw)
    want = J.get_strategy(name).partition(jg, jhw, **kw)
    assert_same_partition(got, want)
    assert get_strategy(name).name == name


def test_registry_errors_keep_the_reference_messages():
    with pytest.raises(ValueError) as got:
        get_strategy("does_not_exist")
    with pytest.raises(ValueError) as want:
        J.get_strategy("does_not_exist")
    assert str(got.value) == str(want.value)
    jg = J.random_graph(8, 8, 40, seed=0)
    jhw, hw = hw_pair(**HW8)
    with pytest.raises(ValueError) as got:
        compile(port_graph(jg), hw, method="does_not_exist")
    with pytest.raises(ValueError) as want:
        J.compile(jg, jhw, method="does_not_exist")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        register_strategy(BaselineStrategy("synapse_rr",
                                           BASELINES["synapse_rr"]))
    with pytest.raises(ValueError) as want:
        J.register_strategy(JM.BaselineStrategy("synapse_rr",
                                                J.BASELINES["synapse_rr"]))
    assert str(got.value) == str(want.value)


def test_register_strategy_replace_semantics():
    custom = BaselineStrategy("test_custom_rr", BASELINES["synapse_rr"])
    try:
        register_strategy(custom)
        assert get_strategy("test_custom_rr") is custom
        replacement = BaselineStrategy("test_custom_rr",
                                       BASELINES["weight_rr"])
        register_strategy(replacement, replace=True)
        assert get_strategy("test_custom_rr") is replacement
    finally:
        STRATEGIES.pop("test_custom_rr", None)
    assert "test_custom_rr" not in STRATEGIES
    assert isinstance(STRATEGIES["framework"], M.FrameworkStrategy)
    assert isinstance(STRATEGIES["hypergraph"], M.MappingStrategy)
