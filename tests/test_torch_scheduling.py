"""The port's compiler back end (``repro_torch.core``) against the
reference's, bit for bit, on the CPU:

* ``schedule`` under all three strategies on the graphs of
  ``tests/test_scheduling.py``: a partitioned recurrent graph, random
  assignments at M in {2, 4, 8}, a feedforward graph on skewed SPUs,
  injected send orders (``schedule_vectorized``) and the empty graph;
  tables, ``send_slot`` (insertion order too), ``send_order`` and
  ``assign`` equal, and the golden artifacts' tables rebuilt from their
  own assignment;
* the same ``AssertionError`` / ``ValueError`` messages on infeasible
  send slots, a partial send order and illegal tables;
* ``random_graph`` at several seeds and keyword sets (the SHD golden's
  graph among them) and ``from_quantized``;
* the memory model (Eqs. 9-11), ``resources``, ``bram_count``, the
  three baselines, ``_spu_stats``, ``build_report`` and
  ``n_initialization_packets`` (also equal to the length of the
  materialized stream);
* the strategy registry's order, replace and unknown-name semantics.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
from repro.core import passes as jax_passes
from repro.core.scheduling import group_info as jax_group_info
from repro.core.scheduling import schedule_vectorized as jax_vectorized
from repro.snn.lif import LIFIntParams as JaxLIF
from repro.snn.quantize import QuantizedSNN as JaxQuantized
from repro_torch.configs import snn_paper
from repro_torch.core import (BASELINES, HardwareConfig, Program,
                              bram_count, build_report, from_quantized,
                              random_graph, resources,
                              scores_from_assignment, spu_score, spu_usage,
                              total_memory_bits, total_memory_kb)
from repro_torch.core import memory_model as MM
from repro_torch.core import passes
from repro_torch.core.graph import SNNGraph
from repro_torch.core.scheduling import (SCHEDULE_STRATEGIES, group_info,
                                         get_schedule_strategy,
                                         register_schedule_strategy,
                                         schedule, schedule_vectorized,
                                         validate_schedule)
from repro_torch.core.scheduling.strategies import SlackStrategy
from repro_torch.snn.lif import LIFIntParams
from repro_torch.snn.quantize import QuantizedSNN

GOLDEN = Path(__file__).parent / "golden"
STRATEGIES = ("slack", "consecutive", "load_balance")
HW_KW = dict(n_spus=8, unified_mem_depth=64, concentration=3,
             max_neurons=256, max_post_neurons=128)


def hw_pair(**kw):
    """The same hardware in both packages."""
    return J.HardwareConfig(**kw), HardwareConfig(**kw)


def jax_graph(g):
    """The reference's graph of the same arrays."""
    return J.SNNGraph(g.n_inputs, g.n_neurons, g.pre, g.post, g.weight,
                      JaxLIF(g.lif.leak_shift, g.lif.v_threshold,
                             g.lif.v_reset), g.output_slice)


def assert_graphs_equal(a, b):
    assert (a.n_inputs, a.n_neurons, a.output_slice) == \
        (b.n_inputs, b.n_neurons, b.output_slice)
    for f in ("pre", "post", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.lif.leak_shift, a.lif.v_threshold, a.lif.v_reset) == \
        (b.lif.leak_shift, b.lif.v_threshold, b.lif.v_reset)


def assert_tables_equal(a, b, order=True):
    """Equal tables; ``order``: ``send_slot``'s insertion order too (a
    loaded artifact derives it from the Post-End flags, in another
    order)."""
    assert a.depth == b.depth
    for f in ("pre", "post", "weight", "pre_end", "post_end", "assign"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.send_slot == b.send_slot
    assert not order or list(a.send_slot) == list(b.send_slot)
    assert a.send_order == b.send_order


def assert_schedules_equal(g, assign, kw, methods=STRATEGIES):
    jhw, hw = hw_pair(**kw)
    jg = jax_graph(g)
    for method in methods:
        want = J.schedule(jg, assign, jhw, method=method)
        got = schedule(g, assign, hw, method=method)
        assert_tables_equal(got, want)
        validate_schedule(g, got)


# -- schedule: the graphs of tests/test_scheduling.py -------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedule_recurrent_partitioned(seed):
    g = random_graph(20, 40, 700, seed=seed)
    jhw, _ = hw_pair(**HW_KW)
    res = J.partition(jax_graph(g), jhw, seed=0, max_iters=20000)
    assert_schedules_equal(g, res.assign, HW_KW)


@pytest.mark.parametrize("seed", [0, 7])
def test_schedule_random_assignments(seed):
    g = random_graph(16, 32, 600, seed=2)
    rng = np.random.default_rng(seed)
    for m in (2, 4, 8):
        kw = dict(n_spus=m, unified_mem_depth=4096, concentration=3,
                  max_neurons=64, max_post_neurons=32)
        assign = rng.integers(0, m, g.n_synapses).astype(np.int32)
        assert_schedules_equal(g, assign, kw)


def test_schedule_feedforward_and_skewed():
    g = random_graph(24, 16, 380, seed=4)
    ff = g.pre < g.n_inputs
    ffg = SNNGraph(g.n_inputs, g.n_neurons, g.pre[ff], g.post[ff],
                   g.weight[ff], g.lif, g.output_slice)
    kw = dict(n_spus=8, unified_mem_depth=4096, concentration=3,
              max_neurons=64, max_post_neurons=32)
    for graph in (g, ffg):
        rng = np.random.default_rng(0)
        assign = rng.choice([0, 5], graph.n_synapses,
                            p=[0.9, 0.1]).astype(np.int32)
        assert_schedules_equal(graph, assign, kw)


def test_schedule_injected_send_orders():
    g = random_graph(12, 24, 400, seed=5)
    jhw, hw = hw_pair(**HW_KW)
    rng = np.random.default_rng(1)
    assign = rng.integers(0, hw.n_spus, g.n_synapses).astype(np.int32)
    gi = group_info(g, assign)
    jgi = jax_group_info(jax_graph(g), assign)
    for f in ("order", "key_start", "key_count", "spu_of_key",
              "post_of_key", "posts", "cmax", "total"):
        np.testing.assert_array_equal(getattr(gi, f), getattr(jgi, f))
    for _ in range(4):
        order = rng.permutation(gi.posts)
        want = jax_vectorized(jax_graph(g), assign, jhw, send_order=order)
        got = schedule_vectorized(g, assign, hw, send_order=order)
        assert_tables_equal(got, want)
        validate_schedule(g, got)
    slots = {int(q): 3 * i + 40 for i, q in enumerate(gi.posts)}
    assert_tables_equal(
        schedule_vectorized(g, assign, hw, send_slots=slots),
        jax_vectorized(jax_graph(g), assign, jhw, send_slots=slots))


def test_schedule_empty_graph():
    g = random_graph(4, 4, 5, seed=0)
    empty = SNNGraph(g.n_inputs, g.n_neurons, g.pre[:0], g.post[:0],
                     g.weight[:0], g.lif, g.output_slice)
    assign = np.zeros(0, np.int32)
    assert_schedules_equal(empty, assign, HW_KW)
    assert schedule(empty, assign, HardwareConfig(**HW_KW)).depth == 0


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_golden_tables_rebuilt_from_their_assignment(name):
    p = Program.load(GOLDEN / f"{name}_program_v1.npz")
    assert p.report.schedule_method == "slack"
    got = schedule(p.graph, p.tables.assign, p.hw)
    assert_tables_equal(got, p.tables, order=False)
    lowered = passes.lower_pass(p.graph, got)
    for f in dataclasses.fields(lowered):
        a, b = getattr(lowered, f.name), getattr(p.lowered, f.name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype, f.name


# -- the same error messages ---------------------------------------------------

def _message(fn, *args, exc=AssertionError, **kw) -> str:
    with pytest.raises(exc) as info:
        fn(*args, **kw)
    return str(info.value)


def test_infeasible_send_slots_raise_the_reference_message():
    g = random_graph(10, 20, 150, seed=5)
    kw = dict(n_spus=4, unified_mem_depth=512, concentration=3,
              max_neurons=64, max_post_neurons=32)
    jhw, hw = hw_pair(**kw)
    assign = np.random.default_rng(0).integers(
        0, 4, g.n_synapses).astype(np.int32)
    slots = {int(q): i for i, q in enumerate(group_info(g, assign).posts)}
    got = _message(schedule_vectorized, g, assign, hw, send_slots=slots)
    want = _message(jax_vectorized, jax_graph(g), assign, jhw,
                    send_slots=slots)
    assert got == want and got.startswith("schedule infeasible")
    partial = group_info(g, assign).posts[:-1]
    assert _message(schedule_vectorized, g, assign, hw, send_order=partial,
                    exc=ValueError) == \
        _message(jax_vectorized, jax_graph(g), assign, jhw,
                 send_order=partial, exc=ValueError)


def _valid_tables(pkg):
    g = random_graph(16, 32, 400, seed=9)
    kw = dict(n_spus=8, unified_mem_depth=4096, concentration=3,
              max_neurons=256, max_post_neurons=128)
    if pkg == "jax":
        g, hw = jax_graph(g), J.HardwareConfig(**kw)
        return g, J.schedule(g, J.BASELINES["synapse_rr"](g, hw).assign, hw)
    hw = HardwareConfig(**kw)
    return g, schedule(g, BASELINES["synapse_rr"](g, hw).assign, hw)


def _drop_send_slot(t):
    del t.send_slot[t.send_order[0]]


def _shift_send_slot(t):
    t.send_slot[t.send_order[0]] += 1


def _late_op(t):
    for pq in t.send_order:
        for spu in range(t.n_spus):
            ops = np.flatnonzero((t.post[spu] == pq) & ~t.post_end[spu])
            free = np.flatnonzero(t.pre[spu] == -1)
            free = free[free > t.send_slot[pq]]
            if len(ops) and len(free):
                a, b = int(ops[0]), int(free[0])
                for arr in (t.pre, t.post, t.weight):
                    arr[spu, b] = arr[spu, a]
                    arr[spu, a] = -1 if arr is not t.weight else 0
                t.pre_end[spu, b] = t.pre_end[spu, a]
                t.pre_end[spu, a] = False
                return
    raise AssertionError("instance left no room to build the violation")


def _drop_op(t):
    s, slot = map(int, np.argwhere(t.pre != -1)[0])
    t.pre[s, slot] = t.post[s, slot] = -1
    t.weight[s, slot] = 0
    t.pre_end[s, slot] = t.post_end[s, slot] = False


def _collide(t):
    p1, p2 = sorted(t.send_slot)[:2]
    t.send_slot[p2] = t.send_slot[p1]


@pytest.mark.parametrize("mutate", [_drop_send_slot, _shift_send_slot,
                                    _late_op, _drop_op, _collide],
                         ids=lambda f: f.__name__.strip("_"))
def test_illegal_tables_raise_the_reference_message(mutate):
    (jg, jt), (g, t) = _valid_tables("jax"), _valid_tables("port")
    assert_tables_equal(t, jt)
    mutate(jt)
    mutate(t)
    want = _message(J.validate_schedule, jg, jt)
    assert _message(validate_schedule, g, t) == want
    assert _message(passes.validate_pass, g, t) == want


# -- graphs --------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((700, 320, 33000), dict(seed=0, weight_lo=-255, weight_hi=255)),
    ((10, 12, 120), dict(seed=3)),
    ((8, 10, 90), dict(seed=11)),
    ((4, 4, 500), dict(seed=2, weight_lo=0, weight_hi=1)),
    ((6, 8, 40), dict(seed=7, lif=(0, 9, -2))),
    ((784, 126, 12000), dict(seed=1)),
])
def test_random_graph_equals_the_reference(args, kw):
    jkw = dict(kw)
    if "lif" in kw:
        jkw["lif"] = JaxLIF(*kw["lif"])
        kw = dict(kw, lif=LIFIntParams(*kw["lif"]))
    assert_graphs_equal(random_graph(*args, **kw),
                        J.random_graph(*args, **jkw))


def test_shd_golden_graph_and_hw_from_the_port_alone():
    p = Program.load(GOLDEN / "shd_program_v1.npz")
    g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
    assert_graphs_equal(g, p.graph)
    assert dataclasses.replace(snn_paper.SHD_HW, weight_bits=9,
                               potential_bits=18) == p.hw


def test_snn_paper_configs_equal_the_reference():
    from repro.configs import snn_paper as jax_paper
    for name in ("MNIST_HW", "SHD_HW"):
        assert dataclasses.asdict(getattr(snn_paper, name)) == \
            dataclasses.asdict(getattr(jax_paper, name))
    g, hw = snn_paper.mnist_scale_random_graph(3000, seed=4)
    jg, jhw = jax_paper.mnist_scale_random_graph(3000, seed=4)
    assert_graphs_equal(g, jg)
    assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)


@pytest.mark.parametrize("recurrent", [False, True])
def test_from_quantized_equals_the_reference(recurrent):
    rng = np.random.default_rng(4)
    sizes = (6, 5, 3)
    ws = [(rng.integers(-3, 4, (a, b)) * (rng.random((a, b)) < 0.6)
           ).astype(np.int32) for a, b in zip(sizes, sizes[1:])]
    rec = [(rng.integers(-2, 3, (5, 5)) * (rng.random((5, 5)) < 0.5)
            ).astype(np.int32) if recurrent else None, None]
    lif = (1, 7, 0)
    got = from_quantized(QuantizedSNN(sizes, ws, rec, 0.1,
                                      LIFIntParams(*lif), recurrent))
    want = J.from_quantized(JaxQuantized(sizes, ws, rec, 0.1, JaxLIF(*lif),
                                         recurrent))
    assert_graphs_equal(got, want)


# -- memory model, resources, baselines, report ---------------------------------

HW_POINTS = [
    dict(n_spus=16, unified_mem_depth=128, concentration=3, weight_bits=4,
         potential_bits=5, max_neurons=910, max_post_neurons=126),
    dict(n_spus=64, unified_mem_depth=256, concentration=3, weight_bits=9,
         potential_bits=18, max_neurons=1020, max_post_neurons=320),
    dict(n_spus=16, unified_mem_depth=120, concentration=3, weight_bits=9,
         potential_bits=18, max_neurons=1020, max_post_neurons=320),
    dict(n_spus=32, unified_mem_depth=64, concentration=2, weight_bits=4,
         potential_bits=5, max_neurons=600, max_post_neurons=64, n_chips=4),
    dict(n_spus=64, unified_mem_depth=256, concentration=3, weight_bits=9,
         potential_bits=18, max_neurons=1020, max_post_neurons=320,
         n_chips=8, mesh_x=8, mesh_y=1),
]


@pytest.mark.parametrize("kw", HW_POINTS, ids=range(len(HW_POINTS)))
def test_memory_model_and_resources_equal_the_reference(kw):
    jhw, hw = hw_pair(**kw)
    assert (hw.spus_per_chip, hw.mesh_dims, hw.tree_depth) == \
        (jhw.spus_per_chip, jhw.mesh_dims, jhw.tree_depth)
    chips = np.arange(hw.n_chips)
    np.testing.assert_array_equal(hw.chip_of(np.arange(hw.n_spus)),
                                  jhw.chip_of(np.arange(hw.n_spus)))
    for a, b in zip(hw.chip_coords(chips), jhw.chip_coords(chips)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hw.chip_hops(chips[:, None], chips),
                                  jhw.chip_hops(chips[:, None], chips))
    for depth in (0, 1, 661, 1251, 5000):
        assert total_memory_bits(hw, depth) == \
            J.total_memory_bits(jhw, depth)
        assert total_memory_kb(hw, depth) == J.total_memory_kb(jhw, depth)
        assert bram_count(hw, depth) == J.bram_count(jhw, depth)
        assert bram_count(hw, depth, 36) == J.bram_count(jhw, depth, 36)
        assert dataclasses.asdict(resources(hw, depth)) == \
            dataclasses.asdict(J.resources(jhw, depth))
    for q, p in ((0, 0), (5, 3), (40, 100)):
        assert spu_usage(q, p, hw.concentration) == \
            J.spu_usage(q, p, jhw.concentration)
        assert spu_score(q, p, hw) == J.spu_score(q, p, jhw)


def test_table2_memory_point():
    # tests/test_scheduling.py's hand count at the paper's MNIST point
    mnist = HardwareConfig(**HW_POINTS[0])
    assert total_memory_bits(mnist, 661) == \
        910 * 16 + 16 * (661 * 28 + 1536 + 910) + 126 * 16


@pytest.mark.parametrize("seed", [0, 5])
def test_scores_usage_and_baselines_equal_the_reference(seed):
    g = random_graph(16, 32, 600, seed=seed)
    jg = jax_graph(g)
    kw = dict(n_spus=8, unified_mem_depth=40, concentration=3,
              max_neurons=64, max_post_neurons=32)
    jhw, hw = hw_pair(**kw)
    assign = np.random.default_rng(seed).integers(
        0, 8, g.n_synapses).astype(np.int32)
    for fn in ("scores_from_assignment", "usage_from_assignment"):
        got = getattr(MM, fn)(g.weight, g.post, assign, hw)
        want = getattr(J.memory_model, fn)(g.weight, g.post, assign, jhw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    empty = np.zeros(0, np.int32)
    np.testing.assert_array_equal(
        scores_from_assignment(empty, empty, empty, hw),
        J.scores_from_assignment(empty, empty, empty, jhw))
    assert set(BASELINES) == set(J.BASELINES)
    for name, fn in BASELINES.items():
        got, want = fn(g, hw), J.BASELINES[name](jg, jhw)
        assert got.assign.dtype == want.assign.dtype
        np.testing.assert_array_equal(got.assign, want.assign)
        np.testing.assert_array_equal(got.scores, want.scores)
        assert (got.feasible, got.iterations, got.perturbations,
                got.score_history) == (want.feasible, want.iterations,
                                       want.perturbations,
                                       want.score_history)
        for a, b in zip(passes._spu_stats(g, got.assign, hw.n_spus),
                        jax_passes._spu_stats(jg, want.assign, jhw.n_spus)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_build_report_and_init_packets_equal_the_golden(name):
    """The report rebuilt from the golden's own partition, search and
    schedule depths equals the golden's header field by field (the
    wall time is passed through); the init-packet count equals the
    reference's closed form and the materialized stream's length."""
    path = GOLDEN / f"{name}_program_v1.npz"
    p, jp = Program.load(path), J.Program.load(path)
    rep = build_report(p.graph, p.hw, p.tables, p.part,
                       method=p.report.method,
                       compile_seconds=p.report.compile_seconds,
                       routing=p.lowered.routing, search=p.report.search,
                       schedule_method=p.report.schedule_method,
                       schedule_depths=p.report.schedule_depths)
    want = jax_passes.build_report(
        jp.graph, jp.hw, jp.tables, jp.part, method=jp.report.method,
        compile_seconds=jp.report.compile_seconds, search=jp.report.search,
        schedule_method=jp.report.schedule_method,
        schedule_depths=jp.report.schedule_depths)
    for have in (want, jp.report, p.report):
        for f in dataclasses.fields(rep):
            a, b = getattr(rep, f.name), getattr(have, f.name)
            if f.name in ("phase_seconds", "phase_alloc_mb"):
                continue                 # wall times of the original run
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            elif f.name == "resources":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
    n = passes.n_initialization_packets(p.graph, p.tables)
    assert n == jax_passes.n_initialization_packets(jp.graph, jp.tables)
    assert n == len(p.init_packets()) == p.report.n_init_packets


def test_back_end_passes_compose_to_the_golden():
    p = Program.load(GOLDEN / "tiny_program_v1.npz")
    tables = passes.schedule_pass(p.graph, p.part, p.hw)
    assert_tables_equal(tables, p.tables, order=False)
    assert_tables_equal(passes.schedule_pass(p.graph, p.tables.assign, p.hw),
                        tables)
    passes.validate_pass(p.graph, tables)


# -- the strategy registry -------------------------------------------------------

def test_registry_holds_the_builtins_slack_first():
    assert list(SCHEDULE_STRATEGIES)[:3] == list(STRATEGIES)
    assert list(SCHEDULE_STRATEGIES)[:3] == list(J.SCHEDULE_STRATEGIES)[:3]
    assert SCHEDULE_STRATEGIES is not J.SCHEDULE_STRATEGIES
    for name in STRATEGIES:
        assert get_schedule_strategy(name).name == name


def test_registry_rejects_unknown_names():
    got = _message(get_schedule_strategy, "nope", exc=ValueError)
    assert got == _message(J.get_schedule_strategy, "nope", exc=ValueError)
    assert got.startswith("unknown schedule_method 'nope'")
    g = random_graph(8, 8, 40, seed=0)
    with pytest.raises(ValueError, match="unknown schedule_method"):
        schedule(g, np.zeros(g.n_synapses, np.int32),
                 HardwareConfig(**HW_KW), method="nope")


def test_register_schedule_strategy_replace_semantics():
    with pytest.raises(ValueError, match="already registered"):
        register_schedule_strategy(SlackStrategy())
    custom = SlackStrategy(name="test_custom_order")
    try:
        assert register_schedule_strategy(custom) is custom
        assert get_schedule_strategy("test_custom_order") is custom
        with pytest.raises(ValueError, match="replace=True"):
            register_schedule_strategy(custom)
        other = SlackStrategy(name="test_custom_order")
        register_schedule_strategy(other, replace=True)
        assert get_schedule_strategy("test_custom_order") is other
    finally:
        SCHEDULE_STRATEGIES.pop("test_custom_order", None)
    assert "test_custom_order" not in J.SCHEDULE_STRATEGIES


def test_custom_strategy_reaches_schedule():
    class ReverseStrategy:
        name = "test_reverse"

        def send_order(self, info):
            return info.posts[::-1].copy()

    g = random_graph(12, 16, 200, seed=7)
    assign = np.random.default_rng(2).integers(
        0, 8, g.n_synapses).astype(np.int32)
    try:
        register_schedule_strategy(ReverseStrategy())
        J.register_schedule_strategy(ReverseStrategy())
        assert_schedules_equal(g, assign, HW_KW, methods=("test_reverse",))
        t = schedule(g, assign, HardwareConfig(**HW_KW),
                     method="test_reverse")
        assert t.send_order == sorted(t.send_order, reverse=True)
    finally:
        SCHEDULE_STRATEGIES.pop("test_reverse", None)
        J.SCHEDULE_STRATEGIES.pop("test_reverse", None)
