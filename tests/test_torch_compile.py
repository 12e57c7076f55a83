"""The port's ``compile`` (``repro_torch.core.program.compile``) against
the reference's, on the CPU: the saved artifact's arrays equal in dtype,
shape and bytes, and its header equal but for the wall times
(``compile_seconds``, ``phase_seconds``, ``phase_alloc_mb`` and the
search trace's ``seconds``):

* every mapping strategy (``framework``, ``hypergraph``,
  ``multilevel``, the three baselines) under every schedule strategy
  (``slack``, ``consecutive``, ``load_balance``);
* ``search=SearchConfig()``, ``n_chips=4`` and a quantized network (the
  same numpy weights through each package's ``quantize``);
* the SHD golden (``tests/golden/make_shd_program.py``'s graph and
  hardware) rebuilt from scratch equals ``shd_program_v1.npz``, with its
  ``content_hash``;
* the phase profiler's keys, the argument errors and the engine names
  (``"jax"`` is the port's ``"torch"``);
* the deprecated wrappers ``compile_snn`` and ``compile_quantized`` warn
  and return the same parts, and the preserved scheduling loop
  ``schedule_legacy`` equals the reference's and the vectorized core.
"""
from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
import repro.snn as ref_snn
from conftest import make_hw
from repro.core.mapping.multilevel import \
    multilevel_partition as jax_multilevel
from repro.core.profiling import profiled as jax_profiled
from repro.core.scheduling import schedule_legacy as jax_schedule_legacy
from repro_torch.configs.snn_paper import SHD_HW
from repro_torch.core import (HardwareConfig, Program, SearchConfig, compile,
                              compile_quantized, compile_snn, random_graph)
from repro_torch.core.mapping.multilevel import multilevel_partition
from repro_torch.core.profiling import (TOP_LEVEL_PHASES, PhaseProfiler,
                                        current_profiler, phase, profiled)
from repro_torch.core.scheduling import schedule, schedule_legacy
from repro_torch.snn import QuantConfig, SNNConfig, quantize
from repro_torch.snn.models import params_from_numpy
from torch_parity import (assert_same_artifact, assert_same_partition,
                          assert_same_saved, port_graph, port_hw,
                          read_artifact)

GOLDEN = Path(__file__).parent / "golden"
# the SHD golden's content hash, as chip_smoke.py pins it
SHD_HASH = "2b2916b301a3678ffa1bf4427c59838bde159f778e00f7ab9df3106cff54ee01"
METHODS = ("framework", "hypergraph", "multilevel", "post_neuron_rr",
           "synapse_rr", "weight_rr")
SCHEDULES = ("slack", "consecutive", "load_balance")


def _instance():
    """``tests/test_mapping.py``'s recurrent graph on 8 SPUs of 24 lines:
    the framework search has to work, a baseline may not fit."""
    jg = J.random_graph(16, 32, 900, seed=2)
    jhw = J.HardwareConfig(n_spus=8, unified_mem_depth=24, concentration=3,
                           max_neurons=256, max_post_neurons=128)
    return jg, jhw, port_graph(jg), port_hw(jhw)


@pytest.mark.parametrize("schedule_method", SCHEDULES)
@pytest.mark.parametrize("method", METHODS)
def test_compile_matrix_saves_the_reference_artifact(tmp_path, method,
                                                     schedule_method):
    jg, jhw, g, hw = _instance()
    kw = dict(method=method, schedule_method=schedule_method,
              max_iters=3000)
    got = compile(g, hw, **kw)
    assert got.default_engine == "torch"
    assert_same_artifact(got, J.compile(jg, jhw, **kw), tmp_path)


def test_portfolio_compile_saves_the_reference_artifact(tmp_path):
    jg = J.random_graph(12, 24, 800, seed=3)
    jhw = J.HardwareConfig(n_spus=8, unified_mem_depth=14, concentration=3,
                           max_neurons=64, max_post_neurons=32)
    got = compile(port_graph(jg), port_hw(jhw), search=SearchConfig())
    want = J.compile(jg, jhw, search=J.SearchConfig())
    assert got.report.method == "portfolio" and got.feasible
    assert got.report.candidates_tried == len(got.report.search.candidates)
    assert got.report.schedule_method == \
        got.report.search.selected.schedule_method
    assert_same_artifact(got, want, tmp_path)
    back = Program.load(got.save(tmp_path / "portfolio"))
    assert back.report.search.to_json() == got.report.search.to_json()


@pytest.mark.parametrize("method", ["framework", "hypergraph", "multilevel"])
def test_four_chip_compile_saves_the_reference_artifact(tmp_path, method):
    jg = J.random_graph(24, 48, 3000, seed=7)
    jhw = make_hw(jg, m=4, k=3)
    got = compile(port_graph(jg), port_hw(jhw), method=method, n_chips=4,
                  max_iters=3000)
    want = J.compile(jg, jhw, method=method, n_chips=4, max_iters=3000)
    assert got.hw.n_chips == 4 and got.hw.n_spus == 16
    assert_same_artifact(got, want, tmp_path)
    jhw2 = dataclasses.replace(jhw, n_chips=2)
    with pytest.raises(ValueError) as err:
        compile(port_graph(jg), port_hw(jhw2), n_chips=2)
    with pytest.raises(ValueError) as jerr:
        J.compile(jg, jhw2, n_chips=2)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("recurrent", [False, True])
def test_quantized_network_compiles_to_the_reference_artifact(tmp_path,
                                                              recurrent):
    sizes = (20, 12, 6)
    rng = np.random.default_rng(5)
    np_params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        np_params[f"w{i}"] = rng.normal(0, 1 / np.sqrt(a), (a, b)) \
            .astype(np.float32)
        np_params[f"mask{i}"] = (rng.random((a, b)) > 0.5) \
            .astype(np.float32)
        if recurrent and i < len(sizes) - 2:
            np_params[f"wr{i}"] = rng.normal(0, 1 / np.sqrt(b), (b, b)) \
                .astype(np.float32)
            np_params[f"maskr{i}"] = (rng.random((b, b)) > 0.5) \
                .astype(np.float32)
    cfg = SNNConfig(layer_sizes=sizes, recurrent=recurrent)
    jcfg = ref_snn.SNNConfig(layer_sizes=sizes, recurrent=recurrent)
    q = quantize(params_from_numpy(np_params, cfg, "cpu"), cfg,
                 QuantConfig(4, 12))
    jq = ref_snn.quantize(np_params, jcfg, ref_snn.QuantConfig(4, 12))
    n = sum(sizes)
    kw = dict(n_spus=4, unified_mem_depth=128, concentration=3,
              max_neurons=n, max_post_neurons=n - sizes[0])
    got = compile(q, HardwareConfig(**kw), max_iters=3000)
    want = J.compile(jq, J.HardwareConfig(**kw), max_iters=3000)
    assert got.graph.n_synapses == q.n_nonzero_synapses
    assert_same_artifact(got, want, tmp_path)


def test_shd_golden_rebuilt_from_its_graph(tmp_path):
    g = random_graph(700, 320, 33000, seed=0, weight_lo=-255, weight_hi=255)
    hw = dataclasses.replace(SHD_HW, weight_bits=9, potential_bits=18)
    prog = compile(g, hw, max_iters=20000)
    assert prog.feasible and prog.content_hash() == SHD_HASH
    path = prog.save(tmp_path / "shd")
    assert_same_saved(path, GOLDEN / "shd_program_v1.npz")
    assert Program.load(path).content_hash() == SHD_HASH


# -- the phase profiler --------------------------------------------------------

def test_phase_keys_equal_the_reference():
    jg, jhw, g, hw = _instance()
    got = compile(g, hw, max_iters=3000).report.phase_seconds
    want = J.compile(jg, jhw, max_iters=3000).report.phase_seconds
    assert list(got) == list(want) == list(TOP_LEVEL_PHASES)
    assert compile(g, hw, max_iters=3000,
                   profile_phases=False).report.phase_seconds is None
    with profiled(PhaseProfiler(alloc=True)) as prof:
        prog = compile(g, hw, max_iters=3000)
        assert current_profiler() is prof
    assert current_profiler() is None
    assert set(prog.report.phase_alloc_mb) == set(TOP_LEVEL_PHASES)
    assert prog.report.phase_seconds == prof.seconds
    assert phase("anything").__enter__() is None        # no profiler: no-op


def test_multilevel_subphase_keys_equal_the_reference():
    jg = J.random_graph(24, 48, 3000, seed=7)
    jhw = dataclasses.replace(make_hw(jg, m=8, k=3), n_chips=2)
    with profiled() as prof:
        got = multilevel_partition(port_graph(jg), port_hw(jhw),
                                   coarse_target=500)
    with jax_profiled() as jprof:
        want = jax_multilevel(jg, jhw, coarse_target=500)
    assert_same_partition(got, want)
    assert list(prof.seconds) == list(jprof.seconds)
    assert {"coarsen", "coarse_search", "project", "refine",
            "place"} <= set(prof.seconds)


# -- arguments and engines -----------------------------------------------------

def test_argument_errors_keep_the_reference_messages():
    jg, jhw, g, hw = _instance()
    for kw in (dict(seed=7), dict(max_iters=50), dict(workers=2),
               dict(schedule_method="consecutive")):
        with pytest.raises(ValueError) as err:
            compile(g, hw, search=SearchConfig(restarts=2), **kw)
        with pytest.raises(ValueError) as jerr:
            J.compile(jg, jhw, search=J.SearchConfig(restarts=2), **kw)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        compile(g, hw, engine="tpu")
    with pytest.raises(ValueError, match="unknown schedule strategy|unknown"):
        compile(g, hw, schedule_method="nope", max_iters=10)


@pytest.mark.parametrize("engine,want", [("torch", "torch"), ("jax", "torch"),
                                         ("oracle", "oracle"),
                                         ("python", "python")])
def test_engine_names(tmp_path, engine, want):
    jg = J.random_graph(10, 12, 120, seed=3)
    prog = compile(port_graph(jg), port_hw(make_hw(jg)), engine=engine,
                   max_iters=2000)
    assert prog.default_engine == want
    header, _ = read_artifact(prog.save(tmp_path / engine))
    assert header["default_engine"] == {"torch": "jax"}.get(want, want)
    assert Program.load(tmp_path / f"{engine}.npz").default_engine == want


# -- the deprecated wrappers and the preserved loops ---------------------------

def test_compile_snn_warns_and_returns_the_reference_parts(tmp_path):
    jg, jhw, g, hw = _instance()
    with pytest.warns(DeprecationWarning, match="compile_snn is deprecated"):
        tables, report, part = compile_snn(g, hw, max_iters=3000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jtables, jreport, jpart = J.compile_snn(jg, jhw, max_iters=3000)
    assert_same_partition(part, jpart)
    for f in ("pre", "post", "weight", "pre_end", "post_end", "assign"):
        np.testing.assert_array_equal(getattr(tables, f),
                                      getattr(jtables, f))
    assert (report.method, report.ot_depth, report.n_init_packets) == \
        (jreport.method, jreport.ot_depth, jreport.n_init_packets)
    prog = compile(g, hw, max_iters=3000)
    np.testing.assert_array_equal(prog.tables.pre, tables.pre)


def test_compile_quantized_warns_and_equals_compile():
    sizes = (8, 6, 3)
    rng = np.random.default_rng(2)
    from repro_torch.snn.lif import LIFIntParams
    from repro_torch.snn.quantize import QuantizedSNN
    ws = [rng.integers(-7, 8, (a, b)).astype(np.int32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    q = QuantizedSNN(sizes, ws, [None, None], 0.1, LIFIntParams(2, 9, 0),
                     False)
    hw = HardwareConfig(n_spus=4, unified_mem_depth=64, concentration=3,
                        max_neurons=17, max_post_neurons=9)
    with pytest.warns(DeprecationWarning,
                      match="compile_quantized is deprecated"):
        tables, report, part = compile_quantized(q, hw, max_iters=2000)
    prog = compile(q, hw, max_iters=2000)
    np.testing.assert_array_equal(part.assign, prog.part.assign)
    np.testing.assert_array_equal(tables.pre, prog.tables.pre)
    assert report.ot_depth == prog.ot_depth


@pytest.mark.parametrize("method", ["framework", "synapse_rr"])
def test_schedule_legacy_equals_reference_and_the_vectorized_core(method):
    jg, jhw, g, hw = _instance()
    assign = J.get_strategy(method).partition(jg, jhw, max_iters=3000).assign
    got = schedule_legacy(g, assign, hw)
    want = jax_schedule_legacy(jg, assign, jhw)
    fast = schedule(g, assign, hw)
    for f in ("pre", "post", "weight", "pre_end", "post_end", "assign"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(fast, f))
    np.testing.assert_array_equal(got.send_slot, want.send_slot)
    assert list(got.send_order) == list(want.send_order)
