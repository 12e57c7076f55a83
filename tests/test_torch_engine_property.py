"""Property tests (hypothesis) of the port's executors against the JAX
package's: for any random graph, any feasible hardware config and any
input spike train, the port's host simulator (``run_mapped``) and its
oracle (``run_oracle``, on the CPU here) give the reference's bits, and
each other's (the deterministic-commit property). Mirrors
``tests/test_engine_property.py``.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import HardwareConfig, compile as compile_program
from repro.core import random_graph, run_mapped, run_oracle
from repro.snn.lif import LIFIntParams
from repro_torch.core import engine
from torch_parity import carry


@st.composite
def graph_and_hw(draw):
    n_in = draw(st.integers(2, 24))
    n_int = draw(st.integers(4, 40))
    max_e = (n_in + n_int) * n_int
    n_syn = draw(st.integers(min(8, max_e), min(400, max_e)))
    seed = draw(st.integers(0, 2 ** 16))
    m = draw(st.sampled_from([2, 4, 8]))
    k = draw(st.integers(1, 4))
    leak = draw(st.integers(1, 4))
    vth = draw(st.integers(3, 40))
    g = random_graph(n_in, n_int, n_syn, seed=seed,
                     lif=LIFIntParams(leak_shift=leak, v_threshold=vth,
                                      v_reset=0))
    hw = HardwareConfig(n_spus=m, unified_mem_depth=4 * (n_syn // m + n_int),
                        concentration=k, max_neurons=n_in + n_int,
                        max_post_neurons=n_int)
    t = draw(st.integers(1, 12))
    rate = draw(st.floats(0.05, 0.9))
    ext_seed = draw(st.integers(0, 2 ** 16))
    return g, hw, t, rate, ext_seed


@given(graph_and_hw())
@settings(max_examples=20, deadline=None)
def test_port_executors_bit_exact(case):
    g, hw, t, rate, ext_seed = case
    program = compile_program(g, hw, seed=0, max_iters=4000)
    ported = carry(program)
    rng = np.random.default_rng(ext_seed)
    ext = (rng.random((t, g.n_inputs)) < rate).astype(np.int32)
    s_ref, v_ref = run_oracle(g, ext)
    s_map, v_map, st_map = run_mapped(g, program.tables, ext)
    s_o, v_o = engine.run_oracle(ported.graph, ext, "cpu")
    s_m, v_m, st_m = engine.run_mapped(ported.graph, ported.tables, ext)
    for a, b in ((s_o, s_ref), (v_o, v_ref), (s_m, s_map), (v_m, v_map),
                 (st_m["packet_counts"], st_map["packet_counts"]),
                 (engine.oracle_packet_counts(ext, s_o),
                  st_map["packet_counts"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
