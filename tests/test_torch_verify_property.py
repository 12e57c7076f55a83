"""Hypothesis property, the port's side of
``tests/test_analysis_property.py``: every reference ``compile()``
output (any graph shape, mapping strategy and schedule strategy),
saved and loaded by the port, verifies clean with the reference's
report, and the port's ``schedule`` of its assignment under the same
strategy gives its tables."""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest

from conftest import make_hw
from repro.core import compile, random_graph
from repro.core.graph import SNNGraph
from repro_torch.core import Program
from repro_torch.core.scheduling import schedule

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

WALL = ("wall_ms", "checker_wall_ms")


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000),
       n_inputs=st.integers(2, 12), n_internal=st.integers(4, 14),
       density=st.floats(0.2, 0.9),
       method=st.sampled_from(["framework", "synapse_rr", "hypergraph"]),
       schedule_method=st.sampled_from(["slack", "consecutive",
                                        "load_balance"]),
       feedforward=st.booleans())
def test_port_verifies_every_compile_clean(seed, n_inputs, n_internal,
                                           density, method, schedule_method,
                                           feedforward):
    n_syn = max(4, int(density * (n_inputs + n_internal) * n_internal))
    g = random_graph(n_inputs, n_internal, n_syn, seed=seed)
    if feedforward:
        ff = g.pre < n_inputs
        if ff.sum() < 2:
            return
        g = SNNGraph(g.n_inputs, g.n_neurons, g.pre[ff], g.post[ff],
                     g.weight[ff], g.lif, g.output_slice)
    jp = compile(g, make_hw(g), method=method,
                 schedule_method=schedule_method)
    with tempfile.TemporaryDirectory() as tmp:
        p = Program.load(jp.save(Path(tmp) / "p"))
    rep = p.verify()
    assert rep.ok and not rep.diagnostics, rep.summary()
    want = {k: v for k, v in jp.verify().to_json().items() if k not in WALL}
    assert {k: v for k, v in rep.to_json().items() if k not in WALL} == want
    t = schedule(p.graph, p.tables.assign, p.hw, method=schedule_method)
    for f in ("pre", "post", "weight", "pre_end", "post_end"):
        np.testing.assert_array_equal(getattr(t, f), getattr(p.tables, f))
    assert t.send_slot == p.tables.send_slot
