"""The port's static verifier (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU:

* both golden artifacts verify clean;
* each of the reference's 20 mutations (``tests/test_analysis.py``),
  applied to each package's own load of the tiny golden, gives the same
  report: codes, severities, messages, locations, hints, counts,
  checkers and ``stats`` (``to_json()`` equal but for the wall times);
* ART001 gates the other checkers; SCHED001 keeps the legacy priority
  and ``validate_schedule`` raises the reference's message;
* ``register_checker`` rejects a duplicate name, ``verify`` refuses an
  unregistered code, and the port's ``CODES`` is its own dict holding
  the reference's codes and titles;
* the port's compiles (``framework``, ``synapse_rr``, ``hypergraph`` x
  feedforward and recurrent; each schedule strategy; ``leak_shift = 0``;
  the int8 / int16 range proofs) verify clean with the stats of the
  reference's compile of the same graph, and save its artifact;
* the CLI (``python -m repro_torch.analysis.verify``): the reference's
  JSON but for the wall times, exit codes 0 / 1 / 2;
* ``ProgramRegistry.register(verify=True)`` accepts the golden and
  refuses a mutant with the reference's ``ValueError`` before any
  precompile; ``load(verify=True)`` forwards the gate.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as jax_analysis
import repro_torch.analysis as analysis
from conftest import make_feedforward, make_hw
from repro.analysis.schedule import LEGACY_PRIORITY as JAX_PRIORITY
from repro.core import Program as JaxProgram
from repro.core import compile as jax_compile
from repro.core import random_graph as jax_random_graph
from repro.serve.registry import ProgramRegistry as JaxRegistry
from repro.snn.lif import LIFIntParams as JaxLIF
from repro_torch.analysis import CODES, Diagnostic, Severity
from repro_torch.analysis.schedule import LEGACY_PRIORITY, check_schedule
from repro_torch.core import Program, compile
from repro_torch.core.scheduling import validate_schedule
from repro_torch.serve import ProgramRegistry
from torch_parity import assert_same_artifact, port_graph, port_hw
from test_analysis import MUTATIONS, _mutate_art001, _mutate_mem004, \
    _mutate_mem005, _mutate_sched001, _mutate_sched006

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
TINY = GOLDEN / "tiny_program_v1.npz"
WALL = ("wall_ms", "checker_wall_ms")
BUILTIN = {"ART001", "ART002", "ART003", "MEM001", "MEM002", "MEM003",
           "MEM004", "MEM005", "MEM006", "MEM007", "MEM008", "MEM009",
           "RANGE001", "RANGE002", "SCHED001", "SCHED002", "SCHED003",
           "SCHED004", "SCHED005", "SCHED006", "SCHED007", "SCHED008",
           "SCHED009"}


def no_wall(report) -> dict:
    d = report.to_json()
    assert set(d[WALL[1]]) == set(d["checkers"]) and d[WALL[0]] > 0
    return {k: v for k, v in d.items() if k not in WALL}


def both(path=TINY):
    return Program.load(path), JaxProgram.load(path)


def assert_same_report(got, want):
    assert no_wall(got) == no_wall(want)
    assert [str(d) for d in got.diagnostics] == \
        [str(d) for d in want.diagnostics]
    assert got.summary().splitlines()[1:] == want.summary().splitlines()[1:]
    assert got.ok == want.ok and got.codes() == want.codes()


# -- goldens, mutations --------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_goldens_are_clean(name):
    p, jp = both(GOLDEN / f"{name}_program_v1.npz")
    rep = p.verify()
    assert rep.ok and not rep.diagnostics, rep.summary()
    assert rep.checkers == ["artifact", "schedule", "ranges", "memory"]
    assert rep.summary().startswith("clean: 0 diagnostics")
    assert_same_report(rep, jp.verify())


@pytest.mark.parametrize("code,mutate", MUTATIONS,
                         ids=[c for c, _ in MUTATIONS])
def test_mutation_gives_the_reference_report(code, mutate):
    p, jp = both()
    mutate(p)
    mutate(jp)
    rep = p.verify()
    assert code in rep.codes() and not rep.ok, rep.summary()
    assert_same_report(rep, jp.verify())
    assert all(d.code in CODES for d in rep.diagnostics)


def test_codes_registry_is_the_ports_own():
    Program.load(TINY).verify()
    JaxProgram.load(TINY).verify()
    assert CODES is not jax_analysis.CODES
    assert BUILTIN <= set(CODES)
    assert {c: CODES[c] for c in BUILTIN} == \
        {c: jax_analysis.CODES[c] for c in BUILTIN}
    assert analysis.register_code("SCHED001", CODES["SCHED001"]) == "SCHED001"
    with pytest.raises(ValueError, match="already registered"):
        analysis.register_code("SCHED001", "something else")


def test_art001_gates_the_other_checkers():
    p, jp = both()
    _mutate_art001(p)
    _mutate_art001(jp)
    rep = p.verify()
    assert rep.checkers == ["artifact"] and not rep.ok
    assert_same_report(rep, jp.verify())


def test_sched001_wins_legacy_priority():
    p, jp = both()
    _mutate_sched001(p)
    _mutate_sched001(jp)
    diags = check_schedule(p.graph, p.tables)
    assert {"SCHED001", "SCHED002"} <= {d.code for d in diags}
    assert LEGACY_PRIORITY == JAX_PRIORITY
    from repro.core.scheduling import validate_schedule as jax_validate
    msgs = []
    for fn, prog in ((validate_schedule, p), (jax_validate, jp)):
        with pytest.raises(AssertionError, match=r"ops != \d+ synapses") \
                as info:
            fn(prog.graph, prog.tables)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_diagnostic_location_and_hint():
    p = Program.load(TINY)
    _mutate_sched006(p)
    d = next(x for x in p.verify().diagnostics if x.code == "SCHED006")
    assert d.severity is Severity.ERROR and str(d.severity) == "error"
    assert d.location.post is not None and d.location.spu is not None
    assert d.hint and "SCHED006" in str(d) and "post" in str(d)


def test_verify_subset_and_unknown_checker():
    p, jp = both()
    assert_same_report(p.verify(["schedule", "ranges"]),
                       jp.verify(["schedule", "ranges"]))
    with pytest.raises(KeyError, match="unknown checker"):
        p.verify(["nope"])


def test_register_checker_and_unregistered_codes():
    verify = importlib.import_module("repro_torch.analysis.verify")

    def rogue(program):
        return [Diagnostic(code="BOGUS99", severity=Severity.ERROR,
                           message="x")], {}

    analysis.register_checker("rogue-test", rogue)
    try:
        assert "rogue-test" not in jax_analysis.CHECKERS
        with pytest.raises(ValueError, match="unregistered code"):
            analysis.verify(Program.load(TINY))
        with pytest.raises(ValueError, match="already registered"):
            analysis.register_checker("rogue-test", rogue)
    finally:
        analysis.CHECKERS.pop("rogue-test")
    assert analysis.CHECKERS is verify.CHECKERS
    assert list(analysis.CHECKERS) == list(jax_analysis.CHECKERS)
    assert analysis.verify is verify.verify and callable(analysis.verify)


# -- the port's compiles against the reference's -----------------------------

def _compiled(g, hw, **kw):
    """The port's compile of a reference graph, and the reference's."""
    return compile(port_graph(g), port_hw(hw), **kw), jax_compile(g, hw, **kw)


COMPILES = ([(m, r, "slack") for m in ("framework", "synapse_rr",
                                       "hypergraph") for r in (False, True)]
            + [("framework", True, s) for s in ("consecutive",
                                                "load_balance")])


@pytest.mark.parametrize("method,recurrent,schedule_method", COMPILES)
def test_compile_matrix_is_clean_with_the_reference_stats(
        tmp_path, method, recurrent, schedule_method):
    g = (jax_random_graph(10, 12, 120, seed=3) if recurrent
         else make_feedforward())
    p, jp = _compiled(g, make_hw(g), method=method,
                      schedule_method=schedule_method)
    rep = p.verify()
    assert rep.ok and not rep.diagnostics, rep.summary()
    assert_same_report(rep, jp.verify())
    assert_same_artifact(p, jp, tmp_path)


def test_leak_shift_zero_and_range_proofs(tmp_path):
    lif = JaxLIF(leak_shift=0, v_threshold=9, v_reset=-2)
    g = jax_random_graph(6, 8, 40, seed=7, lif=lif)
    p, jp = _compiled(g, make_hw(g))
    rep = p.verify()
    assert_same_report(rep, jp.verify())
    r = rep.stats["ranges"]
    assert r["membrane_hi"] == r["current_hi"]
    assert r["membrane_lo"] == min(0, -2, r["current_lo"])
    ff = make_feedforward()
    assert _compiled(ff, make_hw(ff))[0] \
        .verify().stats["ranges"]["dense_dtype"] == "int8"
    g = jax_random_graph(12, 10, 110, seed=2, weight_lo=-255, weight_hi=255)
    hw = dataclasses.replace(make_hw(g), weight_bits=9, potential_bits=18)
    p, jp = _compiled(g, hw)
    r = p.verify().stats["ranges"]
    assert r["dense_dtype"] == "int16" and r["int32_safe"]
    assert_same_report(p.verify(), jp.verify())
    from repro_torch.kernels.fused_step import pack_dense
    assert pack_dense(p.lowered).dtype == np.int16


# -- the CLI -------------------------------------------------------------------

def _run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "sys.argv = ['verify'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.analysis.verify', "
            "run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _reference_cli(capsys, *args):
    main = importlib.import_module("repro.analysis.verify").main
    status = main(list(args))
    return status, capsys.readouterr().out


def _strip(payload: dict) -> dict:
    return {p: {k: v for k, v in r.items() if k not in WALL}
            for p, r in payload.items()}


def test_cli_exit_codes_and_json(tmp_path, capsys):
    shd = str(GOLDEN / "shd_program_v1.npz")
    r = _run_cli(str(TINY), shd, "--strict")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("clean: 0 diagnostics") == 2
    assert "RuntimeWarning" not in r.stderr

    p = Program.load(TINY)
    _mutate_mem004(p)
    bad = str(p.save(tmp_path / "stale.npz"))
    for args in ((bad, "--json"), (str(TINY), bad, "--json")):
        r = _run_cli(*args)
        assert r.returncode == 1, r.stderr
        status, out = _reference_cli(capsys, *args)
        assert status == 1
        assert _strip(json.loads(r.stdout)) == _strip(json.loads(out))
    assert any(d["code"] == "MEM004"
               for d in json.loads(r.stdout)[bad]["diagnostics"])
    r = _run_cli(bad)
    assert r.returncode == 1 and f"{bad}: 1 diagnostic(s)" in r.stdout

    bogus = tmp_path / "nope.npz"
    bogus.write_bytes(b"not an npz")
    r = _run_cli(str(bogus))
    assert r.returncode == 2 and "cannot load" in r.stderr
    assert _reference_cli(capsys, str(bogus))[0] == 2


# -- the serving gate ------------------------------------------------------------

def test_registry_verify_gate(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(Program, "precompile",
                        lambda self, *a, **k: calls.append(a) or [])
    reg = ProgramRegistry()
    reg.register("good", Program.load(TINY), verify=True, precompile=(1,),
                 timesteps=4)
    assert "good" in reg and calls == [((1,), 4, None)]
    calls.clear()
    msgs = []
    for registry, load in ((reg, Program.load), (JaxRegistry(),
                                                 JaxProgram.load)):
        bad = load(TINY)
        _mutate_mem005(bad)
        with pytest.raises(ValueError, match="failed static verification") \
                as info:
            registry.register("bad", bad, verify=True, precompile=(1, 2),
                              timesteps=4)
        msgs.append(str(info.value))
        assert "bad" not in registry
    assert msgs[0] == msgs[1] and calls == []
    p = Program.load(TINY)
    p.report.n_init_packets += 1
    path = p.save(tmp_path / "stale.npz")
    with pytest.raises(ValueError, match="MEM006"):
        reg.load("stale", path, verify=True, precompile=(1,), timesteps=4)
    assert "stale" not in reg and calls == []
