"""The paper's two experiments as the port's entry points, held to the
reference.

* ``repro_torch.launch.mnist_end_to_end.deploy`` — quantize, compile,
  one mapped run, profile, accuracy — against the reference's own chain
  (``repro.snn.quantize`` -> ``repro.core.from_quantized`` -> ``compile``
  -> ``Program.run(engine="oracle")`` -> ``profile``) on the same float
  params (the reference's ``init_params`` from a seed, carried across by
  ``params_from_numpy``) and the same int32 spike trains from numpy: the
  784-116-10 SFNN at full width on ``MNIST_HW`` (8 images) and the
  700-300-20 SRNN on ``SHD_HW`` (1 sample). Every integer is bit-exact
  and the modeled latency and energy are equal (tolerance 0), through
  the port's oracle and through its batched engine's fused tier (its
  plain version on the CPU);
* the port's quickstart (``--device cpu``) and ``examples/quickstart.py``
  each in a subprocess print the same lines;
* every new entry point's ``main`` runs to its end at tiny flags with
  ``--device cpu`` (the MNIST example's torch and python engines giving
  the same row), and raises without a card when ``--device`` is left to
  default.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.snn as JS
from repro.configs.snn_paper import MNIST_HW as J_MNIST_HW
from repro.configs.snn_paper import SHD_HW as J_SHD_HW
from repro.data import synthetic_mnist, synthetic_shd
from repro.snn.models import init_params as j_init_params
from repro_torch.configs.snn_paper import MNIST_HW, SHD_HW
from repro_torch.core import ExecutionSpec
from repro_torch.launch import (lm_pretrain, mnist_end_to_end, quickstart,
                                serve_batched, shd_srnn)
from repro_torch.snn import MNIST_CONFIG, QuantConfig
from repro_torch.snn.models import params_from_numpy
from torch_parity import assert_same_run

ROOT = Path(__file__).resolve().parents[1]
SPECS = [ExecutionSpec(engine="oracle", device="cpu"),
         ExecutionSpec(device="cpu")]


def _ext_mnist(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n synthetic test images rate-coded by numpy: [n, T, 784] int32."""
    _, _, xte, yte = synthetic_mnist(n_train=8, n_test=n, seed=seed)
    rng = np.random.default_rng(seed)
    t = MNIST_CONFIG.timesteps
    ext = (rng.random((n, t, 784)) < xte[:, None, :]).astype(np.int32)
    return ext, yte


def _reference_chain(params, cfg, hw, qcfg, ext, max_iters):
    q = JS.quantize(params, cfg, qcfg)
    g = J.from_quantized(q)
    program = J.compile(g, hw, max_iters=max_iters)
    run = program.run(ext, "oracle")
    prof = program.profile(run[2], n_synapses=q.n_total_synapses)
    return q, g, program, run, prof


def _assert_deploy_equals_reference(dep, ref, labels):
    q, g, program, run, prof = ref
    pq = dep["quantized"]
    assert pq.scale == q.scale and pq.lif == tuple(q.lif)
    for a, b in zip(pq.weights + pq.rec_weights, q.weights + q.rec_weights):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    port = dep["program"]
    np.testing.assert_array_equal(port.tables.pre, program.tables.pre)
    np.testing.assert_array_equal(port.part.assign, program.part.assign)
    assert_same_run(dep["outputs"], run)
    assert dep["outputs"][0].any(), "the net must spike"
    want = {"n_synapses": g.n_synapses,
            "n_total_synapses": q.n_total_synapses,
            "sparsity": q.sparsity, "feasible": program.feasible,
            "iterations": program.report.iterations,
            "ot_depth": program.ot_depth,
            "brams": program.report.resources.brams,
            "n_samples": len(labels)}
    assert {k: dep[k] for k in want} == want
    assert [dataclasses.astuple(r) for r in dep["profile"].per_sample] == \
        [dataclasses.astuple(r) for r in prof.per_sample]
    assert dep["latency_us"] == np.mean([r.latency_us
                                         for r in prof.per_sample])
    assert dep["energy_mj"] == np.mean([r.energy_mj
                                        for r in prof.per_sample])
    out_lo = g.output_slice[0] - g.n_inputs
    n_out = g.output_slice[1] - g.output_slice[0]
    correct = sum(int(np.argmax(run[0][i].sum(0)[out_lo:out_lo + n_out])
                      == labels[i]) for i in range(len(labels)))
    assert dep["accuracy"] == correct / len(labels)


@pytest.fixture(scope="module")
def mnist_case():
    np_params = {k: np.asarray(v) for k, v in j_init_params(
        JS.MNIST_CONFIG, jax.random.PRNGKey(0)).items()}
    ext, labels = _ext_mnist(8, seed=3)
    ref = _reference_chain(np_params, JS.MNIST_CONFIG, J_MNIST_HW,
                           JS.QuantConfig(4, 5), ext, 40000)
    return np_params, ext, labels, ref


@pytest.fixture(scope="module")
def shd_case():
    cfg = JS.SHD_CONFIG
    np_params = {k: np.asarray(v) for k, v in j_init_params(
        cfg, jax.random.PRNGKey(1)).items()}
    _, _, xte, yte = synthetic_shd(n_train=2, n_test=1,
                                   timesteps=cfg.timesteps, seed=0)
    ext = xte.astype(np.int32)
    ref = _reference_chain(np_params, cfg, J_SHD_HW, JS.QuantConfig(7, 12),
                           ext, 60000)
    return np_params, ext, yte, ref


@pytest.mark.parametrize("spec", SPECS, ids=["oracle", "fused"])
def test_mnist_deploy_equals_the_reference_chain(mnist_case, spec):
    np_params, ext, labels, ref = mnist_case
    params = params_from_numpy(np_params, MNIST_CONFIG, "cpu")
    dep = mnist_end_to_end.deploy(params, MNIST_CONFIG, MNIST_HW,
                                  QuantConfig(4, 5), ext, labels=labels,
                                  spec=spec, max_iters=40000)
    _assert_deploy_equals_reference(dep, ref, labels)
    assert dep["program"].lowered.n_internal == 126
    assert set(dep["seconds"]) == {"quantize", "compile", "run"}


@pytest.mark.parametrize("spec", SPECS, ids=["oracle", "fused"])
def test_shd_deploy_equals_the_reference_chain(shd_case, spec):
    np_params, ext, labels, ref = shd_case
    cfg = shd_srnn.shd_config()
    params = params_from_numpy(np_params, cfg, "cpu")
    dep = shd_srnn.deploy(params, cfg, SHD_HW, QuantConfig(7, 12), ext,
                          labels=labels, spec=spec, max_iters=60000)
    _assert_deploy_equals_reference(dep, ref, labels)
    assert dep["program"].lowered.n_internal == 320


def test_shd_config_is_the_paper_srnn():
    cfg = shd_srnn.shd_config()
    assert (cfg.layer_sizes, cfg.recurrent, cfg.sparsity, cfg.lif.alpha,
            cfg.surrogate, cfg.timesteps) == \
        (JS.SHD_CONFIG.layer_sizes, JS.SHD_CONFIG.recurrent,
         JS.SHD_CONFIG.sparsity, JS.SHD_CONFIG.lif.alpha,
         JS.SHD_CONFIG.surrogate, JS.SHD_CONFIG.timesteps)


def test_deploy_rejects_spikes_that_are_not_int32_batches(mnist_case):
    np_params, ext, labels, _ = mnist_case
    params = params_from_numpy(np_params, MNIST_CONFIG, "cpu")
    for bad in (ext.astype(np.float32), ext[0]):
        with pytest.raises(ValueError, match="int32"):
            mnist_end_to_end.deploy(params, MNIST_CONFIG, MNIST_HW,
                                    QuantConfig(4, 5), bad, labels=labels,
                                    spec=SPECS[0])


def _stdout(args, **env):
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         env={**base, "PYTHONPATH": str(ROOT / "src"), **env},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_quickstart_prints_the_reference_lines():
    port = _stdout(["-m", "repro_torch.launch.quickstart", "--device",
                    "cpu"])
    ref = _stdout([str(ROOT / "examples" / "quickstart.py")],
                  JAX_PLATFORMS="cpu")
    assert len(port) == len(ref) == 6
    assert port == ref


def test_quickstart_main_returns_what_it_prints(capsys):
    got = quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert f"operation-table depth={got['ot_depth']}" in lines[0]
    assert f"({got['spikes']} spikes)" in lines[1]
    assert f"BRAMs={got['brams']}" in lines[2]
    assert f"{got['init_packets']} init packets" in lines[4]
    assert f"at depth {got['joint_depth']}" in lines[5]


def test_mnist_main_torch_and_python_engines_give_one_row():
    argv = ["--steps", "2", "--test-images", "4", "--device", "cpu"]
    rows = [mnist_end_to_end.main(argv + extra) for extra in
            ([], ["--engine", "jax", "--kernel", "lif"],
             ["--engine", "python"])]
    for r in rows:
        assert r["device"] == "cpu" and r["n_samples"] == 4
        assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 2
        assert set(r["seconds"]) == {"train", "quantize", "compile", "run"}
    assert [r["engine"] for r in rows] == ["torch", "torch", "python"]
    keys = set(mnist_end_to_end.ROW_KEYS) | {"float_accuracy", "losses"}
    assert {k: rows[0][k] for k in keys} == {k: rows[1][k] for k in keys} \
        == {k: rows[2][k] for k in keys}
    with pytest.raises(ValueError, match="--kernel"):
        mnist_end_to_end.main(argv + ["--engine", "python", "--kernel",
                                      "lif"])


def test_mnist_main_saves_the_artifact(tmp_path):
    from repro_torch.core import Program
    got = mnist_end_to_end.main(["--steps", "1", "--test-images", "2",
                                 "--device", "cpu", "--save",
                                 str(tmp_path / "mnist")])
    loaded = Program.load(tmp_path / "mnist.npz")
    assert loaded.ot_depth == got["ot_depth"]


def test_shd_main_runs_to_its_end():
    got = shd_srnn.main(["--steps", "2", "--hidden", "40", "--timesteps",
                         "12", "--batch", "3", "--device", "cpu"])
    assert got["n_samples"] == 3 and got["device"] == "cpu"
    assert np.isfinite(got["losses"]).all()
    assert got["latency_us"] > 0 and got["sample0_latency_us"] > 0


def test_serve_batched_main_runs_to_its_end():
    got = serve_batched.main(["--batch", "2", "--prompt-len", "8", "--gen",
                              "3", "--device", "cpu"])
    assert got["tokens"].shape == (2, 3)


def test_lm_pretrain_main_runs_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = lm_pretrain.main(["--steps", "2", "--batch", "2", "--seq", "16",
                              "--ckpt-dir", ckpt, "--device", "cpu"])
    assert len(first["losses"]) == 2 and np.isfinite(first["losses"]).all()
    more = lm_pretrain.main(["--steps", "3", "--batch", "2", "--seq", "16",
                             "--ckpt-dir", ckpt, "--device", "cpu",
                             "--resume"])
    assert len(more["losses"]) == 1


@pytest.mark.parametrize("mod", [quickstart, mnist_end_to_end, shd_srnn,
                                 serve_batched, lm_pretrain],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_a_card(mod, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--ckpt-dir", str(tmp_path)] if mod is lm_pretrain else [])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main(argv)
