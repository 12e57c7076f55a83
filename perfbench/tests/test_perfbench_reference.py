"""The plain reference against the port's CPU engine, bit for bit, at
the configurations' full widths, and the frozen counts against figures
worked by hand."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import check, inputs, network, spec  # noqa: E402
from perfbench.reference import lif_net  # noqa: E402



def _config(name: str) -> dict:
    """A configuration's file, whether or not a cell of BENCHMARK.json
    uses it now (the MNIST net's waits in Open questions)."""
    return spec.load_json(ROOT, f"perfbench/configs/{name}.json")


@pytest.mark.parametrize("name,seed", [("shd-srnn", 3),
                                       ("shd-srnn", 2**31 + 17),
                                       ("mnist-sfnn", 5),
                                       ("mnist-sfnn", 2**31 + 9)])
def test_reference_equals_port_cpu_engine(name, seed):
    from repro_torch.core import ExecutionSpec, HardwareConfig, compile
    cfg = _config(name)
    net = network.draw_network(cfg, seed)
    assert net.n_synapses == network.expected_synapses(cfg)
    program = compile(network.to_program_input(net),
                      HardwareConfig(**cfg["hardware"]),
                      max_iters=cfg["compile"]["max_iters"])
    ext = inputs.make_pool(ROOT, cfg, network.rng_for(seed, 2), 4)
    s, v, stats = program.run(ext, ExecutionSpec(device="cpu"))
    rs, rv, rp = lif_net.run(net.weights, net.rec_weights, net.leak_shift,
                             net.v_threshold, net.v_reset, ext)
    assert s.shape == rs.shape and v.shape == rv.shape
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(stats["packet_counts"], rp)
    assert 0 < rs.mean() < 0.5          # the net neither silent nor saturated


@pytest.mark.parametrize("name", ["shd-srnn", "mnist-sfnn"])
def test_control_differs_from_reference(name):
    cfg = _config(name)
    net = network.draw_network(cfg, 7)
    ext = inputs.make_pool(ROOT, cfg, network.rng_for(7, 2), 4)
    want = check.expected(lif_net, net, ext)
    got = check.expected(lif_net, net, ext, cfg["control_potential_bits"])
    assert np.count_nonzero(got[0] != want[0]) > 0


def test_frozen_counts_by_hand():
    k = spec.kernel(ROOT, "fused_run")
    shd = {"synapses": 39658, "timesteps": 100, "n_inputs": 700,
           "n_internal": 320, "weight_bits": 7}
    mnist = {"synapses": 44311, "timesteps": 10, "n_inputs": 784,
             "n_internal": 126, "weight_bits": 4}
    # 210,000 x 0.1296 = 27,216; 90,000 x 0.1296 = 11,664; 6,000 x 0.1296
    # = 777.6 -> 778
    assert network.expected_synapses(_config("shd-srnn")) == 39658
    # 90,944 x 0.4811 = 43,753.2 -> 43,753; 1,160 x 0.4811 = 558.1 -> 558
    assert network.expected_synapses(_config("mnist-sfnn")) == 44311
    assert k.operations(shd, 32) == 253_811_200
    # ext 2,240,000 + spikes 1,024,000 + v 40,960 + packets 12,800
    # + plane 1,020 x 320 = 326,400
    assert k.bytes_moved(shd, 32) == 3_644_160
    assert k.operations(mnist, 512) == 453_744_640
    # 4,014,080 + 645,120 + 258,048 + 20,480 + 910 x 126 = 114,660
    assert k.bytes_moved(mnist, 512) == 5_052_388
    from perfbench import peaks
    assert peaks.bound_s(3_644_160, 253_811_200) == pytest.approx(
        3_644_160 / 3.35e12)


def test_inputs_repeat_by_seed():
    cfg = _config("mnist-sfnn")
    a = inputs.make_pool(ROOT, cfg, network.rng_for(2**31 + 3, 2), 3)
    b = inputs.make_pool(ROOT, cfg, network.rng_for(2**31 + 3, 2), 3)
    c = inputs.make_pool(ROOT, cfg, network.rng_for(2**31 + 4, 2), 3)
    assert a.dtype == np.int32 and a.shape == (3, 10, 784)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
