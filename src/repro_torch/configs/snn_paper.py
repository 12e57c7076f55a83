"""SupraSNN's own two networks (paper Table 2) as selectable configs;
port of ``repro/configs/snn_paper.py``."""
from repro_torch.core.memory_model import HardwareConfig
from repro_torch.snn.models import MNIST_CONFIG, SHD_CONFIG  # noqa: F401


def mnist_scale_random_graph(n_synapses: int = 12000, seed: int = 0):
    """Random graph + hardware at the paper's MNIST scale (784-126,
    16 SPUs). Returns (graph, HardwareConfig)."""
    from repro_torch.core.graph import random_graph
    g = random_graph(784, 126, n_synapses, seed=seed)
    hw = HardwareConfig(
        n_spus=16, unified_mem_depth=4 * (n_synapses // 16 // 3 + 126),
        concentration=3, weight_bits=4, potential_bits=5,
        max_neurons=910, max_post_neurons=126, clock_mhz=100.0)
    return g, hw

MNIST_HW = HardwareConfig(
    n_spus=16, unified_mem_depth=128, concentration=3, weight_bits=4,
    potential_bits=5, max_neurons=910, max_post_neurons=126,
    clock_mhz=100.0)

SHD_HW = HardwareConfig(
    n_spus=64, unified_mem_depth=256, concentration=3, weight_bits=7,
    potential_bits=12, max_neurons=1020, max_post_neurons=320,
    clock_mhz=100.0)
