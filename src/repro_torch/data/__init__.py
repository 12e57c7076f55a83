"""Port of :mod:`repro.data`: the synthetic MNIST and SHD generators."""
from repro_torch.data.mnist import load_mnist, mnist_batches, synthetic_mnist
from repro_torch.data.shd import shd_batches, synthetic_shd

__all__ = ["synthetic_mnist", "mnist_batches", "load_mnist",
           "synthetic_shd", "shd_batches"]
