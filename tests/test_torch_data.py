"""The port's synthetic datasets give the JAX package's arrays.

``repro_torch.data`` is the port's own numpy copy of ``repro.data``; for
the same seed every array and every batch is identical (dtype
included), and ``load_mnist`` reads the same IDX files or falls back to
the same synthetic set.
"""
import gzip
import struct

import numpy as np
import pytest

import repro.data as ref_data
import repro_torch.data as port_data


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_identical(seed):
    kw = dict(n_train=24, n_test=8, seed=seed)
    want = ref_data.synthetic_mnist(**kw)
    got = port_data.synthetic_mnist(**kw)
    _same(got, want)
    batches = zip(port_data.mnist_batches(got[0], got[1], 5, seed=seed),
                  ref_data.mnist_batches(want[0], want[1], 5, seed=seed))
    for _ in range(7):                               # past one epoch
        g, w = next(batches)
        _same(g, w)


@pytest.mark.parametrize("seed,timesteps", [(0, 100), (2, 40)])
def test_synthetic_shd_is_identical(seed, timesteps):
    kw = dict(n_train=12, n_test=6, timesteps=timesteps, seed=seed)
    want = ref_data.synthetic_shd(**kw)
    got = port_data.synthetic_shd(**kw)
    _same(got, want)
    batches = zip(port_data.shd_batches(got[0], got[1], 4, seed=seed),
                  ref_data.shd_batches(want[0], want[1], 4, seed=seed))
    for _ in range(4):
        g, w = next(batches)
        _same(g, w)
        assert g[0].shape == (timesteps, 4, 700)


def test_load_mnist_reads_idx_or_falls_back(tmp_path):
    kw = dict(n_train=4, n_test=2, seed=1)
    _same(port_data.load_mnist(tmp_path, **kw),
          ref_data.load_mnist(str(tmp_path), **kw))
    rng = np.random.default_rng(0)
    for name, shape in (("train-images-idx3-ubyte", (3, 28, 28)),
                        ("train-labels-idx1-ubyte", (3,)),
                        ("t10k-images-idx3-ubyte.gz", (2, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (2,))):
        body = struct.pack(">I", 0x0800 | len(shape)) \
            + struct.pack(">" + "I" * len(shape), *shape) \
            + rng.integers(0, 256, shape, dtype=np.uint8).tobytes()
        with (gzip.open if name.endswith(".gz") else open)(
                tmp_path / name, "wb") as f:
            f.write(body)
    got = port_data.load_mnist(tmp_path)
    _same(got, ref_data.load_mnist(str(tmp_path)))
    assert got[0].shape == (3, 784) and got[3].shape == (2,)
