"""The port's int8 gradient compression
(``repro_torch/distributed/compression.py``) against the reference's
(``repro/distributed/compression.py``) on the same seeded trees: ``q``
and ``scale`` bit for bit, the dequantized tree and error feedback over
several steps bit for bit, on float32 and bf16 leaves whose sizes 1,024
does not divide (and one it does), at block 1024 and 256; the traffic
model equal. The compressed all-reduce over a mesh axis is checked in
``tests/test_torch_ranks.py`` (two ranks).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import compression as RC
from repro_torch.distributed import compression as TC

SHAPES = {"w": (33, 47), "b": (5,), "e": (4, 256), "big": (3, 700, 3),
          "nest": {"x": (1025,)}}


def _tree(seed: int, dtype: str, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)

    def one(shape):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        a[..., 0] *= 1e3                     # an outlier per block row
        return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a
    return {k: ({kk: one(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else one(v)) for k, v in SHAPES.items()}


def _ref(tree):
    return {k: (_ref(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _port(tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
                .view(torch.bfloat16)
        return torch.from_numpy(a)
    return {k: (_port(v) if isinstance(v, dict) else one(v))
            for k, v in tree.items()}


def _pairs(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            yield from _pairs(ref[k], port[k], f"{path}/{k}")
    else:
        yield path, np.asarray(ref), port.numpy()


def _same(ref, port):
    n = 0
    for path, a, b in _pairs(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
        n += 1
    return n


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block", [1024, 256])
def test_compress_int8_bit_exact(dtype, block):
    tree = _tree(0, dtype)
    want = RC.compress_int8(_ref(tree), block=block)
    got = TC.compress_int8(_port(tree), block=block)
    assert _same(want.q, got.q) == 5
    _same(want.scale, got.scale)
    _same(RC.decompress_int8(want, _ref(tree)),
          TC.decompress_int8(got, _port(tree)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_error_feedback_over_steps_bit_exact(dtype):
    ref_err = RC.init_error(_ref(_tree(0, dtype)))
    port_err = TC.init_error(_port(_tree(0, dtype)))
    _same(ref_err, port_err)
    for step in range(4):
        g = _tree(10 + step, dtype, scale=10.0 ** -step)
        wc, wd, ref_err = RC.compress_error_feedback(_ref(g), ref_err)
        gc, gd, port_err = TC.compress_error_feedback(_port(g), port_err)
        _same(wc.q, gc.q)
        _same(wc.scale, gc.scale)
        _same(wd, gd)
        _same(ref_err, port_err)


def test_zero_leaf_and_tiny_scale():
    tree = {"z": np.zeros((7, 3), np.float32),
            "t": np.full((9,), 1e-30, np.float32)}
    want = RC.compress_int8(_ref(tree))
    got = TC.compress_int8(_port(tree))
    _same(want.q, got.q)
    _same(want.scale, got.scale)


@pytest.mark.parametrize("n_params", [1, 1_544_000_000, 671_000_000_000])
@pytest.mark.parametrize("link_gbps", [50.0, 12.5])
def test_compressed_allreduce_spec_equal(n_params, link_gbps):
    assert TC.compressed_allreduce_spec(n_params, link_gbps=link_gbps) == \
        RC.compressed_allreduce_spec(n_params, link_gbps=link_gbps)
