"""Parity of the port's fused timestep with the JAX reference.

``repro_torch.kernels.fused_step`` (``pack_dense``, ``fused_step`` and its
plain version ``fused_step_ref``) against ``repro.kernels.fused_step``,
whose Pallas ``fused_step`` runs in interpret mode, both as one
full-array tile (``block=None``) and tiled with a small explicit block.
Every comparison is bit-exact: tolerance 0. Inputs come from numpy
seeds: int8, int16 and int32 planes, ragged shapes, recurrent spikes,
negative potentials and non-positive thresholds.
"""
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fused_step as jax_fused
import repro_torch.kernels.fused_step as torch_fused
from repro.core import Program as JaxProgram
from repro.snn.lif import LIFIntParams as JaxLIFIntParams
from repro_torch.core import Program as TorchProgram
from repro_torch.kernels.fused_step import (contract_int32, fused_step,
                                            fused_step_ref, pack_dense)
from repro_torch.snn.lif import LIFIntParams
from torch_parity import to_torch

GOLDEN = Path(__file__).parent / "golden"
PLANE_DTYPES = {"int8": (np.int8, 127), "int16": (np.int16, 1000),
                "int32": (np.int32, 100_000)}
# (batch, n_ext, n_int): tile multiples and ragged edges
SHAPES = [(1, 6, 5), (3, 13, 10), (8, 24, 16), (17, 37, 29)]
PARAMS = [(1, 15, 0), (2, 40, -5), (4, 0, 0), (1, -3, 2)]


def _case(b, n_ext, n_int, dtype, seed):
    rng = np.random.default_rng(seed)
    np_dt, wmax = PLANE_DTYPES[dtype]
    w = rng.integers(-wmax - 1, wmax + 1, (n_ext + n_int, n_int)).astype(np_dt)
    ext = (rng.random((b, n_ext)) < 0.3).astype(np.int32)
    prev = (rng.random((b, n_int)) < 0.4).astype(np.int32)   # recurrent
    v = rng.integers(-3000, 3000, (b, n_int)).astype(np.int32)
    return ext, prev, v, w


def _jax_step(ext, prev, v, w, params, block):
    s_all = jnp.asarray(np.concatenate([ext, prev], axis=1))
    out = jax_fused.fused_step(s_all, jnp.asarray(v), jnp.asarray(w),
                               JaxLIFIntParams(*params), block=block,
                               interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("dtype", list(PLANE_DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [None, (2, 8, 8)])
def test_fused_step_matches_reference(dtype, shape, block):
    i = SHAPES.index(shape)
    params = PARAMS[i]
    ext, prev, v, w = _case(*shape, dtype, seed=i)
    want = _jax_step(ext, prev, v, w, params, block)
    p = LIFIntParams(*params)
    args = [to_torch(ext), to_torch(prev), to_torch(v),
            torch.from_numpy(w)]
    got = fused_step_ref(*args, p)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), wnt)
    np.testing.assert_array_equal(args[2].numpy(), v)     # ref: v untouched
    # the wrapper on CPU tensors: v updated in place, outputs where asked
    s_out = torch.empty((shape[0], shape[2]), dtype=torch.int32)
    pkt_out = torch.empty((shape[0],), dtype=torch.int32)
    v_t, s_t, pkt_t = fused_step(*args, p, spikes_out=s_out, pkt_out=pkt_out)
    assert v_t is args[2] and s_t is s_out and pkt_t is pkt_out
    for g, wnt in zip((v_t, s_t, pkt_t), want):
        np.testing.assert_array_equal(g.numpy(), wnt)


@pytest.mark.parametrize("name", ["tiny", "shd"])
def test_pack_dense_matches_reference(name):
    path = GOLDEN / f"{name}_program_v1.npz"
    want = jax_fused.pack_dense(JaxProgram.load(path).lowered)
    got = pack_dense(TorchProgram.load(path).lowered)
    assert got.dtype == want.dtype == {"tiny": np.int8,
                                       "shd": np.int16}[name]
    assert got.weight.tobytes() == want.weight.tobytes()
    assert (got.n_neurons, got.n_internal, got.value_min, got.value_max) \
        == (want.n_neurons, want.n_internal, want.value_min, want.value_max)


@pytest.mark.parametrize("weights,dtype", [
    ([100, 100, -3], np.int16),      # two int8 ops fold past int8
    ([-128, 1, 5], np.int8),
    ([30000, 30000, 1], np.int32),   # fold past int16
])
def test_pack_dense_folds_duplicates(weights, dtype):
    lowered = types.SimpleNamespace(
        n_neurons=4, n_internal=3,
        op_pre=np.array([0, 0, 2], np.int32),
        op_post_local=np.array([1, 1, 0], np.int32),
        op_weight=np.array(weights, np.int32))
    want = jax_fused.pack_dense(lowered)
    got = pack_dense(lowered)
    assert got.dtype == want.dtype == dtype
    assert got.weight.tobytes() == want.weight.tobytes()
    assert (got.value_min, got.value_max) == (want.value_min, want.value_max)


def test_pack_dense_refusal_message(monkeypatch):
    lowered = TorchProgram.load(GOLDEN / "shd_program_v1.npz").lowered
    monkeypatch.setattr(jax_fused, "MAX_DENSE_BYTES", 1000)
    monkeypatch.setattr(torch_fused, "MAX_DENSE_BYTES", 1000)
    with pytest.raises(ValueError) as want:
        jax_fused.pack_dense(lowered)
    with pytest.raises(ValueError) as got:
        pack_dense(lowered)
    assert str(got.value) == str(want.value)
    assert "minimal safe dtype int16" in str(got.value)


def test_int16_split_into_bytes():
    """``256 * (s @ hi) + s @ lo == s @ W`` with ``hi = W >> 8`` (s8) and
    ``lo = W & 0xFF`` (u8): the arithmetic a tensor-core kernel on int8
    operands relies on for an int16 plane."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, (300, 40))
                         .astype(np.int16))
    s = torch.from_numpy((rng.random((9, 300)) < 0.5).astype(np.int64))
    hi, lo = w >> 8, w & 0xFF
    assert hi.min() >= -128 and hi.max() <= 127
    assert lo.min() >= 0 and lo.max() <= 255
    full = s @ w.to(torch.int64)
    assert torch.equal(256 * (s @ hi.to(torch.int64))
                       + s @ lo.to(torch.int64), full)


@pytest.mark.parametrize("chunk_bytes", [64, 4096, 64 * 2 ** 20])
def test_contract_int32_chunks(chunk_bytes):
    rng = np.random.default_rng(11)
    s = rng.integers(0, 2, (5, 70)).astype(np.int32)
    w = rng.integers(-255, 256, (70, 33)).astype(np.int16)
    got = contract_int32(to_torch(s), torch.from_numpy(w), chunk_bytes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), s.astype(np.int64) @ w)


@pytest.mark.parametrize("bad", ["s_prev", "weight_rows", "weight_dtype",
                                 "v_dtype", "pkt_out", "strided"])
def test_fused_step_rejects(bad):
    ext, prev, v = (to_torch(a) for a in _case(3, 5, 4, "int8", 0)[:3])
    w = torch.zeros((9, 4), dtype=torch.int8)
    kw = {}
    if bad == "s_prev":
        prev = torch.zeros((3, 5), dtype=torch.int32)
    elif bad == "weight_rows":
        w = torch.zeros((8, 4), dtype=torch.int8)
    elif bad == "weight_dtype":
        w = w.to(torch.float32)
    elif bad == "v_dtype":
        v = v.to(torch.int64)
    elif bad == "pkt_out":
        kw["pkt_out"] = torch.zeros((4,), dtype=torch.int32)
    else:
        ext = torch.zeros((5, 3), dtype=torch.int32).t()
    with pytest.raises(ValueError):
        fused_step(ext, prev, v, w, LIFIntParams(1, 1, 0), **kw)

