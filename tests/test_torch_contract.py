"""The redesigned contraction kernels' decompositions, on the CPU.

``csrc/fused_step.cu`` and ``csrc/spike_accum.cu`` split the pre axis
over a thread-block cluster, skip dead K-steps, run their products on
the tensor cores as byte planes (``fused_step``) or three bf16 terms
(float32 ``spike_accum``) and route the K-steps those cannot hold
exactly to CUDA-core products. The kernels run only on the card; here
their plain-torch emulations (``fused_step_emulated``,
``spike_accum_emulated``), the packed plane and the bf16 split are held
against the JAX package: ``repro.kernels.fused_step.fused_step`` and
``repro.kernels.spike_accum.spike_accum`` in interpret mode. Integer
results are bit-exact (tolerance 0); float ``spike_accum`` within
``tests/test_kernels.py``'s tolerances (float32 rtol = atol = 1e-5,
bf16 rtol 2e-2 / atol 1e-2: another summation order). Inputs come from
numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spike_accum import spike_accum as jax_spike_accum
from repro_torch.kernels.contract import cluster_split, kstep_ranges
from repro_torch.kernels.fused_step import (fused_step, fused_step_emulated,
                                            pack_plane, unpack_plane)
from repro_torch.kernels.spike_accum import (spike_accum_emulated,
                                             split_bf16x3, splittable)
from repro_torch.snn.lif import LIFIntParams
from test_torch_fused_step import PARAMS, PLANE_DTYPES, SHAPES, _case, \
    _jax_step
from test_torch_spike_accum import SHAPES as ACCUM_SHAPES
from test_torch_spike_accum import TOL, _inputs, _np
from torch_parity import to_torch

# the SHD-scale artifact's plane (700 + 320 pre, 320 post) at the serving
# batch and past it: 32 K-steps over 8 ranks
SHD_FUSED = [(8, 700, 320), (17, 700, 320)]
# the SHD SRNN's planes at B = 32 and the MNIST SFNN's at B = 64
NET_SHAPES = [(32, 700, 300), (32, 300, 300), (32, 300, 20),
              (64, 784, 116), (64, 116, 10)]


@pytest.mark.parametrize("n_ksteps,want", [(0, 1), (1, 1), (5, 5), (8, 8),
                                           (22, 8), (32, 8), (100, 8)])
def test_cluster_split_covers_the_ksteps(n_ksteps, want):
    ranges = kstep_ranges(n_ksteps)
    assert cluster_split(n_ksteps) == len(ranges) == want
    assert ranges[0][0] == 0 and ranges[-1][1] == n_ksteps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [e - b for b, e in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("dtype", list(PLANE_DTYPES))
@pytest.mark.parametrize("shape", [(6, 5), (37, 29), (1020, 320), (64, 16)])
def test_pack_plane_reconstructs(dtype, shape):
    np_dt = PLANE_DTYPES[dtype][0]
    info = np.iinfo(np_dt)
    rng = np.random.default_rng(shape[0])
    w = rng.integers(info.min, info.max, shape, endpoint=True).astype(np_dt)
    w.flat[:4] = [info.min, info.max, -1, 0]       # the extremes
    packed = pack_plane(torch.from_numpy(w))
    n_all, n_int = shape
    assert packed.m_pad % 16 == 0 and packed.k_pad % 32 == 0
    assert packed.m_pad - 16 < n_int <= packed.m_pad
    assert packed.k_pad - 32 < n_all <= packed.k_pad
    assert all(t.is_contiguous() for t in packed.planes)
    if dtype == "int16":
        lo, hi = packed.planes
        assert lo.dtype == torch.uint8 and hi.dtype == torch.int8
        full = hi.to(torch.int64) * 256 + lo.to(torch.int64)
    else:
        (plane,) = packed.planes
        assert plane.dtype == torch.from_numpy(w).dtype
        full = plane.to(torch.int64)
    assert packed.kind == np.dtype(np_dt).itemsize
    np.testing.assert_array_equal(full[:n_int, :n_all].t().numpy(), w)
    assert not full[n_int:].any() and not full[:, n_all:].any()
    back = unpack_plane(packed)
    assert back.dtype == torch.from_numpy(w).dtype
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("dtype", list(PLANE_DTYPES))
@pytest.mark.parametrize("shape", SHAPES + SHD_FUSED)
def test_fused_emulation_matches_reference(shape, dtype, params):
    ext, prev, v, w = _case(*shape, dtype, seed=len(shape) + shape[0])
    want = _jax_step(ext, prev, v, w, params, None)
    got = fused_step_emulated(to_torch(ext), to_torch(prev), to_torch(v),
                              pack_plane(torch.from_numpy(w)),
                              LIFIntParams(*params))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), wnt)


@pytest.mark.parametrize("dtype", list(PLANE_DTYPES))
@pytest.mark.parametrize("shape", [(3, 13, 10), (9, 700, 320)])
def test_fused_non_binary_external_spikes(shape, dtype):
    """External spikes are any int32: the K-steps that hold one take exact
    products (2**20 times an int16 weight wraps past 2**31)."""
    ext, prev, v, w = _case(*shape, dtype, seed=5)
    rng = np.random.default_rng(6)
    odd = rng.random(ext.shape) < 0.05
    ext = np.where(odd, rng.choice([2, -1, 300, 2 ** 20], ext.shape), ext)
    ext = ext.astype(np.int32)
    params = (2, 40, -5)
    want = _jax_step(ext, prev, v, w, params, None)
    p = LIFIntParams(*params)
    packed = pack_plane(torch.from_numpy(w))
    got = fused_step_emulated(to_torch(ext), to_torch(prev), to_torch(v),
                              packed, p)
    v_t = to_torch(v)
    wrapped = fused_step(to_torch(ext), to_torch(prev), v_t, packed, p)
    for a, b, wnt in zip(got, wrapped, want):
        np.testing.assert_array_equal(a.numpy(), wnt)
        np.testing.assert_array_equal(b.numpy(), wnt)


def _floats_across_the_range(rng) -> np.ndarray:
    """float32 values of every exponent from 2^-149 to 2^127, both
    signs, random mantissas, and +-0, +-2^-100, the largest finite."""
    exps = np.repeat(np.arange(-149, 128), 40)
    mant = rng.random(exps.size) + 1.0
    x = np.ldexp(mant, exps).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], x.size).astype(np.float32)
    edges = [0.0, -0.0, 2.0 ** -100, -(2.0 ** -100), 2.0 ** 127 * 0.99,
             np.finfo(np.float32).max, 1.0, -1.0]
    return np.concatenate([x, np.asarray(edges, np.float32)])


def test_bf16_split_is_exact():
    x = _floats_across_the_range(np.random.default_rng(0))
    w = torch.from_numpy(x)
    hi, mid, lo = split_bf16x3(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    ok = splittable(w)
    a = np.abs(x.astype(np.float64))
    np.testing.assert_array_equal(
        ok.numpy(), (x == 0) | ((a >= 2.0 ** -100) & (a < 2.0 ** 127)))
    assert ok.sum() > 0.7 * x.size
    np.testing.assert_array_equal(total[ok].numpy(), x[ok].astype(np.float64))
    # the sign of zero survives in hi
    zeros = torch.tensor([0.0, -0.0])
    assert torch.equal(torch.signbit(split_bf16x3(zeros)[0]),
                       torch.tensor([False, True]))
    # where the split holds, the terms are finite and shrink by >= 2^8
    for term in (hi, mid, lo):
        assert term.float()[ok].isfinite().all()
    big, small = hi.double()[ok].abs(), mid.double()[ok].abs()
    assert (small <= big * 2.0 ** -8).all()


def _check_accum(got, want, dtype):
    assert tuple(got.shape) == want.shape
    if dtype == "int32":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want.astype(np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("b,n_pre,n_post", ACCUM_SHAPES + NET_SHAPES)
def test_spike_accum_emulation_matches_reference(b, n_pre, n_post, dtype):
    (js, jw), (ts, tw) = _inputs(b, n_pre, n_post, dtype,
                                 seed=b * 1000 + n_pre)
    want = np.asarray(jax_spike_accum(js, jw, interpret=True))
    _check_accum(spike_accum_emulated(ts, tw), want, dtype)


@pytest.mark.parametrize("case", ["non_binary", "unsplittable", "dead"])
def test_spike_accum_emulation_routes(case):
    """The K-steps the bf16 split cannot hold take the multiply-add path:
    spikes outside {0, 1}; weights below 2^-100, past 2^127 or zero;
    and a batch with all-zero K-steps skips them exactly."""
    rng = np.random.default_rng(3)
    s = (rng.random((20, 300)) < 0.2).astype(np.float32)
    w = rng.standard_normal((300, 70)).astype(np.float32)
    if case == "non_binary":
        s[s > 0] = rng.choice([0.5, -2.0, 3.25], int((s > 0).sum()))
    elif case == "unsplittable":
        w[::7] *= np.float32(2.0 ** -110)
        w[5, 3] = np.float32(2.0 ** 127)
        w[40:45] = 0.0
        s[:, 5] = 1.0
    else:
        s[:, 32:160] = 0.0
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    if case == "unsplittable":
        assert not splittable(tw).all()
    want = np.asarray(jax_spike_accum(jnp.asarray(s), jnp.asarray(w),
                                      interpret=True))
    _check_accum(spike_accum_emulated(ts, tw), want, "float32")
