"""Parity of the port's ``spike_accum`` with the JAX reference.

``repro_torch.kernels.spike_accum`` (``spike_accum`` on CPU tensors,
which runs its plain version, and ``spike_accum_ref``) against
``repro.kernels.spike_accum.spike_accum`` (Pallas, interpret mode) and
``repro.kernels.ref.spike_accum_ref``, over the shapes and dtypes of
``tests/test_kernels.py`` with its tolerances: float32 rtol = atol =
1e-5 (another summation order), bfloat16 rtol 2e-2 / atol 1e-2, int32
exact. The all-zero-but-one tile case is exact. The autograd wrapper's
gradients are held against ``jax.vjp`` of the reference's ``src @ w``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import spike_accum_ref as jax_spike_accum_ref
from repro.kernels.spike_accum import spike_accum as jax_spike_accum
from repro_torch.kernels import spike_accum as exported
from repro_torch.kernels.spike_accum import (SpikeAccumFn, spike_accum,
                                             spike_accum_ref)

SHAPES = [(1, 7, 5), (3, 128, 128), (5, 300, 70), (8, 513, 257),
          (16, 1024, 116), (2, 784, 116)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def _inputs(b, n_pre, n_post, dtype, seed):
    """The same inputs for both packages: numpy arrays, then each
    framework's tensor of ``dtype`` (bf16 rounded from float32 by both)."""
    rng = np.random.default_rng(seed)
    s = (rng.random((b, n_pre)) < 0.25).astype(np.float32)
    if dtype == "int32":
        w = rng.integers(-7, 8, (n_pre, n_post)).astype(np.int32)
        return ((jnp.asarray(s, jnp.int32), jnp.asarray(w)),
                (torch.from_numpy(s).to(torch.int32), torch.from_numpy(w)))
    w = rng.standard_normal((n_pre, n_post)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ((jnp.asarray(s).astype(jdt), jnp.asarray(w).astype(jdt)),
            (torch.from_numpy(s).to(tdt), torch.from_numpy(w).to(tdt)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy() if t.is_floating_point() \
        else t.numpy()


@pytest.mark.parametrize("b,n_pre,n_post", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_spike_accum_matches_reference(b, n_pre, n_post, dtype):
    (js, jw), (ts, tw) = _inputs(b, n_pre, n_post, dtype,
                                 seed=b * 1000 + n_pre)
    if dtype == "bfloat16":                 # the same bf16 bits went in
        np.testing.assert_array_equal(
            np.asarray(jw).view(np.uint16), tw.view(torch.int16).numpy()
            .view(np.uint16))
    want = np.asarray(jax_spike_accum(js, jw, interpret=True), np.float32
                      if dtype != "int32" else np.int32)
    want_ref = np.asarray(jax_spike_accum_ref(js, jw))
    for fn in (spike_accum, spike_accum_ref):
        got = fn(ts, tw)
        assert got.dtype == (torch.int32 if dtype == "int32"
                             else torch.float32), fn.__name__
        assert tuple(got.shape) == (b, n_post)
        for ref in (want, want_ref):
            if dtype == "int32":
                np.testing.assert_array_equal(_np(got), ref)
            else:
                np.testing.assert_allclose(_np(got), ref.astype(np.float32),
                                           **TOL[dtype])


def test_zero_tile_skip_is_exact():
    """All-zero pre tiles contribute exactly nothing."""
    rng = np.random.default_rng(2)
    s = np.zeros((8, 512), np.float32)
    s[0, 300] = 1.0                          # a single live tile
    w = rng.standard_normal((512, 128)).astype(np.float32)
    want = np.asarray(jax_spike_accum(jnp.asarray(s), jnp.asarray(w),
                                      interpret=True))
    got = spike_accum(torch.from_numpy(s), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], w[300])
    assert np.abs(got[1:]).max() == 0.0


def test_int32_wraps_as_the_reference():
    """int32 sums past 2**31 wrap, as the reference's int32 dot does."""
    s = np.ones((2, 4), np.int32)
    w = np.full((4, 3), 2 ** 30, np.int32)
    want = np.asarray(jax_spike_accum_ref(jnp.asarray(s), jnp.asarray(w)))
    got = spike_accum(torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].item() == 0                        # 4 * 2**30 mod 2**32


@pytest.mark.parametrize("n_pre,n_post", [(40, 24), (300, 20)])
def test_autograd_matches_jax_vjp(n_pre, n_post):
    rng = np.random.default_rng(n_pre)
    s = (rng.random((5, n_pre)) < 0.3).astype(np.float32)
    w = rng.standard_normal((n_pre, n_post)).astype(np.float32)
    g = rng.standard_normal((5, n_post)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: a @ b, jnp.asarray(s), jnp.asarray(w))
    want_s, want_w = vjp(jnp.asarray(g))
    ts = torch.from_numpy(s).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = SpikeAccumFn.apply(ts, tw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "ndim",
                                 "strided"])
def test_spike_accum_rejects(bad):
    s = torch.zeros((4, 6))
    w = torch.zeros((6, 3))
    if bad == "dtype":
        s, w = s.double(), w.double()
    elif bad == "mixed":
        s = s.to(torch.int32)
    elif bad == "shape":
        w = torch.zeros((5, 3))
    elif bad == "ndim":
        s = torch.zeros((2, 4, 6))
    else:
        w = torch.zeros((3, 6)).t()
    with pytest.raises(ValueError):
        spike_accum(s, w)


def test_package_exports_the_function():
    assert exported is spike_accum and hasattr(spike_accum, "launches")
