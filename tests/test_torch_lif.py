"""Parity of the port's integer LIF Neuron Unit with the JAX reference.

``repro_torch.snn.lif.lif_step_int`` and ``repro_torch.kernels.lif_update``
(``lif_update_int`` and its plain version ``lif_update_int_ref``) against
``repro.snn.lif.lif_step_int`` and ``repro.kernels.lif_update.lif_update_int``
(Pallas, interpret mode). Every comparison is bit-exact: tolerance 0.
Inputs come from numpy seeds and include negative potentials, where the
arithmetic shift matters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_update import lif_update_int as jax_lif_update_int
from repro.snn.lif import LIFIntParams as JaxLIFIntParams
from repro.snn.lif import leak_int as jax_leak_int
from repro.snn.lif import lif_step_int as jax_lif_step_int
from repro_torch.kernels.lif_update import lif_update_int, lif_update_int_ref
from repro_torch.snn.lif import LIFIntParams, leak_int, lif_step_int
from torch_parity import to_torch

SHAPES = [(9,), (1, 5), (3, 200), (16, 126), (17, 320)]
PARAMS = [(1, 15, 0), (2, 40, -5), (4, 0, 0), (2, -3, 2)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-5000, 5000, shape, dtype=np.int32),
            rng.integers(-300, 300, shape, dtype=np.int32))


def _jax_ref(v, cur, params):
    p = JaxLIFIntParams(*params)
    return (jax_lif_step_int(jnp.asarray(v), jnp.asarray(cur), p),
            jax_lif_update_int(jnp.asarray(v), jnp.asarray(cur), p,
                               interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("params", PARAMS)
def test_lif_matches_reference(shape, params):
    v, cur = _inputs(shape, seed=sum(shape) + params[0])
    (v_step, s_step), (v_kern, s_kern) = _jax_ref(v, cur, params)
    np.testing.assert_array_equal(np.asarray(v_step), np.asarray(v_kern))
    p = LIFIntParams(*params)
    tv, tc = to_torch(v), to_torch(cur)
    for fn in (lif_step_int, lif_update_int_ref, lif_update_int):
        v_t, s_t = fn(tv, tc, p)
        assert v_t.dtype == s_t.dtype == torch.int32, fn.__name__
        assert tuple(v_t.shape) == shape
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_kern))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_kern))
    np.testing.assert_array_equal(tv.numpy(), v)      # inputs untouched


@pytest.mark.parametrize("shift", [0, 1, 2, 4, 7, 31])
def test_leak_is_arithmetic_shift(shift):
    v = np.array([-2 ** 31, -65537, -9, -8, -7, -1, 0, 1, 7, 9,
                  2 ** 31 - 1], np.int32)
    want = np.asarray(jax_leak_int(jnp.asarray(v), shift))
    np.testing.assert_array_equal(leak_int(to_torch(v), shift).numpy(), want)


def test_lif_update_int_out_in_place():
    v, cur = _inputs((8, 320), seed=3)
    p = LIFIntParams(2, 15, -4)
    want_v, want_s = _jax_ref(v, cur, tuple(p))[1]
    tv, s_out = to_torch(v), torch.full((8, 320), 7, dtype=torch.int32)
    v_t, s_t = lif_update_int(tv, to_torch(cur), p, out=(tv, s_out))
    assert v_t is tv and s_t is s_out
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(s_out.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("bad", ["dtype", "shape", "ndim", "strided",
                                 "shift"])
def test_lif_update_int_rejects(bad):
    v = torch.zeros((4, 6), dtype=torch.int32)
    cur = torch.zeros_like(v)
    p = LIFIntParams(1, 1, 0)
    if bad == "dtype":
        cur = cur.to(torch.int64)
    elif bad == "shape":
        cur = torch.zeros((4, 5), dtype=torch.int32)
    elif bad == "ndim":
        v = cur = torch.zeros((2, 2, 6), dtype=torch.int32)
    elif bad == "strided":
        v = torch.zeros((6, 4), dtype=torch.int32).t()
    else:
        p = LIFIntParams(-1, 1, 0)
    with pytest.raises(ValueError):
        lif_update_int(v, cur, p)

