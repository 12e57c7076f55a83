"""Parity of the port's LIF Neuron Unit with the JAX reference.

Integer path: ``repro_torch.snn.lif.lif_step_int`` and
``repro_torch.kernels.lif_update`` (``lif_update_int`` and its plain
version ``lif_update_int_ref``) against ``repro.snn.lif.lif_step_int``
and ``repro.kernels.lif_update.lif_update_int`` (Pallas, interpret
mode). Every comparison is bit-exact: tolerance 0. Inputs come from numpy
seeds and include negative potentials, where the arithmetic shift
matters.

Float path: ``lif_update`` (its plain version on the CPU) and
``lif_update_ref`` against the JAX ``lif_update`` (interpret mode) at the
shapes and leaks of ``tests/test_kernels.py``, rtol = atol = 1e-6 for
potentials, spikes equal; ``spike_fn``'s three surrogates against
``jax.grad`` at rtol 1e-6; ``lif_step`` and the kernel's autograd
wrapper against ``jax.vjp`` of the reference ``lif_step`` at rtol 1e-6,
also with the recurrent layer's two current planes (``lif_step(v, a +
b)``), with an output's gradient absent (``None``), and the backward's
plain version ``lif_update_bwd_ref`` (and ``lif_update_bwd``, which runs
it on the CPU) against the same ``jax.vjp``: spikes equal, values and
gradients within rtol 1e-6 / atol 1e-7.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_update import lif_update as jax_lif_update
from repro.kernels.lif_update import lif_update_int as jax_lif_update_int
from repro.kernels.ref import lif_update_ref as jax_lif_update_ref
from repro.snn.lif import LIFIntParams as JaxLIFIntParams
from repro.snn.lif import LIFParams as JaxLIFParams
from repro.snn.lif import leak_int as jax_leak_int
from repro.snn.lif import lif_step as jax_lif_step
from repro.snn.lif import lif_step_int as jax_lif_step_int
from repro.snn.lif import spike_fn as jax_spike_fn
from repro_torch.kernels.lif_update import (LIFUpdateFn, lif_update,
                                            lif_update_bwd,
                                            lif_update_bwd_ref,
                                            lif_update_int,
                                            lif_update_int_ref,
                                            lif_update_ref)
from repro_torch.snn.lif import (LIFIntParams, LIFParams, alpha_to_shift,
                                 leak_int, lif_step, lif_step_int, spike_fn)
from torch_parity import to_torch

SURROGATES = ["relu", "sigmoid", "fast_sigmoid"]

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


# -- float path ----------------------------------------------------------------

def _float_inputs(shape, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(shape) * 2.0).astype(np.float32))


@pytest.mark.parametrize("shape", [(7,), (1, 5), (3, 200), (8, 1024),
                                   (13, 300)])
@pytest.mark.parametrize("alpha", [0.25, 0.03125, 0.5])
def test_lif_update_matches_reference(shape, alpha):
    v, cur = _float_inputs(shape)
    v_ref, s_ref = jax_lif_update(jnp.asarray(v), jnp.asarray(cur),
                                  alpha=alpha, v_th=1.0, v_reset=0.0,
                                  interpret=True)
    v_o, s_o = jax_lif_update_ref(jnp.asarray(v), jnp.asarray(cur), alpha,
                                  1.0, 0.0)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_o))
    tv, tc = torch.from_numpy(v), torch.from_numpy(cur)
    for got in (lif_update(tv, tc, alpha=alpha, v_th=1.0, v_reset=0.0),
                lif_update_ref(tv, tc, alpha, 1.0, 0.0)):
        assert got[0].dtype == got[1].dtype == torch.float32
        assert tuple(got[0].shape) == shape
        np.testing.assert_allclose(got[0].numpy(), np.asarray(v_ref),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(tv.numpy(), v)       # inputs untouched


def test_lif_update_reset_semantics():
    v = np.array([[0.5, 2.0, -1.0, 0.999]], np.float32)
    cur = np.zeros_like(v)
    want = jax_lif_update(jnp.asarray(v), jnp.asarray(cur), alpha=0.0,
                          v_th=1.0, v_reset=-0.25, interpret=True)
    tv = torch.from_numpy(v)
    s_out = torch.full_like(tv, 7.0)
    got = lif_update(tv, torch.from_numpy(cur), alpha=0.0, v_th=1.0,
                     v_reset=-0.25, out=(tv, s_out))    # in place
    assert got[0] is tv and got[1] is s_out
    np.testing.assert_allclose(tv.numpy()[0], [0.5, -0.25, -1.0, 0.999],
                               rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(s_out.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(s_out.numpy()[0], [0, 1, 0, 0])


@pytest.mark.parametrize("surrogate", SURROGATES)
def test_spike_fn_surrogate_grads_match_jax(surrogate):
    x = np.linspace(-1.5, 1.5, 61).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(61).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_spike_fn(a, surrogate), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = spike_fn(tx, surrogate)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _kernel_step(v, current, p, surrogate):
    """``LIFUpdateFn`` with one current plane, as ``lif_step`` is called."""
    return LIFUpdateFn.apply(v, current, None, p, surrogate)


@pytest.mark.parametrize("surrogate", SURROGATES)
@pytest.mark.parametrize("alpha,v_reset", [(0.25, 0.0), (0.03125, -0.2)])
def test_lif_step_and_kernel_grads_match_jax(surrogate, alpha, v_reset):
    """``lif_step`` (plain torch, autodiff) and ``LIFUpdateFn`` (the
    kernel with its hand-written backward) against ``jax.vjp`` of the
    reference ``lif_step``, potentials near the threshold included."""
    rng = np.random.default_rng(5)
    v = rng.uniform(-0.5, 1.5, (4, 50)).astype(np.float32)
    cur = rng.uniform(-0.5, 0.8, (4, 50)).astype(np.float32)
    gv, gs = (rng.standard_normal((4, 50)).astype(np.float32)
              for _ in range(2))
    p = (alpha, 1.0, v_reset)
    out, vjp = jax.vjp(lambda a, b: jax_lif_step(a, b, JaxLIFParams(*p),
                                                 surrogate),
                       jnp.asarray(v), jnp.asarray(cur))
    want_v, want_i = vjp((jnp.asarray(gv), jnp.asarray(gs)))
    assert 0 < float(np.asarray(out[1]).mean()) < 1
    for fn in (lif_step, _kernel_step):
        tv = torch.from_numpy(v).requires_grad_()
        tc = torch.from_numpy(cur).requires_grad_()
        v_next, s = fn(tv, tc, LIFParams(*p), surrogate)
        torch.autograd.backward((v_next, s), (torch.from_numpy(gv),
                                              torch.from_numpy(gs)))
        np.testing.assert_allclose(v_next.detach().numpy(),
                                   np.asarray(out[0]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(s.detach().numpy(), np.asarray(out[1]))
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want_v),
                                   rtol=1e-6, atol=1e-7, err_msg=fn.__name__)
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_i),
                                   rtol=1e-6, atol=1e-7, err_msg=fn.__name__)


def test_float_lif_rejects_and_shift():
    with pytest.raises(ValueError, match="unknown surrogate"):
        spike_fn(torch.zeros(3), "tanh")
    with pytest.raises(ValueError, match="dtype"):
        lif_update(torch.zeros(3, dtype=torch.float64),
                   torch.zeros(3, dtype=torch.float64), alpha=0.5)
    assert alpha_to_shift(0.25) == 2 and alpha_to_shift(0.03125) == 5


@pytest.mark.parametrize("surrogate", SURROGATES)
@pytest.mark.parametrize("alpha,v_reset", [(0.25, 0.0), (0.03125, -0.2)])
def test_two_current_lif_grads_match_jax(surrogate, alpha, v_reset):
    """``LIFUpdateFn`` given a current and a recurrent current against
    ``jax.vjp`` of the reference ``lif_step`` of their sum: the same
    spikes, the same ``v_next`` and gradients within rtol 1e-6 / atol
    1e-7, the sum's gradient reaching both planes; then the backward's
    plain version, alone, against the same ``vjp``."""
    rng = np.random.default_rng(11)
    v = rng.uniform(-0.5, 1.5, (5, 36)).astype(np.float32)
    a = rng.uniform(-0.5, 0.8, (5, 36)).astype(np.float32)
    b = rng.uniform(-0.4, 0.4, (5, 36)).astype(np.float32)
    # a few neurons exactly on the threshold: v on a grid of 2^-7, so
    # that (1 - alpha) v and 1 - (1 - alpha) v are exact in float32
    v[:, ::9] = rng.integers(-64, 192, v[:, ::9].shape) / 128.0
    b[:, ::9] = 0.0
    a[:, ::9] = np.float32(1.0) - np.float32(1.0 - alpha) * v[:, ::9]
    gv, gs = (rng.standard_normal((5, 36)).astype(np.float32)
              for _ in range(2))
    p = (alpha, 1.0, v_reset)
    out, vjp = jax.vjp(lambda x, c: jax_lif_step(x, c, JaxLIFParams(*p),
                                                 surrogate),
                       jnp.asarray(v), jnp.asarray(a + b))
    want_v, want_i = (np.asarray(g) for g in vjp((jnp.asarray(gv),
                                                   jnp.asarray(gs))))
    assert 0 < float(np.asarray(out[1]).mean()) < 1
    assert np.asarray(out[1])[:, ::9].all()     # on the threshold: spikes

    tv, ta, tb = (torch.from_numpy(x).requires_grad_() for x in (v, a, b))
    v_next, s = LIFUpdateFn.apply(tv, ta, tb, LIFParams(*p), surrogate)
    torch.autograd.backward((v_next, s), (torch.from_numpy(gv),
                                          torch.from_numpy(gs)))
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(out[1]))
    np.testing.assert_allclose(v_next.detach().numpy(), np.asarray(out[0]),
                               rtol=1e-6, atol=1e-7)
    for name, g, w in (("v", tv.grad, want_v), ("current", ta.grad, want_i),
                       ("current_rec", tb.grad, want_i)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)

    args = [torch.from_numpy(x) for x in (v, a, gv, gs)]
    for g_v, g_i in (lif_update_bwd_ref(*args, alpha, 1.0, surrogate,
                                        torch.from_numpy(b)),
                     lif_update_bwd(*args, alpha=alpha, v_th=1.0,
                                    surrogate=surrogate,
                                    current_rec=torch.from_numpy(b))):
        np.testing.assert_allclose(g_v.numpy(), want_v, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g_i.numpy(), want_i, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("surrogate", SURROGATES)
@pytest.mark.parametrize("missing", ["g_vnext", "g_s"])
@pytest.mark.parametrize("recurrent", [False, True])
def test_lif_grads_with_an_output_unused(surrogate, missing, recurrent):
    """Only one output of the step reaches the loss: autograd hands the
    backward ``None`` for the other (no zeros are made), and the
    gradients equal ``jax.vjp`` with a zero cotangent there, within rtol
    1e-6 / atol 1e-7; ``lif_update_bwd_ref`` given ``None`` agrees."""
    rng = np.random.default_rng(13)
    v = rng.uniform(-0.5, 1.5, (3, 40)).astype(np.float32)
    a = rng.uniform(-0.5, 0.8, (3, 40)).astype(np.float32)
    b = (rng.uniform(-0.4, 0.4, (3, 40)).astype(np.float32) if recurrent
         else np.zeros_like(a))
    g = rng.standard_normal((3, 40)).astype(np.float32)
    zero = np.zeros_like(g)
    cot = (zero, g) if missing == "g_vnext" else (g, zero)
    p = (0.25, 1.0, -0.1)
    _, vjp = jax.vjp(lambda x, c: jax_lif_step(x, c, JaxLIFParams(*p),
                                               surrogate),
                     jnp.asarray(v), jnp.asarray(a + b))
    want_v, want_i = (np.asarray(x) for x in vjp(tuple(jnp.asarray(c)
                                                       for c in cot)))
    tv, ta = (torch.from_numpy(x).requires_grad_() for x in (v, a))
    tb = torch.from_numpy(b).requires_grad_() if recurrent else None
    seen = []
    real_ref = lif_update_bwd_ref

    def spy(v_, c_, g_vnext, g_s, *rest):
        seen.append((g_vnext is None, g_s is None))
        return real_ref(v_, c_, g_vnext, g_s, *rest)

    mod = sys.modules[LIFUpdateFn.__module__]
    setattr(mod, "lif_update_bwd_ref", spy)
    try:
        v_next, s = LIFUpdateFn.apply(tv, ta, tb, LIFParams(*p), surrogate)
        used = s if missing == "g_vnext" else v_next
        inputs = (tv, ta) + ((tb,) if recurrent else ())
        grads = torch.autograd.grad(used, inputs, torch.from_numpy(g))
    finally:
        setattr(mod, "lif_update_bwd_ref", real_ref)
    assert seen == [(missing == "g_vnext", missing == "g_s")]
    for name, got, w in zip(("v", "current", "current_rec"), grads,
                            (want_v, want_i, want_i)):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    gt = torch.from_numpy(g)
    g_v, g_i = lif_update_bwd_ref(
        torch.from_numpy(v), torch.from_numpy(a),
        None if missing == "g_vnext" else gt,
        None if missing == "g_s" else gt, p[0], p[1], surrogate,
        torch.from_numpy(b) if recurrent else None)
    np.testing.assert_allclose(g_v.numpy(), want_v, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_i.numpy(), want_i, rtol=1e-6, atol=1e-7)
