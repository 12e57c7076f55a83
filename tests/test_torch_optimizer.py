"""Parity of the port's Adam with the JAX reference.

``repro_torch.optimizer.adam`` against ``repro.optimizer.adam`` on the
same numpy params and gradients over several steps. float32 moments:
params and moments at rtol 1e-6. int8 moments: the int8 arrays are
EQUAL (the same float operations round alike, and ``round`` is half to
even in both), scales and params at rtol 1e-6; entries whose last axis
the block does not divide stay float32 in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optimizer.adam import AdamConfig as JaxAdamConfig
from repro.optimizer.adam import adam_init as jax_adam_init
from repro.optimizer.adam import adam_update as jax_adam_update
from repro_torch.optimizer import AdamConfig, adam_init, adam_update

SHAPES = {"w0": (6, 16), "wr0": (16, 16), "w1": (16, 5), "b": (16,)}


def _run(cfg_kw, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    jcfg, cfg = JaxAdamConfig(**cfg_kw), AdamConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jax_adam_init(jp, jcfg), adam_init(tp, cfg)
    for g in grads:
        jp, js = jax_adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jcfg)
        before = {k: v.clone() for k, v in tp.items()}
        tp, ts = adam_update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp, cfg)
    for k, v in before.items():                  # functional: input kept
        assert not torch.equal(v, tp[k])
    return (jp, js), (tp, ts), steps


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_f32_matches_reference(weight_decay):
    (jp, js), (tp, ts), steps = _run(dict(lr=1e-2,
                                          weight_decay=weight_decay))
    assert ts.step == int(js.step) == steps
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)


def test_adam_int8_moments_match_reference():
    (jp, js), (tp, ts), _ = _run(dict(lr=1e-2, quantized_state=True,
                                      block=8))
    for k in SHAPES:
        quantized = SHAPES[k][-1] % 8 == 0
        assert (ts.m[k].dtype == torch.int8) == quantized, k
        assert ts.m_scale[k].numel() > 0 if quantized \
            else tuple(ts.m_scale[k].shape) == (0,)
        for got, want in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            if quantized:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12, err_msg=k)
        for got, want in ((ts.m_scale[k], js.m_scale[k]),
                          (ts.v_scale[k], js.v_scale[k]), (tp[k], jp[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-12, err_msg=k)
