"""The port's Mamba-2 SSD against the JAX package: ``ssd_ref`` (the
token loop over ``ssd_step``), ``ssd_chunked``, ``ssd_step`` and the
``ssd`` wrapper's CPU path.

Inputs are made with numpy from a seed and fed to both packages. The
JAX side runs its model's ``ssd_step`` loop (as
``tests/test_ssd_kernel.py`` does), its chunked form and its Pallas
kernel in interpret mode. Tolerances as in ``test_torch_wkv6.py``:
sequential float32 forms 2e-5, the chunked form 2e-4, bf16 inputs 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as jax_ssd
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_step as jax_ssd_step
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssd import ssd
from repro_torch.models.mamba2 import ssd_chunked, ssd_step

TIGHT = dict(rtol=2e-5, atol=2e-5)
CHUNKED = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _case(b, s, h, p, n, seed=0, state=False):
    """x, dt, a_log, b, c, state0 as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32) if state
          else np.zeros((b, h, p, n), np.float32))
    return x, dt, a_log, bb, cc, st


def _torch(arrays, dtype=torch.float32):
    """x, b, c in ``dtype``; dt, a_log, state float32."""
    x, dt, a_log, b, c, st = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, a_log, b.to(dtype), c.to(dtype), st


def _jax(arrays, dtype=jnp.float32):
    x, dt, a_log, b, c, st = (jnp.asarray(a) for a in arrays)
    return x.astype(dtype), dt, a_log, b.astype(dtype), c.astype(dtype), st


def _jax_stepwise(x, dt, a_log, b, c, st):
    ys = []
    for t in range(x.shape[1]):
        y, st = jax_ssd_step(x[:, t], dt[:, t], a_log, b[:, t], c[:, t], st)
        ys.append(y)
    return jnp.stack(ys, axis=1), st


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("b,s,h,p,n", [(1, 8, 1, 4, 8), (2, 29, 3, 4, 8),
                                       (1, 64, 2, 16, 16)])
def test_ssd_ref_matches_reference_stepwise(b, s, h, p, n):
    case = _case(b, s, h, p, n)
    y, st = ssd_ref(*_torch(case))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close((y, st), _jax_stepwise(*_jax(case)), TIGHT)


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_ssd_chunked_matches_reference(chunk):
    case = _case(2, 29, 3, 4, 8, seed=1)         # 29: not chunk-aligned
    got = ssd_chunked(*_torch(case), chunk=chunk)
    _close(got, jax_ssd_chunked(*_jax(case), chunk=chunk), CHUNKED)
    _close(got, _jax_stepwise(*_jax(case)), CHUNKED)


def test_ssd_matches_pallas_kernel_in_interpret_mode():
    case = _case(2, 29, 3, 4, 8, seed=2, state=True)
    want = jax_ssd(*_jax(case), chunk=8, interpret=True)
    _close(ssd(*_torch(case)), want, TIGHT)
    _close(ssd_chunked(*_torch(case)), want, CHUNKED)


def test_ssd_bf16_inputs():
    case = _case(1, 16, 2, 4, 8, seed=5)
    want = jax_ssd(*_jax(case, jnp.bfloat16), chunk=8, interpret=True)
    for got in (ssd_ref(*_torch(case, torch.bfloat16)),
                ssd_chunked(*_torch(case, torch.bfloat16))):
        assert got[0].dtype == torch.bfloat16
        _close(got, want, BF16)


def test_ssd_nonzero_initial_state():
    case = _case(2, 12, 2, 4, 8, seed=7, state=True)
    want = _jax_stepwise(*_jax(case))
    _close(ssd_ref(*_torch(case)), want, TIGHT)
    _close(ssd_chunked(*_torch(case), chunk=6), want, CHUNKED)
    _close(ssd_chunked(*_torch(case), chunk=6),
           jax_ssd_chunked(*_jax(case), chunk=6), CHUNKED)


def test_ssd_step_matches_reference():
    case = _case(2, 3, 3, 4, 8, seed=3, state=True)
    x, dt, a_log, b, c, st = _torch(case)
    jx, jdt, ja, jb, jc, jst = _jax(case)
    for t in range(x.shape[1]):
        y, st = ssd_step(x[:, t], dt[:, t], a_log, b[:, t], c[:, t], st)
        jy, jst = jax_ssd_step(jx[:, t], jdt[:, t], ja, jb[:, t], jc[:, t],
                               jst)
        _close((y, st), (jy, jst), TIGHT)


def test_ssd_cpu_wrapper_is_the_plain_version():
    case = _torch(_case(2, 29, 3, 4, 8, seed=4, state=True))
    before = ssd.launches
    got, want = ssd(*case), ssd_ref(*case)
    assert ssd.launches == before                    # nothing launched
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _bad(name):
    x, dt, a_log, b, c, st = _torch(_case(1, 4, 2, 4, 8))
    return {"state size": (x, dt, a_log, torch.zeros(1, 4, 12),
                           torch.zeros(1, 4, 12), torch.zeros(1, 2, 4, 12)),
            "head dim": (torch.zeros(1, 4, 2, 129), dt, a_log, b, c,
                         torch.zeros(1, 2, 129, 8)),
            "b dtype": (x, dt, a_log, b.to(torch.bfloat16), c, st),
            "dt dtype": (x, dt.to(torch.bfloat16), a_log, b, c, st),
            "a_log shape": (x, dt, a_log[:1], b, c, st),
            "state shape": (x, dt, a_log, b, c, st[:, :1]),
            "contiguous": (x, dt, a_log, b.transpose(1, 2).contiguous()
                           .transpose(1, 2), c, st),
            "device": (x, dt, a_log, b, c, st.to("meta"))}[name]


@pytest.mark.parametrize("name", ["state size", "head dim", "b dtype",
                                  "dt dtype", "a_log shape", "state shape",
                                  "contiguous", "device"])
def test_ssd_wrapper_rejects_bad_args(name):
    with pytest.raises(ValueError):
        ssd(*_bad(name))
