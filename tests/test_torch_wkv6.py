"""The port's WKV-6 against the JAX package: ``wkv6_ref``,
``wkv6_chunked``, ``wkv6_step`` and the ``wkv6`` wrapper's CPU path.

Inputs are made with numpy from a seed and fed to both packages. The
JAX side runs its oracle, its model's chunked form and its Pallas kernel
in interpret mode (as ``tests/test_wkv6_kernel.py`` runs it on the CPU).
Tolerances: float32 sequential forms rtol = atol = 2e-5 (both sides sum
one token at a time; ``tests/test_wkv6_kernel.py``), the chunked form
2e-4 (another summation order over a chunk; ``tests/test_recurrent_cores.py``),
bf16 inputs 5e-2 (y is rounded to bf16 after float32 sums taken in
another order, one bf16 ulp is up to 2^-7 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wkv6 as jax_wkv6
from repro.kernels import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro.models.rwkv import wkv6_step as jax_wkv6_step
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.rwkv import wkv6_chunked, wkv6_step

TIGHT = dict(rtol=2e-5, atol=2e-5)
CHUNKED = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _case(b, s, h, n, seed=0, state=False):
    """r, k, v, w_log, u, state0 as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (-np.exp(rng.standard_normal((b, s, h, n)) - 1.0)).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)).astype(np.float32) if state
          else np.zeros((b, h, n, n), np.float32))
    return r, k, v, w, u, st


def _torch(arrays, dtype=torch.float32):
    """r, k, v in ``dtype``; w_log, u, state float32."""
    r, k, v, w, u, st = (torch.from_numpy(a) for a in arrays)
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u, st)


def _jax(arrays, dtype=jnp.float32):
    r, k, v, w, u, st = (jnp.asarray(a) for a in arrays)
    return (r.astype(dtype), k.astype(dtype), v.astype(dtype), w, u, st)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("b,s,h,n", [(1, 8, 1, 8), (2, 37, 3, 8),
                                     (2, 64, 2, 16), (1, 129, 4, 32)])
def test_wkv6_ref_matches_reference(b, s, h, n):
    case = _case(b, s, h, n)
    y, st = wkv6_ref(*_torch(case))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close((y, st), jax_wkv6_ref(*_jax(case)), TIGHT)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_wkv6_chunked_matches_reference(chunk):
    case = _case(2, 37, 3, 8, seed=1)            # 37: not chunk-aligned
    got = wkv6_chunked(*_torch(case), chunk=chunk)
    _close(got, jax_wkv6_chunked(*_jax(case), chunk=chunk), CHUNKED)
    _close(got, jax_wkv6_ref(*_jax(case)), CHUNKED)


def test_wkv6_matches_pallas_kernel_in_interpret_mode():
    case = _case(2, 37, 3, 8, seed=2, state=True)
    want = jax_wkv6(*_jax(case), chunk=16, interpret=True)
    _close(wkv6(*_torch(case)), want, TIGHT)
    _close(wkv6_chunked(*_torch(case)), want, CHUNKED)


def test_wkv6_bf16_inputs():
    case = _case(1, 16, 2, 8, seed=5)
    want = jax_wkv6(*_jax(case, jnp.bfloat16), chunk=8, interpret=True)
    for got in (wkv6_ref(*_torch(case, torch.bfloat16)),
                wkv6_chunked(*_torch(case, torch.bfloat16))):
        assert got[0].dtype == torch.bfloat16
        _close(got, want, BF16)


def test_wkv6_nonzero_initial_state():
    case = _case(2, 20, 2, 8, seed=7, state=True)
    want = jax_wkv6_ref(*_jax(case))
    _close(wkv6_ref(*_torch(case)), want, TIGHT)
    _close(wkv6_chunked(*_torch(case), chunk=8), want, CHUNKED)


def test_wkv6_step_matches_reference_and_loops_to_ref():
    case = _case(2, 5, 3, 8, seed=3, state=True)
    r, k, v, w, u, st = _torch(case)
    jr, jk, jv, jw, ju, jst = _jax(case)
    ys = []
    for t in range(r.shape[1]):
        y, st = wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, st)
        jy, jst = jax_wkv6_step(jr[:, t], jk[:, t], jv[:, t], jw[:, t], ju,
                                jst)
        _close((y, st), (jy, jst), TIGHT)
        ys.append(y)
    _close((torch.stack(ys, 1), st), wkv6_ref(*_torch(case)), TIGHT)


def test_wkv6_cpu_wrapper_is_the_plain_version():
    case = _torch(_case(2, 37, 3, 8, seed=4, state=True))
    before = wkv6.launches
    got, want = wkv6(*case), wkv6_ref(*case)
    assert wkv6.launches == before                   # nothing launched
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _bad(name):
    r, k, v, w, u, st = _torch(_case(1, 4, 2, 8))
    return {"head size": (torch.zeros(1, 4, 2, 12),) * 3
            + (torch.zeros(1, 4, 2, 12), torch.zeros(2, 12),
               torch.zeros(1, 2, 12, 12)),
            "k dtype": (r.to(torch.bfloat16), k, v.to(torch.bfloat16), w, u,
                        st),
            "w_log dtype": (r, k, v, w.double(), u, st),
            "u shape": (r, k, v, w, u[:1], st),
            "state shape": (r, k, v, w, u, st[:, :1]),
            "r rank": (r[0], k, v, w, u, st),
            "contiguous": (r.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, w, u, st),
            "device": (r, k, v, w.to("meta"), u, st)}[name]


@pytest.mark.parametrize("name", ["head size", "k dtype", "w_log dtype",
                                  "u shape", "state shape", "r rank",
                                  "contiguous", "device"])
def test_wkv6_wrapper_rejects_bad_args(name):
    with pytest.raises(ValueError):
        wkv6(*_bad(name))
