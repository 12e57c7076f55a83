"""The chunked tensor-core schedules of ``csrc/wkv6.cu`` and ``csrc/ssd.cu``,
replayed on the CPU (``wkv6_emulated``, ``ssd_emulated``), against the
JAX package: its Pallas kernels in interpret mode (as
``tests/test_wkv6_kernel.py`` and ``tests/test_ssd_kernel.py`` run them
on the CPU) and its models' chunked forms.

Inputs are made with numpy from a seed and fed to both packages; every
case but the first has a non-zero initial state. Lengths cover one
token, a chunk's sub-chunk boundaries (15, 16, 17) and ragged tails (37,
129). Tolerances as in ``test_torch_wkv6.py``: float32 inputs 2e-4
(the emulation sums in another order over a chunk and splits every
operand into three bf16 terms, which holds float32 whole), bf16 inputs
5e-2 (the derived operands keep two bf16 terms, y is rounded to bf16).
The strong-decay cases drive ``wkv6`` past its span threshold, where a
sub-chunk's scores are summed in log space, and ``ssd`` to decays of
e^-50 a token.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as jax_ssd
from repro.kernels import wkv6 as jax_wkv6
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro_torch.kernels.ssd import ssd_emulated
from repro_torch.kernels.ssm_chunks import (CHUNK, SUB, split_terms,
                                            tc_dot)
from repro_torch.kernels.wkv6 import wkv6_emulated, wkv6_routes

CHUNKED = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
SEQS = [1, 15, 16, 17, 37, 129]


def _wkv6_case(s, seed, decay="mild", state=True, b=2, h=3, n=16):
    """r, k, v, w_log, u, state0 as float32 numpy arrays. ``decay``:
    "mild" (w_log = -exp(N - 1)), "near_one" (about -e^-6, a model's
    initial decay) or "strong" (head 0 down to -40 a token)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    scale, shift = (0.5, 6.0) if decay == "near_one" else (1.0, 1.0)
    w = -np.exp(rng.standard_normal((b, s, h, n)) * scale - shift)
    if decay == "strong":
        w[:, :, 0] = -40.0 * rng.random((b, s, n))
    u = rng.standard_normal((h, n)) * 0.1
    st = (rng.standard_normal((b, h, n, n)) if state
          else np.zeros((b, h, n, n)))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, st))


def _ssd_case(s, seed, strong=False, b=2, h=3, p=8, n=16):
    """x, dt, a_log, b, c, state0 as float32 numpy arrays; ``strong``:
    exp(a_log) dt up to 50 a token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    if strong:
        dt = rng.random((b, s, h)) * 2.0
        a_log = np.log(np.linspace(1.0, 25.0, h))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
        a_log = np.log(np.arange(1, h + 1))
    bb, cc = (rng.standard_normal((b, s, n)) for _ in range(2))
    st = rng.standard_normal((b, h, p, n))
    return tuple(a.astype(np.float32) for a in (x, dt, a_log, bb, cc, st))


def _torch(arrays, io, dtype):
    return tuple(torch.from_numpy(a).to(dtype) if i in io
                 else torch.from_numpy(a) for i, a in enumerate(arrays))


def _jax(arrays, io, dtype):
    return tuple(jnp.asarray(a).astype(dtype) if i in io else jnp.asarray(a)
                 for i, a in enumerate(arrays))


WKV_IO, SSD_IO = (0, 1, 2), (0, 3, 4)


def _close(got, want, tol):
    for g, w in zip(got, want):
        g = g.to(torch.float32)
        assert bool(g.isfinite().all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **tol)


def _wkv6_both(case, dtype=torch.float32, jdtype=jnp.float32, tol=CHUNKED,
               chunked=True):
    got = wkv6_emulated(*_torch(case, WKV_IO, dtype))
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close(got, jax_wkv6(*_jax(case, WKV_IO, jdtype), chunk=16,
                         interpret=True), tol)
    if chunked:
        _close(got, jax_wkv6_chunked(*_jax(case, WKV_IO, jdtype)), tol)
    return got


def _ssd_both(case, dtype=torch.float32, jdtype=jnp.float32, tol=CHUNKED):
    got = ssd_emulated(*_torch(case, SSD_IO, dtype))
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close(got, jax_ssd(*_jax(case, SSD_IO, jdtype), chunk=16,
                        interpret=True), tol)
    _close(got, jax_ssd_chunked(*_jax(case, SSD_IO, jdtype)), tol)
    return got


@pytest.mark.parametrize("s", SEQS)
def test_wkv6_emulated_matches_pallas_and_chunked(s):
    _wkv6_both(_wkv6_case(s, seed=s, state=s != 1))


@pytest.mark.parametrize("s", SEQS)
def test_ssd_emulated_matches_pallas_and_chunked(s):
    _ssd_both(_ssd_case(s, seed=s))


@pytest.mark.parametrize("s", [17, 129])
def test_wkv6_emulated_bf16(s):
    _wkv6_both(_wkv6_case(s, seed=40 + s), torch.bfloat16, jnp.bfloat16,
               BF16)


@pytest.mark.parametrize("s", [17, 129])
def test_ssd_emulated_bf16(s):
    _ssd_both(_ssd_case(s, seed=40 + s), torch.bfloat16, jnp.bfloat16, BF16)


def test_wkv6_emulated_decay_near_one():
    """A model's initial decay (w_log near -e^-6): the state carries ~400
    tokens, so the factors stay near 1 and every block is factorized."""
    case = _wkv6_case(129, seed=7, decay="near_one")
    assert bool(wkv6_routes(torch.from_numpy(case[3])).all())
    _wkv6_both(case)
    _wkv6_both(case, torch.bfloat16, jnp.bfloat16, BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_emulated_strong_decay_takes_both_routes(dtype):
    """w_log down to -40 a token on head 0: its sub-chunks span more than
    SPAN_MAX and are summed in log space, the other heads' factorized;
    no factor overflows and nothing is inf or nan.

    In float32 the emulation is held to the Pallas kernel alone: the JAX
    chunked form takes exp of differences of running log-decays that
    reach -1300 over its 64-token chunk, and errs by 1.3e-3 against a
    float64 recurrence here (the emulation by 7e-5, the Pallas kernel by
    4e-6), above the 2e-4 the comparison allows."""
    case = _wkv6_case(129, seed=11, decay="strong")
    routes = wkv6_routes(torch.from_numpy(case[3]))
    n_chunks = -(-129 // CHUNK)
    assert tuple(routes.shape) == (2, 3, n_chunks, CHUNK // SUB)
    assert not bool(routes[:, 0, :2].any())       # head 0's full chunks
    assert bool(routes[:, 1:].all())
    if dtype == "float32":
        _wkv6_both(case, chunked=False)
    else:
        _wkv6_both(case, torch.bfloat16, jnp.bfloat16, BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_emulated_strong_decay(dtype):
    case = _ssd_case(129, seed=13, strong=True)
    if dtype == "float32":
        _ssd_both(case)
    else:
        _ssd_both(case, torch.bfloat16, jnp.bfloat16, BF16)


def test_emulated_empty_sequence_passes_the_state_through():
    w = _wkv6_case(1, seed=3)
    case = tuple(a[:, :0] if a.ndim == 4 and i < 4 else a
                 for i, a in enumerate(w))
    y, st = wkv6_emulated(*_torch(case, WKV_IO, torch.float32))
    assert y.shape == (2, 0, 3, 16) and torch.equal(st,
                                                    torch.from_numpy(w[5]))
    s = _ssd_case(1, seed=3)
    case = tuple(a[:, :0] if i in (0, 1, 3, 4) else a
                 for i, a in enumerate(s))
    y, st = ssd_emulated(*_torch(case, SSD_IO, torch.float32))
    assert y.shape == (2, 0, 3, 8) and torch.equal(st,
                                                   torch.from_numpy(s[5]))


def test_split_terms_and_tc_dot():
    """Three terms hold a float32 value whole; two hold it to 2^-16; the
    term product keeps the orders below the larger count."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64,)).astype(np.float32))
    three = split_terms(v, 3)
    assert torch.equal(three[0] + three[1] + three[2], v)
    two = split_terms(v, 2)
    assert float(((two[0] + two[1] - v).abs() / v.abs()).max()) <= 2 ** -16
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    got = tc_dot("ik,kj->ij", [a, 2 * a], [b, 3 * b])
    assert torch.equal(got, torch.full((2, 4), 3.0 * (1 + 2 + 3)))
