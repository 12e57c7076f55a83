"""The port's public kernel wrappers (``repro_torch/kernels/ops.py``)
against the reference's (``repro/kernels/ops.py``) in interpret mode,
and the core exports of item 10.

Inputs are made with numpy from a seed and fed to both packages, at the
shapes of ``tests/test_kernels.py`` (``spike_accum``, ``lif_update``,
``lif_update_int``) and the small cases of ``tests/test_wkv6_kernel.py``
and ``tests/test_ssd_kernel.py``. On the CPU each wrapper runs its plain
version. Integer paths are bit for bit; float paths take the tolerances
of the existing kernel parity tests: ``spike_accum`` float32 rtol = atol
= 1e-5 and bf16 rtol 2e-2 / atol 1e-2 (``tests/test_torch_spike_accum.py``),
the float LIF step rtol = atol = 1e-6 with spikes exact
(``tests/test_torch_lif.py``), ``wkv6`` / ``ssd`` float32 rtol = atol =
2e-5 and bf16 5e-2 (``tests/test_torch_wkv6.py``,
``tests/test_torch_ssd.py``). The tile keywords and ``interpret`` change
nothing on the CPU: every variant is bit for bit the default call.
``repro_torch.kernels.ref`` has the reference's ``spike_accum_ref`` and
``lif_update_ref``, and ``models.model.full_logits`` its ``remat=``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
from repro.kernels import ops as R
from repro.snn.lif import LIFIntParams as RefIntParams
import repro_torch.core as TC
from repro_torch.kernels import ops as T
from repro_torch.snn.lif import LIFIntParams

SPIKE_SHAPES = [(1, 7, 5), (3, 128, 128), (5, 300, 70), (8, 513, 257),
                (16, 1024, 116), (2, 784, 116)]
SPIKE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=1e-2)}
REC_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x, np.float32 if jnp.issubdtype(x.dtype, jnp.floating)
                      else x.dtype)


def _same(port: torch.Tensor, ref, tol: dict | None) -> None:
    if tol is None:
        np.testing.assert_array_equal(_np(port), _np(ref))
    else:
        np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _variants(fn, *args, tiles: dict, **kw):
    """The wrapper's default call, and the same with other tiles and
    with each ``interpret`` value: all bit for bit the same on the CPU."""
    want = fn(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    for extra in (tiles, {"interpret": True}, {"interpret": False},
                  {"interpret": None, **tiles}):
        got = fn(*args, **kw, **extra)
        got = got if isinstance(got, tuple) else (got,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), extra
    return want


@pytest.mark.parametrize("b,n_pre,n_post", SPIKE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_spike_accum(b, n_pre, n_post, dtype):
    rng = np.random.default_rng(b * 1000 + n_pre)
    s = (rng.random((b, n_pre)) < 0.25).astype(np.float32)
    if dtype == "int32":
        w = rng.integers(-7, 8, (n_pre, n_post)).astype(np.int32)
        js, jw = jnp.asarray(s, jnp.int32), jnp.asarray(w)
        ts, tw = torch.from_numpy(s).to(torch.int32), torch.from_numpy(w)
    else:
        w = rng.standard_normal((n_pre, n_post)).astype(np.float32)
        js = jnp.asarray(s, getattr(jnp, dtype))
        jw = jnp.asarray(w).astype(getattr(jnp, dtype))
        ts = torch.from_numpy(s).to(getattr(torch, dtype))
        tw = torch.from_numpy(w).to(getattr(torch, dtype))
    (got,) = _variants(T.spike_accum, ts, tw,
                       tiles=dict(block_b=16, block_pre=256, block_post=256))
    want = R.spike_accum(js, jw, interpret=True)
    assert got.shape == tuple(want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _same(got, want, SPIKE_TOL.get(dtype))


@pytest.mark.parametrize("shape", [(7,), (1, 5), (3, 200), (8, 1024),
                                   (13, 300)])
@pytest.mark.parametrize("alpha", [0.25, 0.03125, 0.5])
def test_lif_update(shape, alpha):
    rng = np.random.default_rng(17)
    v = rng.standard_normal(shape).astype(np.float32)
    cur = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    got = _variants(T.lif_update, torch.from_numpy(v), torch.from_numpy(cur),
                    alpha=alpha, v_th=1.0, v_reset=-0.25,
                    tiles=dict(block=(16, 256)))
    want = R.lif_update(jnp.asarray(v), jnp.asarray(cur), alpha=alpha,
                        v_th=1.0, v_reset=-0.25, interpret=True)
    _same(got[0], want[0], dict(rtol=1e-6, atol=1e-6))
    _same(got[1], want[1], None)


@pytest.mark.parametrize("shape", [(9,), (1, 5), (3, 200), (16, 126)])
@pytest.mark.parametrize("leak_shift", [1, 2, 4])
def test_lif_update_int(shape, leak_shift):
    rng = np.random.default_rng(23)
    v = rng.integers(-50, 50, shape).astype(np.int32)
    cur = rng.integers(-30, 30, shape).astype(np.int32)
    got = _variants(T.lif_update_int, torch.from_numpy(v),
                    torch.from_numpy(cur), LIFIntParams(leak_shift, 15, -3),
                    tiles=dict(block=(16, 256)))
    want = R.lif_update_int(jnp.asarray(v), jnp.asarray(cur),
                            RefIntParams(leak_shift, 15, -3), interpret=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        _same(a, b, None)


def _recurrence_inputs(kind, shape, dtype, seed):
    """float32 arrays, and the indices of those the dtype applies to."""
    rng = np.random.default_rng(seed)
    if kind == "wkv6":
        b, s, h, n = shape
        r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
                   for _ in range(3))
        w = -np.exp(rng.standard_normal((b, s, h, n)) - 1.0) \
            .astype(np.float32)
        u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
        st = rng.standard_normal((b, h, n, n)).astype(np.float32)
        return (r, k, v, w, u, st), {0, 1, 2}
    b, s, h, p, n = shape
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a_log, bm, cm, st), {0, 3, 4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,shape", [
    ("wkv6", (1, 8, 1, 8)), ("wkv6", (2, 37, 3, 8)),
    ("ssd", (1, 8, 1, 4, 8)), ("ssd", (2, 29, 3, 4, 8))])
def test_recurrences(kind, shape, dtype):
    arrays, low = _recurrence_inputs(kind, shape, dtype, seed=shape[1])
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype)) if i in low
             else jnp.asarray(a) for i, a in enumerate(arrays)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) if i in low
             else torch.from_numpy(a) for i, a in enumerate(arrays)]
    got = _variants(getattr(T, kind), *targs, tiles=dict(chunk=16))
    want = getattr(R, kind)(*jargs, chunk=8, interpret=True)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == torch.float32
    for a, b in zip(got, want):
        _same(a, b, REC_TOL[dtype])


def test_engines_and_kernels_exported():
    assert {"ENGINES", "KERNELS"} <= set(TC.__all__)
    assert TC.KERNELS == RC.KERNELS
    # the reference's compiled engine "jax" is the port's "torch"
    assert TC.ENGINES == tuple("torch" if e == "jax" else e
                               for e in RC.ENGINES)
    assert {"ENGINES", "KERNELS"} <= set(RC.__all__)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_kernels_ref_has_the_references_names(dtype):
    """``repro_torch.kernels.ref`` exports the reference's oracles by its
    names (defined beside their kernels): the same values on the same
    inputs, integer bit for bit, float32 within 1e-6."""
    from repro.kernels import ref as RR
    from repro_torch.kernels.ref import lif_update_ref, spike_accum_ref
    rng = np.random.default_rng(11)
    s = (rng.random((4, 33)) < 0.3).astype(np.float32)
    w = (rng.integers(-50, 50, (33, 7)) if dtype == "int32"
         else rng.standard_normal((33, 7))).astype(dtype)
    got = spike_accum_ref(torch.from_numpy(s), torch.from_numpy(w))
    want = np.asarray(RR.spike_accum_ref(jnp.asarray(s), jnp.asarray(w)))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    v = rng.standard_normal(64).astype(np.float32)
    cur = rng.standard_normal(64).astype(np.float32)
    got = lif_update_ref(torch.from_numpy(v), torch.from_numpy(cur), 0.2,
                         0.5, 0.0)
    want = RR.lif_update_ref(jnp.asarray(v), jnp.asarray(cur), 0.2, 0.5, 0.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)


def test_full_logits_takes_the_references_remat():
    """``full_logits(..., remat=True)`` as the reference's: the same bits
    as ``remat=False`` in the port (logits and every gradient), and the
    reference's logits within float32's 1e-5 (its parameters carried
    across in float32)."""
    import jax
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import model as JM
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    jcfg, cfg = jax_get_reduced("qwen2-1.5b"), get_reduced("qwen2-1.5b")
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JM.init_model(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(JM.full_logits(jax.tree.map(jnp.asarray, p), jcfg,
                                     jnp.asarray(tokens), remat=True)[0])
    out = []
    for remat in (True, False):
        params = {k: v for k, v in M.params_from_numpy(p, cfg, "cpu").items()}
        leaves = [params["embed"].requires_grad_(),
                  params["layers"]["attn"]["wq"].requires_grad_()]
        logits, _ = M.full_logits(params, cfg, torch.from_numpy(tokens),
                                  remat=remat)
        out.append((logits.detach(), torch.autograd.grad(
            logits.square().sum(), leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    np.testing.assert_allclose(out[0][0].numpy(), want, rtol=1e-5, atol=1e-5)
