"""The port's LM training (``models.model.loss_fn``,
``train.steps.make_train_step``) against the JAX package, at reduced
size on the CPU.

The reference's ``init_model`` parameters are carried into the port by
``params_from_numpy``; tokens are numpy draws, labels the tokens (as
both launchers use them). ``loss_chunk`` = 10 with S = 24: the chunk
does not divide S, so the reference's decrement (to 8) is taken.

* With the parameters cast to float32: the loss within relative
  ``LOSS_RTOL`` = 1e-5 and every leaf's gradient within a relative norm
  of ``GRAD_RTOL`` = 1e-4 (``|g - g_ref| / |g_ref|``).
* With the models' bf16 parameters the two frameworks round bf16 at
  other points (``tests/test_torch_lm.py``), so each side is held to its
  own float32 run: the port's largest per-leaf gradient distance is no
  more than ``BF16_NOISE`` = 1.5 times the reference's. The loss is one
  scalar mean whose bf16 error is a few roundings cancelling at random;
  its distance gets the same rule plus 1e-3 relative. Beside that, the
  two bf16 runs are held to each other within ``BF16_LOSS_RTOL`` (5e-3
  relative) and ``BF16_GRAD_RTOL`` (0.1 relative norm per leaf): the
  bounds ``chip_smoke.py`` holds the card's bf16 step to the CPU's.
* ``remat`` changes no bit.
* Adam on the LM tree and whole train steps (3 steps, microbatches,
  int8 moments) against the reference's jitted step, float32.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import model as JM
from repro.optimizer.adam import adam_update as jax_adam_update
from repro.train.steps import TrainHParams as JaxTrainHParams
from repro.train.steps import _adam_cfg as jax_adam_cfg
from repro.train.steps import init_opt_state as jax_init_opt_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.kernels import _build
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import tree_map
from repro_torch.optimizer.adam import adam_update
from repro_torch.train.steps import (TrainHParams, _adam_cfg, init_opt_state,
                                     loss_and_grads, make_train_step)
from test_torch_lm import BF16_NOISE, f32, np_tree

NAMES = ["qwen2-1.5b", "stablelm-12b", "rwkv6-3b", "zamba2-7b"]
B, S, CHUNK = 2, 24, 10
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 5e-3, 0.1
# tests/test_torch_optimizer.py's bounds: parameters, first moments,
# second moments and scales
ADAM = {"p": dict(rtol=1e-6, atol=1e-7), "m": dict(rtol=1e-6, atol=1e-9),
        "v": dict(rtol=1e-6, atol=1e-12), "ms": dict(rtol=1e-6, atol=1e-12),
        "vs": dict(rtol=1e-6, atol=1e-12)}
# the whole-step comparison, float32 parameters after 3 Adam steps.
# Adam's first step moves each weight by lr * sign(g): where a gradient
# is within its rounding noise of 0 the two frameworks can take opposite
# signs, and that weight then differs by up to 2 lr a step (a key bias,
# whose gradient is mostly such noise, has 5-11 % of its elements so).
# With int8 moments a moment at a quantization level's edge can round to
# neighbouring levels, and a second moment that rounds to 0 on one side
# only makes that weight's update m / eps there: no bound per element.
# So: every element within 2 lr * steps with float32 moments, and at
# most STEP_OUTLIERS of the tree's elements outside STEP_TOL (measured:
# 0.1 % with float32 moments, 0.2 % with int8 after 3 steps)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_OUTLIERS = 5e-3


def flat(tree, path=""):
    """{"/a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = v
    return out


def rel_norm(got, want) -> float:
    g, w = f32(got), f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def worst_grad(got: dict, want: dict) -> float:
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    return max(rel_norm(got[k], want[k]) for k in want)


def batch_of(tokens: np.ndarray) -> tuple[dict, dict]:
    t = torch.from_numpy(tokens)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)},
            {"tokens": t, "labels": t})


def port_grads(np_params, cfg, batch, **hp):
    params = M.params_from_numpy(np_params, cfg, "cpu")
    loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                          TrainHParams(**hp))
    return float(loss), metrics, grads


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """The reference's loss and gradients of one reduced arch, with the
    parameters cast to float32 and in their own bf16."""
    name = request.param
    jcfg = jax_get_reduced(name)
    p16 = np_tree(JM.init_model(jcfg, jax.random.PRNGKey(0)))
    p32 = jax.tree.map(lambda a: a.astype(np.float32), p16)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = batch_of(tokens)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, loss_chunk=CHUNK)[0]))
    ref = {}
    for tag, p in (("32", p32), ("16", p16)):
        loss, grads = vg(jax.tree.map(jnp.asarray, p), jb)
        ref[tag] = (float(loss), np_tree(grads))
    return {"name": name, "cfg": get_reduced(name), "p32": p32, "p16": p16,
            "batch": tb, "ref": ref}


def test_f32_loss_and_grads_match_reference(case):
    loss, metrics, grads = port_grads(case["p32"], case["cfg"], case["batch"],
                                      loss_chunk=CHUNK)
    want_loss, want_grads = case["ref"]["32"]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert float(metrics["aux"]) == 0.0 and float(metrics["ce"]) == loss
    assert worst_grad(grads, want_grads) <= GRAD_RTOL
    assert all(g.dtype == torch.float32 for g in flat(grads).values())


def test_bf16_no_noisier_than_the_reference(case):
    cfg, batch = case["cfg"], case["batch"]
    l32, _, g32 = port_grads(case["p32"], cfg, batch, loss_chunk=CHUNK)
    l16, _, g16 = port_grads(case["p16"], cfg, batch, loss_chunk=CHUNK)
    (r32, rg32), (r16, rg16) = case["ref"]["32"], case["ref"]["16"]
    assert {k: g.dtype for k, g in flat(g16).items()} == {
        k: getattr(torch, np.asarray(g).dtype.name)
        for k, g in flat(rg16).items()}
    assert abs(l16 - l32) <= BF16_NOISE * abs(r16 - r32) + 1e-3 * abs(r32)
    assert worst_grad(g16, g32) <= BF16_NOISE * worst_grad(rg16, rg32)
    assert abs(l16 - r16) <= BF16_LOSS_RTOL * abs(r16)
    assert worst_grad(g16, rg16) <= BF16_GRAD_RTOL


@pytest.mark.parametrize("name", NAMES)
def test_remat_changes_no_bit(name):
    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tokens, "labels": tokens}
    runs = [loss_and_grads(params, cfg, batch,
                           TrainHParams(remat=remat, loss_chunk=CHUNK))
            for remat in (True, False)]
    (l1, _, g1), (l0, _, g0) = runs
    assert torch.equal(l1, l0)
    tree_map(lambda a, b: None if torch.equal(a, b) else pytest.fail(
        "remat changed a gradient"), g1, g0)


@pytest.mark.parametrize("chunk", [1, 5, 7, 24, 512])
def test_chunked_xent_matches_the_reference(chunk):
    jcfg, cfg = jax_get_reduced("stablelm-12b"), get_reduced("stablelm-12b")
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JM.init_model(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = float(JM.chunked_xent_loss(jax.tree.map(jnp.asarray, p), jcfg,
                                      jnp.asarray(hidden),
                                      jnp.asarray(labels), chunk))
    got = M.chunked_xent_loss(M.params_from_numpy(p, cfg, "cpu"), cfg,
                              torch.from_numpy(hidden),
                              torch.from_numpy(labels), chunk)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("quantized", [False, True])
def test_adam_on_the_lm_tree_matches_reference(quantized):
    """The port's adam_update on the reference's gradients of the
    reduced qwen2-1.5b (d_ff 256, so that int8 moments are used)."""
    jcfg = dataclasses.replace(jax_get_reduced("qwen2-1.5b"), d_ff=256)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JM.init_model(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jb, _ = batch_of(tokens)
    jp = jax.tree.map(jnp.asarray, p)
    grads = jax.grad(lambda q: JM.loss_fn(q, jcfg, jb)[0])(jp)
    hp = TrainHParams(lr=1e-2, quantized_opt_state=quantized)
    jhp = JaxTrainHParams(lr=1e-2, quantized_opt_state=quantized)
    js = jax_init_opt_state(jp, jhp)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    ts = init_opt_state(tp, hp)
    for _ in range(2):
        jp, js = jax_adam_update(grads, js, jp, jax_adam_cfg(jhp))
        tp, ts = adam_update(tree_map(lambda a: torch.from_numpy(
            np.array(a)), np_tree(grads)), ts, tp, _adam_cfg(hp))
    assert ts.step == int(js.step) == 2
    want = flat({"p": np_tree(jp), "m": np_tree(js.m), "v": np_tree(js.v)})
    got = flat({"p": tp, "m": ts.m, "v": ts.v})
    if quantized:
        assert any(t.dtype == torch.int8 for t in flat(ts.m).values())
        want.update(flat({"ms": np_tree(js.m_scale),
                          "vs": np_tree(js.v_scale)}))
        got.update(flat({"ms": ts.m_scale, "vs": ts.v_scale}))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                   **ADAM[k.split("/")[1]])


def _step_case(n_micro: int, quantized: bool):
    jcfg = dataclasses.replace(jax_get_reduced("qwen2-1.5b"), d_ff=256)
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), d_ff=256)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JM.init_model(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
               for _ in range(3)]
    kw = dict(n_micro=n_micro, quantized_opt_state=quantized, loss_chunk=8)
    return jcfg, cfg, p, batches, JaxTrainHParams(**kw), TrainHParams(**kw)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(n_micro, quantized):
    jcfg, cfg, p, batches, jhp, hp = _step_case(n_micro, quantized)
    jstep = jax.jit(jax_make_train_step(jcfg, None, jhp))
    jp = jax.tree.map(jnp.asarray, p)
    js = jax_init_opt_state(jp, jhp)
    tp = M.params_from_numpy(p, cfg, "cpu")
    ts = init_opt_state(tp, hp)
    step = make_train_step(cfg, None, hp)
    for tokens in batches:
        jb, tb = batch_of(tokens)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = step(tp, ts, tb)
        assert set(tm) == set(jm) == {"loss", "ce", "aux"}
        for k in tm:
            assert tm[k].dtype == torch.float32 and tm[k].ndim == 0
            assert abs(float(tm[k]) - float(jm[k])) <= \
                LOSS_RTOL * abs(float(jm[k])), k
    want, got, start = flat(np_tree(jp)), flat(tp), flat(p)
    n_out = n_all = 0
    for k, w in want.items():
        err = np.abs(f32(got[k]) - w)
        assert quantized or err.max() <= 2 * hp.lr * len(batches) * 1.001, k
        n_out += int((err > STEP_TOL["atol"]
                      + STEP_TOL["rtol"] * np.abs(w)).sum())
        n_all += w.size
        assert not np.array_equal(w, start[k]), k        # every leaf moved
    assert n_out <= STEP_OUTLIERS * n_all, n_out / n_all
    assert ts.step == int(js.step) == 3


def test_two_microbatches_give_one_batch_loss():
    _, cfg, p, batches, _, _ = _step_case(1, False)
    losses = []
    for n_micro in (1, 2):
        hp = TrainHParams(n_micro=n_micro, loss_chunk=8)
        params = M.params_from_numpy(p, cfg, "cpu")
        _, _, m = make_train_step(cfg, None, hp)(
            params, init_opt_state(params, hp), batch_of(batches[0])[1])
        losses.append(float(m["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])


def test_train_step_takes_no_sharding_rules():
    """A ruled train step runs on a ``DeviceMesh``: rules on the
    device-free production mesh (an ``AbstractMesh``, which lays out
    specs only) are refused. The ruled step itself is held to the plain
    step in ``tests/test_torch_ranks.py``."""
    from repro_torch.launch.mesh import make_production_mesh, make_rules
    with pytest.raises(ValueError, match="DeviceMesh"):
        make_train_step(get_reduced("qwen2-1.5b"),
                        make_rules(make_production_mesh()), TrainHParams())


def test_recurrences_route_to_the_chunked_form_under_autograd():
    """``use_kernel``: the CUDA kernel on a CUDA input only, and never
    where autograd records the call (stand-ins for card tensors)."""
    def t(cuda, grad):
        return types.SimpleNamespace(is_cuda=cuda, requires_grad=grad)
    assert L.use_kernel(True, t(True, False), t(True, False))
    assert not L.use_kernel(False, t(True, False))
    assert not L.use_kernel(True, t(False, False))
    assert not L.use_kernel(True, t(True, False), t(True, True))
    with torch.no_grad():
        assert L.use_kernel(True, t(True, False), t(True, True))
        _build.refuse_grad("wkv6", t(True, True))
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("wkv6", t(True, False), t(True, True))
