"""The port's serve step over static buffers, the step a CUDA graph
captures (``repro_torch.train.steps``), at reduced size on the CPU.

On the CPU the static-buffer step (``StaticServeStep``, which runs
``serve_step_into`` eagerly) stands in for the graph, which only the
card can capture (``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 7 replay it):

* 8 greedy tokens through it equal the plain ``make_serve_step`` loop
  bit for bit, tokens and every state leaf (tolerance 0);
* both give the greedy tokens of the reference's jitted serve step with
  the state donated (``jax.jit(serve_step, donate_argnums=(2,))``) on
  the same float32-cast parameters, and each step started from the
  reference's state gives its logits and state within the tolerance
  ``tests/test_torch_lm.py`` states for decode (rtol = atol = 2e-4;
  bf16 leaves one bf16 ulp), dtypes included: the static buffers hold
  each leaf in the dtype the step returns for it, so with float32
  parameters the recurrent leaves ``tm_x``/``cm_x`` (rwkv) and ``conv``
  (mamba) are float32, as the reference's and the plain step's are;
* with float32-cast parameters one step from a grown state gives the
  plain step's tokens and state, every leaf's dtype and bits equal;
* the warm-up leaves the live buffers untouched; a step past the
  capacity, a step over another params tree and a state of a shape not
  prepared raise; the graphed step raises on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.serve import _grow_cache as jax_grow_cache
from repro.models import model as JM
from repro.train.steps import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import model as M
from repro_torch.models.model import tree_map
from repro_torch.train.steps import (GraphedServeStep, StaticServeStep,
                                     make_graphed_serve_step,
                                     make_prefill_step, make_serve_step,
                                     serve_step_into, warm_serve_step)
from test_torch_lm import BF16_LEAF, F32, assert_same_state, f32, to_torch

NAMES = ["rwkv6-3b", "zamba2-7b"]
B, PROMPT, GEN = 2, 8, 8
CAP = PROMPT + GEN
CPU = torch.device("cpu")


def _prefilled(name, params=None):
    cfg = get_reduced(name)
    if params is None:
        params = M.init_model(cfg, torch.Generator().manual_seed(0), CPU)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))
    logits, st = make_prefill_step(cfg)(params, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    return cfg, params, tok, _grow_cache(cfg, st, B, CAP, CPU)


def _chain(step, params, tok, state, n=GEN):
    toks = []
    for _ in range(n):
        tok, state = step(params, tok.reshape(B, 1), state)
        toks.append(tok.clone())
    return torch.stack(toks), state


def _assert_bits_equal(a: dict, b: dict) -> None:
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
             a, b)


@pytest.mark.parametrize("name", NAMES)
def test_static_step_equals_the_plain_step(name):
    cfg, params, tok, grown = _prefilled(name)
    want, st_plain = _chain(make_serve_step(cfg), params, tok,
                            tree_map(torch.clone, grown))
    step = StaticServeStep(cfg, params, "cpu")
    assert step.precompile(B, CAP) and not step.precompile(B, CAP)
    got, st_static = _chain(step, params, tok, tree_map(torch.clone, grown))
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    _assert_bits_equal(st_static, st_plain)
    assert int(st_static["len"]) == CAP
    assert step._shapes[(B, CAP)].length == CAP
    assert step.last_logits.shape == (B, 1, cfg.vocab_size)


@pytest.fixture(scope="module", params=NAMES)
def reference(request):
    """The reference's greedy chain through its jitted, donated serve
    step on float32-cast parameters, each step's state recorded."""
    name = request.param
    jcfg = jax_get_reduced(name)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       JM.init_model(jcfg, jax.random.PRNGKey(0)))
    params = jax.tree.map(jnp.asarray, p32)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    logits, st = jax.jit(JM.prefill, static_argnums=1)(
        params, jcfg, jnp.asarray(prompt))
    st = jax_grow_cache(jcfg, st, B, CAP)
    serve = jax.jit(jax_make_serve_step(jcfg, None), donate_argnums=(2,))
    decode = jax.jit(JM.decode_step, static_argnums=1)

    def copy(tree):                                 # st is donated below
        return jax.tree.map(np.array, tree)

    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    steps, toks = [], []
    for _ in range(GEN):
        before = copy(st)
        lg, after = decode(params, jcfg, tok[:, None],
                           jax.tree.map(jnp.asarray, before))
        steps.append((np.array(tok), before, np.asarray(lg), copy(after)))
        tok, st = serve(params, tok[:, None], st)   # st donated
        toks.append(np.asarray(tok))
    return name, p32, np.stack(toks), steps


def test_static_and_plain_steps_give_the_reference_tokens(reference):
    name, p32, want, _ = reference
    cfg = get_reduced(name)
    params = M.params_from_numpy(p32, cfg, "cpu")
    _, _, tok, grown = _prefilled(name, params)
    plain, _ = _chain(make_serve_step(cfg), params, tok,
                      tree_map(torch.clone, grown))
    step = StaticServeStep(cfg, params, "cpu")
    step.precompile(B, CAP)
    static, _ = _chain(step, params, tok, tree_map(torch.clone, grown))
    np.testing.assert_array_equal(static.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_static_step_from_the_reference_state(reference):
    """Each step copies the reference's state in (a foreign tree), runs,
    and matches the reference's step's logits and state."""
    name, p32, _, steps = reference
    cfg = get_reduced(name)
    params = M.params_from_numpy(p32, cfg, "cpu")
    step = StaticServeStep(cfg, params, "cpu")
    step.precompile(B, CAP)
    for tok, before, want_lg, want_st in steps:
        nxt, st = step(params, torch.from_numpy(tok[:, None]),
                       to_torch(before))
        np.testing.assert_allclose(f32(step.last_logits), want_lg, **F32)
        assert_same_state(st, want_st)
        assert st is step._shapes[(B, CAP)].state
        assert step._shapes[(B, CAP)].length == int(want_st["len"])
    assert BF16_LEAF["rtol"] == 2 ** -7            # the stated tolerance


@pytest.mark.parametrize("name", NAMES)
def test_static_step_keeps_the_float32_leaves_of_float32_params(name):
    """With float32-cast parameters the plain step returns the bf16
    recurrent leaves of the grown state as float32; one static step from
    the same grown state returns the same dtypes and bits."""
    cfg = get_reduced(name)
    params = tree_map(lambda a: a.float() if a.is_floating_point() else a,
                      M.init_model(cfg, torch.Generator().manual_seed(0),
                                   CPU))
    _, _, tok, grown = _prefilled(name, params)
    want_tok, want = make_serve_step(cfg)(params, tok.reshape(B, 1),
                                          tree_map(torch.clone, grown))
    step = StaticServeStep(cfg, params, "cpu")
    step.precompile(B, CAP)
    got_tok, got = step(params, tok.reshape(B, 1),
                        tree_map(torch.clone, grown))
    assert torch.equal(got_tok, want_tok)
    leaf = (("rwkv", "cm_x") if cfg.family == "ssm" else ("mamba", "conv"))
    assert grown[leaf[0]][leaf[1]].dtype == torch.bfloat16
    assert want[leaf[0]][leaf[1]].dtype == torch.float32

    def same(a, b):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    tree_map(same, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_warm_up_leaves_the_live_buffers_untouched(name):
    cfg, params, tok, grown = _prefilled(name)
    live = tree_map(torch.clone, grown)
    next_tok = tok.clone()
    tokens = next_tok.view(B, 1)
    warm_serve_step(cfg, params, tokens, live, next_tok)
    _assert_bits_equal(live, grown)
    assert torch.equal(next_tok, tok)
    serve_step_into(cfg, params, tokens, live, next_tok)   # a real step
    assert int(live["len"]) == PROMPT + 1                  # does write
    assert not torch.equal(next_tok, tok) or any(
        not torch.equal(a, b) for a, b in zip(
            _leaves(live), _leaves(grown)))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_step_past_capacity_raises_before_it_runs(name):
    cfg, params, tok, grown = _prefilled(name)
    step = StaticServeStep(cfg, params, "cpu")
    step.precompile(B, CAP)
    toks, st = _chain(step, params, tok, tree_map(torch.clone, grown))
    held = tree_map(torch.clone, st)
    with pytest.raises(ValueError, match="past capacity"):
        step(params, toks[-1].reshape(B, 1), st)
    _assert_bits_equal(st, held)                   # nothing ran
    # a fresh state copied in starts over from its own len
    again, _ = _chain(step, params, tok, tree_map(torch.clone, grown), 1)
    assert torch.equal(again[0], toks[0])


@pytest.mark.parametrize("name", NAMES)
def test_other_params_tree_and_unprepared_shapes_raise(name):
    cfg, params, tok, grown = _prefilled(name)
    step = StaticServeStep(cfg, params, "cpu")
    with pytest.raises(ValueError, match="precompile"):
        step(params, tok.reshape(B, 1), grown)     # no shape prepared
    step.precompile(B, CAP)
    with pytest.raises(ValueError, match="another params tree"):
        step(dict(params), tok.reshape(B, 1), grown)
    with pytest.raises(ValueError, match="tokens shape"):
        step(params, tok, grown)                   # [B], not [B, 1]
    small = M.init_decode_state(cfg, 1, CAP, CPU)
    with pytest.raises(ValueError, match="precompile"):
        step(params, tok[:1].reshape(1, 1), small)  # batch 1: not prepared


@pytest.mark.parametrize("name", NAMES)
def test_graphed_step_raises_on_the_cpu(name, monkeypatch):
    cfg, params, _, _ = _prefilled(name)
    with pytest.raises(RuntimeError, match="runs on the card"):
        make_graphed_serve_step(cfg, params, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphedServeStep(cfg, params)              # None is the card
