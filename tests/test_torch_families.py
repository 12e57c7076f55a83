"""The port's last four families against the JAX package, at reduced
size on the CPU: qwen3-moe-30b-a3b and deepseek-v3-671b (``moe``; MLA,
a shared expert and a leading dense stack on deepseek-v3),
musicgen-medium (``audio``: K codebooks, sinusoidal positions, LayerNorm,
the gelu MLP) and qwen2-vl-7b (``vlm``: M-RoPE).

The reference's ``init_model`` parameters are carried into the port by
``params_from_numpy``. The reduced MoE configs have E / k capacity, so
no route is dropped; every MoE case first asserts the port's routes
equal to the reference's (``assert_same_routes``), then compares values.
The layers alone (MLA, M-RoPE, the sinusoidal positions, the codebook
embedding and heads) are held in ``tests/test_torch_mla_mrope.py``.
Tolerances, as ``tests/test_torch_lm.py``, ``tests/test_torch_dense.py``
and ``tests/test_torch_lm_train.py`` state them:

* the whole model in float32 (logits with drawn M-RoPE streams, the
  aux loss, the prefill's logits and state, decode steps each from the
  reference's state, the greedy tokens): ``F32`` (rtol = atol = 2e-4);
  the loss within relative 1e-5 and every leaf's gradient within a
  relative norm of 1e-4;
* native bf16: no noisier than ``BF16_NOISE`` times the reference's own
  distance from float32; prefill + decode against the teacher-forced
  logits, and the reference's unrolled decode against the port's, within
  the reference's own 5e-2 / 4e-2 (``tests/test_lm_archs.py``);
* the static serve step equal to the plain step bit for bit, the
  unrolled decode to the stacked one; the full configs' trees on
  ``device="meta"`` the reference's (``jax.eval_shape``), their counts
  within 0.1 % of ``ArchConfig.n_params`` (which leaves out the norms).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.serve import _grow_cache as jax_grow_cache
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve, train
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.model import tree_map
from repro_torch.train.steps import (StaticServeStep, TrainHParams,
                                     loss_and_grads, make_prefill_step,
                                     make_serve_step)
from test_torch_dense import check_noise, jtree
from test_torch_lm import (F32, assert_same_state, f32, jax_chain, jax_full,
                           jax_prefill, np_tree, to_torch)
from test_torch_lm_train import GRAD_RTOL, LOSS_RTOL, worst_grad

NAMES = ["qwen3-moe-30b-a3b", "deepseek-v3-671b", "musicgen-medium",
         "qwen2-vl-7b"]
B, S, PROMPT, STEPS = 2, 12, 8, 4
CHUNK = 8
jax_init = jax.jit(JM.init_model, static_argnums=0)
# the full configs' parameter counts, billions (jax.eval_shape)
N_PARAMS = {"qwen3-moe-30b-a3b": 30.532, "deepseek-v3-671b": 671.026,
            "musicgen-medium": 1.384, "qwen2-vl-7b": 7.616}


def tokens_of(cfg, b=B, s=S, seed=0) -> np.ndarray:
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def mrope_streams(b, s) -> np.ndarray:
    """Three different (t, h, w) streams [3, B, S], so that each M-RoPE
    section reads its own."""
    t = np.arange(s)
    return np.broadcast_to(np.stack([t, t // 3, t % 5])[:, None],
                           (3, b, s)).astype(np.int32).copy()


def routes_by_layer(fn):
    """Run ``fn`` recording the top-k indices of every MoE layer the port
    computes (a wrapper around ``moe.route_topk``)."""
    seen, topk = [], MOE.route_topk

    def record(logits, k):
        w, idx = topk(logits, k)
        seen.append(idx.detach().clone())
        return w, idx
    MOE.route_topk = record
    try:
        out = fn()
    finally:
        MOE.route_topk = topk
    return out, seen


@functools.partial(jax.jit, static_argnums=1)
def jax_routes_by_layer(jparams, jcfg, tokens, positions=None):
    """The reference's top-k indices of every MoE layer of a train-mode
    forward, layer by layer (its own ops, run outside the scan)."""
    x = JM.embed_tokens(jparams, jcfg, tokens)
    pos = jnp.arange(tokens.shape[1]) if positions is None else positions
    out = []
    stacks = ([("dense_layers", False)] if jcfg.moe.n_dense_layers else []) \
        + [("layers", True)]
    for stack, moe_layer in stacks:
        tree = jparams[stack]
        n = jax.tree.leaves(tree)[0].shape[0]
        for i in range(n):
            lp = jax.tree.map(lambda a: a[i], tree)
            if moe_layer:
                h, _ = JM._attn(jcfg)(lp["attn"],
                                      JM._norm(lp["ln1"], x, jcfg), jcfg,
                                      positions=pos)
                xt = JM._norm(lp["ln2"], x + h, jcfg)
                xt = xt.reshape(1, -1, xt.shape[-1]).astype(jnp.float32)
                out.append(JMOE.route_topk(xt @ lp["moe"]["router"],
                                           jcfg.moe.top_k)[1])
            x, _, _ = JM._attn_mlp_block(lp, x, jcfg, positions=pos,
                                         moe_layer=moe_layer)
    return out


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """The reference's runs of one reduced arch, float32-cast and bf16."""
    name = request.param
    jcfg = jax_get_reduced(name)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    p16 = np_tree(params)
    p32 = jax.tree.map(lambda a: a.astype(np.float32), p16)
    j32 = jtree(p32)
    tokens = tokens_of(jcfg)
    pos = mrope_streams(B, S) if jcfg.mrope_sections else None
    jpos = None if pos is None else jnp.asarray(pos)
    run32 = jax_chain(j32, jcfg, tokens[:, :PROMPT])
    feed = [s[0] for s in run32["steps"]]
    full32, aux32 = jax_full(j32, jcfg, jnp.asarray(tokens), positions=jpos)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    if jpos is not None:
        batch["positions"] = jpos
    loss32, grads32 = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, loss_chunk=CHUNK)[0]))(j32, batch)
    return {
        "name": name, "jcfg": jcfg, "cfg": get_reduced(name),
        "tokens": tokens, "pos": pos, "p32": p32, "p16": p16,
        "full32": np.asarray(full32), "aux32": float(aux32),
        "full16": np.asarray(jax_full(params, jcfg, jnp.asarray(tokens),
                                      positions=jpos)[0]),
        "routes": (np_tree(jax_routes_by_layer(j32, jcfg,
                                               jnp.asarray(tokens), jpos))
                   if jcfg.moe else None),
        "loss32": float(loss32), "grads32": np_tree(grads32),
        "run32": run32,
        "run16": jax_chain(params, jcfg, tokens[:, :PROMPT], feed),
    }


def test_configs_are_the_references(case):
    cfg, jcfg = case["cfg"], case["jcfg"]
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert dataclasses.astuple(get_config(case["name"])) == \
        dataclasses.astuple(jax_get_config(case["name"]))


def test_f32_full_logits_aux_prefill_and_state(case):
    cfg, tokens = case["cfg"], torch.from_numpy(case["tokens"])
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    pos = None if case["pos"] is None else torch.from_numpy(case["pos"])
    (logits, aux), routes = routes_by_layer(
        lambda: M.full_logits(params, cfg, tokens, positions=pos))
    if case["routes"] is not None:                 # routes first
        assert len(routes) == len(case["routes"])
        for got, want in zip(routes, case["routes"]):
            np.testing.assert_array_equal(got.numpy(), want)
    assert logits.dtype == torch.float32
    assert logits.shape == case["full32"].shape
    np.testing.assert_allclose(f32(logits), case["full32"], **F32)
    np.testing.assert_allclose(float(aux), case["aux32"], **F32)
    assert (float(aux) > 0) == (cfg.moe is not None)
    lg, st = make_prefill_step(cfg)(params, {"tokens": tokens[:, :PROMPT]})
    want_lg, want_st = case["run32"]["prefill"]
    np.testing.assert_allclose(f32(lg), want_lg, **F32)
    assert_same_state(st, want_st)


def test_f32_decode_steps_from_the_reference_state(case):
    cfg = case["cfg"]
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    for tok, before, want_lg, want_st in case["run32"]["steps"]:
        lg, st = M.decode_step(params, cfg, torch.tensor(tok[:, None]),
                               to_torch(before))
        np.testing.assert_allclose(f32(lg), want_lg, **F32)
        assert_same_state(st, want_st)


def test_f32_greedy_serving_gives_the_reference_tokens(case):
    """Through the serve CLI's calls; M-RoPE decode positions from the
    state's length, codebooks fed back as [B, 1, K]."""
    cfg = case["cfg"]
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    prompt = torch.from_numpy(case["tokens"][:, :PROMPT])
    logits, st = make_prefill_step(cfg)(params, {"tokens": prompt})
    st = serve._grow_cache(cfg, st, B, PROMPT + STEPS, "cpu")
    assert_same_state(st, np_tree(jax_grow_cache(
        case["jcfg"], jtree(case["run32"]["prefill"][1]), B,
        PROMPT + STEPS)))
    step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    got = []
    for _ in range(STEPS):
        got.append(tok)
        tok, st = step(params, tok[:, None], st)
    want = np.stack([s[0] for s in case["run32"]["steps"]])
    assert got[1].dtype == torch.int32 and got[1].shape == want.shape[1:]
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    assert int(st["len"]) == PROMPT + STEPS


def same_routes(got: list, want: list, shape: tuple) -> np.ndarray:
    """Per token, whether every MoE layer routes it to the same experts."""
    agree = np.ones(shape, bool)
    for g, w in zip(got, want):
        g, w = (np.asarray(a).reshape(*shape, -1) for a in (g, w))
        agree &= (np.sort(g, -1) == np.sort(w, -1)).all(-1)
    return agree


def test_bf16_no_noisier_than_the_reference(case):
    """Where every MoE layer routes a token as the float32 truth does:
    bf16 rounding can flip a near-tie route (on either side), and a
    flipped route moves that token's logits by O(1). At most 5 % of the
    tokens flip (here: one of the 24 in deepseek-v3's full logits); their
    rows are left out of both sides' errors. The decode steps' truth
    routes are the port's float32 steps' on the same tokens (the float32
    tests hold them to the reference's)."""
    cfg, tokens = case["cfg"], torch.from_numpy(case["tokens"])
    params = M.params_from_numpy(case["p16"], cfg, "cpu")
    p32 = M.params_from_numpy(case["p32"], cfg, "cpu")
    pos = None if case["pos"] is None else torch.from_numpy(case["pos"])
    (logits, _), routes = routes_by_layer(
        lambda: M.full_logits(params, cfg, tokens, positions=pos))
    agree = same_routes(routes, case["routes"] or [], (B, S))
    flips = [(~agree).sum()]

    def check(got, ref16, truth, rows, what):
        got, ref16 = f32(got)[rows], f32(ref16)[rows]
        check_noise(got, ref16, truth[rows], what)

    check(logits, case["full16"], case["full32"], agree, "full logits")
    prompt = tokens[:, :PROMPT]
    lg, st = M.prefill(params, cfg, prompt)
    check(lg[:, 0], case["run16"]["prefill"][0][:, 0],
          case["run32"]["prefill"][0][:, 0], agree[:, PROMPT - 1],
          "prefill logits")
    layout = tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).removeprefix("torch.")), st)
    assert layout == jax.tree.map(lambda a: (a.shape, a.dtype.name),
                                  case["run16"]["prefill"][1])
    st = serve._grow_cache(cfg, st, B, PROMPT + STEPS, "cpu")
    st32 = serve._grow_cache(cfg, M.prefill(p32, cfg, prompt)[1], B,
                             PROMPT + STEPS, "cpu")
    for (tok, _, want16, _), (_, _, truth, _) in zip(case["run16"]["steps"],
                                                     case["run32"]["steps"]):
        tok = torch.tensor(tok[:, None])
        (lg, st), r16 = routes_by_layer(
            lambda: M.decode_step(params, cfg, tok, st))
        (_, st32), r32 = routes_by_layer(
            lambda: M.decode_step(p32, cfg, tok, st32))
        rows = same_routes(r16, r32, (B,))
        flips.append((~rows).sum())
        check(lg[:, 0], want16[:, 0], truth[:, 0], rows, "decode logits")
    assert sum(flips) <= 0.05 * B * (S + STEPS), flips


def test_f32_loss_and_every_gradient(case):
    cfg = case["cfg"]
    t = torch.from_numpy(case["tokens"])
    batch = {"tokens": t, "labels": t}
    if case["pos"] is not None:
        batch["positions"] = torch.from_numpy(case["pos"])
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                          TrainHParams(loss_chunk=CHUNK))
    assert abs(float(loss) - case["loss32"]) <= LOSS_RTOL * case["loss32"]
    np.testing.assert_allclose(float(metrics["ce"] + metrics["aux"]),
                               float(loss), rtol=1e-6)
    assert worst_grad(grads, case["grads32"]) <= GRAD_RTOL


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


# -- the port on its own: prefill + decode, unrolled, static step --------


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_consistency(name):
    """The reference's case (``tests/test_lm_archs.py``) on the port's own
    bf16 init: prefill(tokens[:8]) and 4 decode steps against the
    teacher-forced logits, within 5e-2."""
    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(tokens_of(cfg, seed=1))
    full, _ = M.full_logits(params, cfg, toks)
    lg, st = M.prefill(params, cfg, toks[:, :PROMPT])
    torch.testing.assert_close(lg[:, 0].float(), full[:, PROMPT - 1],
                               rtol=5e-2, atol=5e-2)
    st = serve._grow_cache(cfg, st, B, S, "cpu")
    for t in range(PROMPT, S):
        lg, st = M.decode_step(params, cfg, toks[:, t:t + 1], st)
        torch.testing.assert_close(lg[:, 0].float(), full[:, t],
                                   rtol=5e-2, atol=5e-2)


def _unrolled(state: dict) -> dict:
    return {"len": state["len"], **{
        part: {k: [t.clone() for t in v] for k, v in state[part].items()}
        for part in ("dense", "main") if part in state}}


def test_unrolled_decode_equals_stacked_and_the_reference():
    """deepseek-v3 (both stacks, MLA's latent cache): the reference's
    case on the native bf16 weights; the port's unrolled step equals its
    stacked step bit for bit, the aux loss included (summed over layers
    in both, where the reference's unrolled decode keeps its last
    layer's)."""
    name = "deepseek-v3-671b"
    jcfg, cfg = jax_get_reduced(name), get_reduced(name)
    jparams = jax_init(jcfg, jax.random.PRNGKey(2))
    params = M.params_from_numpy(np_tree(jparams), cfg, "cpu")
    n = 10
    toks = tokens_of(jcfg, s=n, seed=2)
    _, jst = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :n - 1]))
    jst = jax_grow_cache(jcfg, jst, B, n)
    want, _ = jax.jit(functools.partial(JM.decode_step, unroll=True),
                      static_argnums=1)(jparams, jcfg,
                                        jnp.asarray(toks[:, -1:]),
                                        _unrolled_jax(jst))

    _, st = M.prefill(params, cfg, torch.from_numpy(toks[:, :n - 1]))
    stacked = serve._grow_cache(cfg, st, B, n, "cpu")
    unrolled = serve._grow_cache(cfg, _unrolled(st), B, n, "cpu")
    assert set(unrolled) == {"len", "dense", "main"}
    assert isinstance(unrolled["dense"]["latent"], list)
    assert unrolled["main"]["krope"][0].shape == (
        B, n, cfg.mla.qk_rope_head_dim)
    tok = torch.from_numpy(toks[:, -1:])
    out_s = M.forward(params, cfg, tok, mode="decode", state=stacked)
    out_u = M.forward(params, cfg, tok, mode="decode", state=unrolled,
                      unroll_decode=True)
    assert torch.equal(out_u.hidden, out_s.hidden)
    assert torch.equal(out_u.aux, out_s.aux) and float(out_s.aux) > 0
    for part in ("dense", "main"):
        for k in ("latent", "krope"):
            got = out_u.state[part][k]
            assert isinstance(got, list)
            assert all(a is b for a, b in zip(got, unrolled[part][k]))
            assert torch.equal(torch.stack(got), out_s.state[part][k])
    lg_u = M.unembed_hidden(params, cfg, out_u.hidden)
    np.testing.assert_allclose(f32(lg_u), np.asarray(want, np.float32),
                               rtol=4e-2, atol=4e-2)


def _unrolled_jax(st):
    return {"len": st["len"], **{
        part: {k: [v[i] for i in range(v.shape[0])]
               for k, v in st[part].items()}
        for part in ("dense", "main") if part in st}}


def _prefilled(name):
    cfg = get_reduced(name)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(tokens_of(cfg, s=PROMPT))
    batch = {"tokens": prompt}
    if cfg.mrope_sections:
        batch["positions"] = torch.from_numpy(mrope_streams(B, PROMPT))
    logits, st = make_prefill_step(cfg)(params, batch)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    return cfg, params, tok, serve._grow_cache(cfg, st, B, S, "cpu")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("unroll", [False, True])
def test_static_step_equals_the_plain_step(name, unroll):
    """The static-buffer step (what the card's graph captures) against
    the plain step: 4 tokens and every state leaf bit for bit; codebook
    tokens [B, 1, K] in and [B, K] out."""
    cfg, params, tok, grown = _prefilled(name)
    if unroll:
        grown = _unrolled(grown)
    step = StaticServeStep(cfg, params, "cpu", unroll=unroll)
    assert step.precompile(B, S)
    plain = make_serve_step(cfg, unroll=unroll)
    a, b = tok, tok
    sa, sb = tree_map(torch.clone, grown), tree_map(torch.clone, grown)
    for _ in range(S - PROMPT):
        a, sa = step(params, a[:, None], sa)
        b, sb = plain(params, b[:, None], sb)
        assert torch.equal(a, b) and a.dtype == torch.int32
    assert a.shape == ((B, cfg.n_codebooks) if cfg.n_codebooks else (B,))
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
             sa, sb)
    assert int(sa["len"]) == S
    with pytest.raises(ValueError, match="past capacity"):
        step(params, a[:, None], sa)
    with pytest.raises(ValueError, match="tokens shape"):
        step(params, a, tree_map(torch.clone, grown))


# -- trees, CLIs --------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_full_config_tree_on_meta_is_the_reference_tree(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    got = M.init_model(cfg, None, "meta")
    want = jax.eval_shape(lambda k: JM.init_model(jcfg, k),
                          jax.random.PRNGKey(0))
    assert tree_map(lambda a: (tuple(a.shape),
                               str(a.dtype).removeprefix("torch.")), got) \
        == jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
    leaves = _leaves(got)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))
    assert round(n / 1e9, 3) == N_PARAMS[name]
    assert abs(n / cfg.n_params() - 1) < 1e-3, (n, cfg.n_params())


@pytest.mark.parametrize("name", NAMES)
def test_serve_main_on_cpu(name, capsys):
    toks = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "9", "--gen", "4"])
    cfg = get_reduced(name)
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert toks.shape == (3, 4, *k) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert "[decode ]" in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_train_main_and_the_references_data(name, tmp_path, capsys):
    """The training CLI, checkpointed and resumed, on the reference's
    numpy stream: codebook tokens and M-RoPE positions as its own."""
    cfg = get_reduced(name)
    for step in (0, 3):
        want = jax_synthetic_batch(jax_get_reduced(name), 2, 16, step, 5)
        got = train.synthetic_batch(cfg, 2, 16, step, 5)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    args = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--micro", "2"]
    losses = train.main(args + ["--steps", "2"])
    more = train.main(args + ["--steps", "3", "--resume"])
    assert len(losses) == 2 and len(more) == 1
    assert np.isfinite(losses + more).all()
    assert "[resume]" in capsys.readouterr().out


# -- initialisation memory ----------------------------------------------------


def _dense_init_before(gen, shape, device, dtype=torch.bfloat16):
    """``layers._dense_init`` as it was: a second float32 copy of the
    leaf for the scaled product."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / np.sqrt(fan_in))).to(dtype)


def _stack_init_before(fn, n):
    """``model._stack_init`` as it was: the first layer kept alive beside
    the stacked leaves."""
    first = fn()
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else fn()
        tree_map(lambda o, a: o[i].copy_(a), out, layer)
    return out


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-7b", "glm4-9b",
                                  "deepseek-v3-671b"])
def test_init_model_bits_unchanged_by_the_memory_repairs(name, monkeypatch):
    """The in-place scale of ``_dense_init`` and the one-layer-at-a-time
    ``_stack_init`` draw the same bits from the same seed as before
    (deepseek-v3's reduced dense stack is a stack of one)."""
    from repro_torch.models import layers, mamba2, rwkv
    cfg = get_reduced(name)
    now = M.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    for mod in (layers, mamba2, rwkv, MOE):
        monkeypatch.setattr(mod, "_dense_init", _dense_init_before)
    monkeypatch.setattr(M, "_stack_init", _stack_init_before)
    before = M.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    assert tree_map(lambda a: a.dtype, now) == tree_map(lambda a: a.dtype,
                                                         before)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             now, before)
