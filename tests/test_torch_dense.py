"""The port's dense GQA transformers (stablelm-12b, glm4-9b, chatglm3-6b,
qwen2-1.5b) against the JAX package, at reduced size on the CPU.

The reference initialises every bias to 0 and every norm scale to 1, so
an untouched tree cannot show a wrong bias or scale path: here they are
drawn from a seed (``perturb``) and written into the numpy tree both
packages take. Tolerances:

* one layer (layernorm, attention with qkv bias and qk-norm, the gelu
  MLP) on float32 inputs: rtol = atol = 1e-5; a bf16 K/V leaf one bf16
  ulp (rtol 2^-7, ``BF16_LEAF``); on bf16 inputs the result keeps its
  dtype and is held to the float32 truth no worse than ``BF16_NOISE``
  times the reference's own bf16 error (``tests/test_torch_lm.py``);
* the whole model in float32 (logits, prefill state, decode steps from
  the reference's state, greedy tokens): ``F32`` (rtol = atol = 2e-4)
  and ``BF16_LEAF``, as ``tests/test_torch_lm.py`` states;
* the unrolled decode (per-layer cache lists) equals the port's stacked
  decode bit for bit, and matches the reference's unrolled decode within
  its own 4e-2 (``tests/test_lm_archs.py``) on the native bf16 weights;
* the four full configs' trees on ``device="meta"`` have the
  reference's keys, shapes and dtypes (``jax.eval_shape``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.serve import _grow_cache as jax_grow_cache
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ArchConfig, get_config, get_reduced
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import tree_map
from repro_torch.train.steps import make_serve_step
from test_torch_lm import (BF16_LEAF, BF16_NOISE, F32, assert_same_state,
                           f32, jax_chain, np_tree, to_torch)

DENSE = ["stablelm-12b", "glm4-9b", "chatglm3-6b", "qwen2-1.5b"]
ONE = dict(rtol=1e-5, atol=1e-5)
B, S, PROMPT, STEPS = 2, 12, 8, 4
# the parameter counts of the full configs, billions (jax.eval_shape)
N_PARAMS = {"stablelm-12b": 12.144, "glm4-9b": 9.400, "chatglm3-6b": 6.244,
            "qwen2-1.5b": 1.544}


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ArchConfig)})


def perturb(tree: dict, seed: int = 1) -> dict:
    """The numpy tree with every bias drawn from N(0, 0.5^2) and every
    norm scale from 1 + N(0, 0.3^2), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def walk(t, key=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if key in ("bias", "bq", "bk", "bv"):
            return rng.normal(0, 0.5, a.shape).astype(a.dtype)
        if key == "scale":
            return (1 + rng.normal(0, 0.3, a.shape)).astype(a.dtype)
        return a
    return walk(tree)


def as_f32(tree: dict) -> dict:
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jtree(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def check_noise(got, ref16, truth, what):
    err = np.abs(f32(got) - truth).max()
    ref_err = np.abs(f32(ref16) - truth).max()
    assert err <= BF16_NOISE * ref_err + 1e-3, (what, err, ref_err)


# -- one layer -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    """Population variance (``jnp.var``), float32 scale and bias, the
    result cast back to the input's dtype."""
    rng = np.random.default_rng(0)
    p = perturb({"scale": np.ones(64, np.float32),
                 "bias": np.zeros(64, np.float32)})
    x = rng.normal(0.5, 2.0, (3, 5, 64)).astype(np.float32)
    if dtype == "bfloat16":
        x = bf16(x)
    want = np.asarray(JL.layernorm(jtree(p), jnp.asarray(x), 1e-5))
    got = L.layernorm(to_torch(p), to_torch(x), 1e-5)
    assert str(got.dtype).removeprefix("torch.") == dtype
    tol = ONE if dtype == "float32" else BF16_LEAF
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    assert L.apply_norm(to_torch(p), to_torch(x), 1e-5).equal(got)


ATTENTION_CASES = [("glm4-9b", True), ("stablelm-12b", False),
                   ("qwen2-1.5b", True)]


def _attention_case(name, qk_norm):
    jcfg = dataclasses.replace(jax_get_reduced(name), qk_norm=qk_norm)
    p = perturb(np_tree(JL.init_attention(jcfg, jax.random.PRNGKey(3))))
    assert set(p) >= {"bq", "bk", "bv"} and ("q_norm" in p) == qk_norm
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, PROMPT, jcfg.d_model)).astype(np.float32)
    return jcfg, port_cfg(jcfg), p, x


def _jax_attention(jcfg, p, x, prompt=PROMPT):
    """The reference's prefill over x[:, :prompt] (with its K/V), then a
    decode of x[:, prompt:] on a grown cache."""
    att = jax.jit(JL.attention, static_argnames=("cfg", "return_kv"))
    xj = jnp.asarray(x)
    out, kv = att(jtree(p), xj[:, :prompt], jcfg,
                  positions=jnp.arange(prompt), return_kv=True)
    cap = x.shape[1] + 2
    ck = jnp.zeros((B, cap, *kv[0].shape[2:]), jnp.bfloat16)
    ck = ck.at[:, :prompt].set(kv[0])
    cv = jnp.zeros_like(ck).at[:, :prompt].set(kv[1])
    n = x.shape[1] - prompt
    out_d, (ck, cv) = att(jtree(p), xj[:, prompt:], jcfg,
                          positions=prompt + jnp.arange(n),
                          kv_cache=(ck, cv), cache_len=jnp.int32(prompt))
    return [np.asarray(a) for a in (out, kv[0], kv[1], out_d, ck, cv)]


def _port_attention(cfg, p, x, prompt=PROMPT):
    pt, xt = to_torch(p), to_torch(x)
    out, kv = L.attention(pt, xt[:, :prompt], cfg,
                          positions=torch.arange(prompt), return_kv=True)
    cap = x.shape[1] + 2
    ck = torch.zeros((B, cap, *kv[0].shape[2:]), dtype=torch.bfloat16)
    ck[:, :prompt] = kv[0]
    cv = torch.zeros_like(ck)
    cv[:, :prompt] = kv[1]
    n = x.shape[1] - prompt
    out_d, (ck2, cv2) = L.attention(
        pt, xt[:, prompt:], cfg, positions=prompt + torch.arange(n),
        kv_cache=(ck, cv), cache_len=torch.tensor(prompt, dtype=torch.int32))
    assert ck2 is ck and cv2 is cv                     # written in place
    return [out, kv[0], kv[1], out_d, ck, cv]


@pytest.mark.parametrize("name,qk_norm", ATTENTION_CASES)
def test_attention_qkv_bias_and_qk_norm_match_the_reference(name, qk_norm):
    """Float32 inputs: the prefill's output and rotated K/V, then a
    2-token decode into a grown cache, with drawn biases and qk-norm
    scales; partial RoPE as each config sets it."""
    jcfg, cfg, p, x = _attention_case(name, qk_norm)
    x = np.concatenate([x, np.random.default_rng(5).normal(
        0, 1, (B, 2, jcfg.d_model)).astype(np.float32)], axis=1)
    want = _jax_attention(jcfg, as_f32(p), x)
    got = _port_attention(cfg, as_f32(p), x)
    for what, g, w in zip(("out", "k", "v", "decode out", "k cache",
                           "v cache"), got, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, what
        tol = BF16_LEAF if w.dtype.name == "bfloat16" else ONE
        np.testing.assert_allclose(f32(g), f32(w), err_msg=what, **tol)
    # a wrong bias path shows: the same run without the biases differs
    no_bias = {k: v for k, v in as_f32(p).items() if k[0] != "b"}
    plain = L.attention(to_torch(no_bias),
                        to_torch(x[:, :PROMPT]),
                        dataclasses.replace(cfg, qkv_bias=False),
                        positions=torch.arange(PROMPT))[0]
    assert np.abs(f32(plain) - want[0]).max() > 1e-2


@pytest.mark.parametrize("name,qk_norm", ATTENTION_CASES)
def test_attention_in_bf16_keeps_its_dtype(name, qk_norm):
    """bf16 activations and weights with float32 biases: the bias is
    cast to bf16 before the add (as the reference does), so q, k, v, the
    output and the cache stay bf16; no noisier than the reference."""
    jcfg, cfg, p, x = _attention_case(name, qk_norm)
    x = np.concatenate([x, np.random.default_rng(5).normal(
        0, 1, (B, 2, jcfg.d_model)).astype(np.float32)], axis=1)
    truth = _jax_attention(jcfg, as_f32(p), x)
    ref16 = _jax_attention(jcfg, p, bf16(x))
    got = _port_attention(cfg, p, bf16(x))
    assert [g.dtype for g in got] == [torch.bfloat16] * 6
    check_noise(got[0], ref16[0], truth[0], "prefill out")
    check_noise(got[3], ref16[3], truth[3], "decode out")


def test_gelu_mlp_matches_the_reference():
    """The tanh form (``jax.nn.gelu``'s default), not the erf form."""
    p = np_tree(JL.init_mlp(64, 128, "gelu", jax.random.PRNGKey(5)))
    assert set(p) == {"w_up", "w_down"}
    x = np.random.default_rng(6).normal(0, 1, (B, 5, 64)).astype(np.float32)
    want = np.asarray(JL.mlp(jtree(as_f32(p)), jnp.asarray(x), "gelu"))
    got = L.mlp(to_torch(as_f32(p)), to_torch(x), "gelu")
    np.testing.assert_allclose(f32(got), want, **ONE)
    erf = L.dot(torch.nn.functional.gelu(L.dot(to_torch(x),
                                               to_torch(as_f32(p))["w_up"])),
                to_torch(as_f32(p))["w_down"])
    assert np.abs(f32(erf) - want).max() > 1e-5         # tells them apart
    ref16 = JL.mlp(jtree(p), jnp.asarray(bf16(x)), "gelu")
    got16 = L.mlp(to_torch(p), to_torch(bf16(x)), "gelu")
    assert got16.dtype == torch.bfloat16
    check_noise(got16, ref16, want, "bf16 gelu mlp")


# -- the whole model -------------------------------------------------------------


WHOLE = {
    "glm4-9b+qk_norm+gelu": lambda: dataclasses.replace(
        jax_get_reduced("glm4-9b"), qk_norm=True, mlp_style="gelu"),
    "stablelm-12b": lambda: jax_get_reduced("stablelm-12b"),
}


@pytest.fixture(scope="module", params=sorted(WHOLE))
def whole(request):
    jcfg = WHOLE[request.param]()
    p32 = as_f32(perturb(np_tree(JM.init_model(jcfg, jax.random.PRNGKey(0)))))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    full = jax.jit(JM.full_logits, static_argnums=1)(
        jtree(p32), jcfg, jnp.asarray(tokens))[0]
    return {"jcfg": jcfg, "cfg": port_cfg(jcfg), "p32": p32,
            "tokens": tokens, "full": np.asarray(full),
            "run": jax_chain(jtree(p32), jcfg, tokens[:, :PROMPT])}


def test_whole_model_with_drawn_biases_and_scales(whole):
    """Full logits, the prefill's logits and state, and 4 decode steps
    each from the reference's state, in float32, with every bias and
    norm scale drawn (qk-norm and the gelu MLP on glm4-9b; layernorm's
    bias, 25 % partial RoPE and the untied head on stablelm-12b)."""
    cfg, tokens = whole["cfg"], torch.from_numpy(whole["tokens"])
    params = M.params_from_numpy(whole["p32"], cfg, "cpu")
    logits, _ = M.full_logits(params, cfg, tokens)
    np.testing.assert_allclose(f32(logits), whole["full"], **F32)
    lg, st = M.prefill(params, cfg, tokens[:, :PROMPT])
    want_lg, want_st = whole["run"]["prefill"]
    np.testing.assert_allclose(f32(lg), want_lg, **F32)
    assert_same_state(st, want_st)
    for tok, before, want_lg, want_st in whole["run"]["steps"]:
        lg, st = M.decode_step(params, cfg, torch.tensor(tok[:, None]),
                               to_torch(before))
        np.testing.assert_allclose(f32(lg), want_lg, **F32)
        assert_same_state(st, want_st)


def test_whole_model_greedy_tokens(whole):
    cfg = whole["cfg"]
    params = M.params_from_numpy(whole["p32"], cfg, "cpu")
    logits, st = M.prefill(params, cfg,
                           torch.from_numpy(whole["tokens"][:, :PROMPT]))
    st = _grow_cache(cfg, st, B, PROMPT + STEPS, "cpu")
    step, got = make_serve_step(cfg), []
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    for _ in range(STEPS):
        got.append(tok)
        tok, st = step(params, tok[:, None], st)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.stack([s[0] for s in
                                            whole["run"]["steps"]]))


# -- the unrolled decode ---------------------------------------------------------


def _unrolled(state: dict) -> dict:
    return {"len": state["len"],
            "main": {k: [t.clone() for t in v]
                     for k, v in state["main"].items()}}


@pytest.mark.parametrize("name", ["glm4-9b", "stablelm-12b"])
def test_unrolled_decode_equals_stacked_and_the_reference(name):
    """The reference's case (``tests/test_lm_archs.py``): prefill S - 1
    tokens, grow, one decode step, stacked and unrolled, on the native
    bf16 weights."""
    jcfg, cfg = jax_get_reduced(name), get_reduced(name)
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(2))
    params = M.params_from_numpy(np_tree(jparams), cfg, "cpu")
    n, cap = 10, 10
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, n)).astype(np.int32)
    _, jst = JM.prefill(jparams, jcfg, jnp.asarray(toks[:, :n - 1]))
    jst = jax_grow_cache(jcfg, jst, B, cap)
    jst_ur = {"len": jst["len"],
              "main": {k: [v[i] for i in range(v.shape[0])]
                       for k, v in jst["main"].items()}}
    want, _ = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, -1:]),
                             jst_ur, unroll=True)

    _, st = M.prefill(params, cfg, torch.from_numpy(toks[:, :n - 1]))
    stacked = _grow_cache(cfg, st, B, cap, "cpu")
    unrolled = _grow_cache(cfg, _unrolled(st), B, cap, "cpu")
    assert isinstance(unrolled["main"]["k"], list)
    assert unrolled["main"]["k"][0].shape == (B, cap, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
    for i in range(cfg.n_layers):                    # grown on axis 1
        assert torch.equal(unrolled["main"]["k"][i], stacked["main"]["k"][i])
    tok = torch.from_numpy(toks[:, -1:])
    lg_s, new_s = M.decode_step(params, cfg, tok, stacked)
    lg_u, new_u = M.decode_step(params, cfg, tok, unrolled, unroll=True)
    assert torch.equal(lg_u, lg_s)
    assert isinstance(new_u["main"]["v"], list) and int(new_u["len"]) == n
    for k in ("k", "v"):
        assert all(a is b for a, b in zip(new_u["main"][k],
                                          unrolled["main"][k]))  # in place
        assert torch.equal(torch.stack(new_u["main"][k]), new_s["main"][k])
    np.testing.assert_allclose(f32(lg_u), np.asarray(want, np.float32),
                               rtol=4e-2, atol=4e-2)
    # unroll on a stacked state returns per-layer views of it
    lg_v, new_v = M.decode_step(params, cfg, tok,
                                _grow_cache(cfg, st, B, cap, "cpu"),
                                unroll=True)
    assert torch.equal(lg_v, lg_s) and isinstance(new_v["main"]["k"], list)


def test_init_decode_state_unrolled_layout():
    cfg = get_reduced("glm4-9b")
    st = M.init_decode_state(cfg, 3, 7, "cpu", unrolled=True)
    stacked = M.init_decode_state(cfg, 3, 7, "cpu")
    assert set(st) == {"len", "main"} and st["len"].dtype == torch.int32
    for k in ("k", "v"):
        leaves = st["main"][k]
        assert len(leaves) == cfg.n_layers
        assert all(t.shape == stacked["main"][k].shape[1:]
                   and t.dtype == torch.bfloat16 for t in leaves)
        assert len({t.data_ptr() for t in leaves}) == cfg.n_layers
    copy = tree_map(torch.clone, st)                 # lists are trees
    assert isinstance(copy["main"]["k"], list)
    assert copy["main"]["k"][0].data_ptr() != st["main"]["k"][0].data_ptr()


# -- the tied head and the full configs ------------------------------------------


def test_qwen2_tied_head():
    """qwen2-1.5b ties its head to the embedding: no ``lm_head`` in
    either tree, the logits are hidden @ embed^T in float32, and a tree
    with a head is refused."""
    jcfg, cfg = jax_get_reduced("qwen2-1.5b"), get_reduced("qwen2-1.5b")
    assert cfg.tie_embeddings
    tree = np_tree(JM.init_model(jcfg, jax.random.PRNGKey(0)))
    assert "lm_head" not in tree
    assert "lm_head" not in M.init_model(cfg, torch.Generator().manual_seed(0),
                                         "cpu")
    params = M.params_from_numpy(tree, cfg, "cpu")
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    got = M.unembed_hidden(params, cfg, x)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float() @ params["embed"].float().T)
    want = JM.unembed_hidden(jtree(tree), jcfg,
                             jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(f32(got), np.asarray(want), **F32)
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy({**tree, "lm_head": tree["embed"].T}, cfg, "cpu")


@pytest.mark.parametrize("name", DENSE)
def test_full_config_tree_on_meta_is_the_reference_tree(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    got = M.init_model(cfg, None, "meta")
    want = jax.eval_shape(lambda k: JM.init_model(jcfg, k),
                          jax.random.PRNGKey(0))
    assert M.tree_map(lambda a: (tuple(a.shape),
                                 str(a.dtype).removeprefix("torch.")), got) \
        == jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
    leaves = []
    M.tree_map(leaves.append, got)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))
    assert round(n / 1e9, 3) == N_PARAMS[name]
