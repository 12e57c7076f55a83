"""The port's language models (rwkv6-3b, ``ssm``; zamba2-7b, ``hybrid``;
stablelm-12b, glm4-9b, chatglm3-6b and qwen2-1.5b, ``dense``) against
the JAX package, at reduced size on the CPU.

The JAX package's ``init_model`` parameters are carried into the port by
``params_from_numpy``; prompts are numpy token ids. On the CPU the port
runs the chunked recurrences, as the reference's model does.

* With the parameters cast to float32: ``full_logits``, the prefill
  logits and every decode-state leaf, then 4 decode steps on a grown
  cache, within rtol = atol = 2e-4 (``tests/test_recurrent_cores.py``),
  and the same greedy tokens. A leaf the reference stores in bf16 (the
  K/V cache) is held to one bf16 ulp (rtol 2^-7): values that agree to
  1e-6 can round to neighbouring bf16 values. Each decode step starts
  both sides from the reference's state, so such a rounding does not
  carry into the next step's comparison; the greedy chains run apart.
* With the native bf16 parameters the two frameworks round bf16 at other
  points (XLA keeps float32 across a fused chain, torch rounds after
  each op), and at this size the reference's own bf16 logits are about
  0.1 from its float32 logits: a fixed 5e-2 between two bf16 runs cannot
  hold. So the port's bf16 logits are held to the float32 truth no worse
  than 1.5 times the reference's own bf16 error (``BF16_NOISE``).
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
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.train.steps import make_prefill_step, make_serve_step

NAMES = ["rwkv6-3b", "zamba2-7b", "stablelm-12b", "glm4-9b", "chatglm3-6b",
         "qwen2-1.5b"]
B, S, PROMPT, STEPS = 2, 12, 8, 4
F32 = dict(rtol=2e-4, atol=2e-4)
BF16_LEAF = dict(rtol=2 ** -7, atol=2e-4)       # one bf16 ulp
BF16_NOISE = 1.5
# the reference's entry points, compiled once per arch and dtype
jax_prefill = jax.jit(JM.prefill, static_argnums=1)
jax_decode = jax.jit(JM.decode_step, static_argnums=1)
jax_full = jax.jit(JM.full_logits, static_argnums=1)


def to_torch(tree):
    """numpy tree (bf16 leaves as ml_dtypes) -> torch tree, fresh copies."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def assert_same_state(got: dict, want: dict, path=""):
    """Same keys, shapes and dtypes; float32 leaves within ``F32``, bf16
    leaves within one bf16 ulp, integers equal."""
    assert isinstance(got, dict) and set(got) == set(want), (path, got.keys())
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_same_state(g, w, f"{path}/{k}")
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (path, k, g.shape, w.shape)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, \
            (path, k, g.dtype, w.dtype)
        tol = BF16_LEAF if w.dtype.name == "bfloat16" else F32
        np.testing.assert_allclose(f32(g), f32(w), err_msg=f"{path}/{k}",
                                   **tol)


def assert_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert torch.equal(a, b)


def jax_chain(params, cfg, tokens, feed=None):
    """Prefill the prompt, grow the cache, decode STEPS tokens: greedy,
    or the tokens of ``feed``. Records each step's state before it."""
    logits, st = jax_prefill(params, cfg, jnp.asarray(tokens))
    out = {"prefill": (np.asarray(logits), np_tree(st)), "steps": []}
    st = jax_grow_cache(cfg, st, B, PROMPT + STEPS)
    tok = np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)
    for i in range(STEPS):
        if feed is not None:
            tok = feed[i]
        before = np_tree(st)
        logits, st = jax_decode(params, cfg, jnp.asarray(tok[:, None]), st)
        out["steps"].append((tok, before, np.asarray(logits), np_tree(st)))
        tok = np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)
    return out


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """The reference's runs of one reduced arch: float32-cast and bf16."""
    name = request.param
    cfg = jax_get_reduced(name)
    params = JM.init_model(cfg, jax.random.PRNGKey(0))
    p16 = np_tree(params)
    p32 = jax.tree.map(lambda a: a.astype(np.float32), p16)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    j32 = jax.tree.map(jnp.asarray, p32)
    run32 = jax_chain(j32, cfg, tokens[:, :PROMPT])
    feed = [s[0] for s in run32["steps"]]
    return {
        "name": name, "cfg": get_reduced(name), "tokens": tokens,
        "p32": p32, "p16": p16,
        "full32": np.asarray(jax_full(j32, cfg, jnp.asarray(tokens))[0]),
        "full16": np.asarray(jax_full(params, cfg, jnp.asarray(tokens))[0]),
        "run32": run32,
        "run16": jax_chain(params, cfg, tokens[:, :PROMPT], feed),
    }


def test_f32_full_logits_prefill_and_state(case):
    cfg, tokens = case["cfg"], torch.from_numpy(case["tokens"])
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    logits, aux = M.full_logits(params, cfg, tokens)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(f32(logits), case["full32"], **F32)
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
    cfg = case["cfg"]
    params = M.params_from_numpy(case["p32"], cfg, "cpu")
    prompt = torch.from_numpy(case["tokens"][:, :PROMPT])
    logits, st = make_prefill_step(cfg)(params, {"tokens": prompt})
    st = serve._grow_cache(cfg, st, B, PROMPT + STEPS, "cpu")
    assert_same_state(st, np_tree(jax_grow_cache(
        jax_get_reduced(case["name"]),
        jax.tree.map(jnp.asarray, case["run32"]["prefill"][1]), B,
        PROMPT + STEPS)))
    step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    got = []
    for _ in range(STEPS):
        got.append(tok)
        tok, st = step(params, tok[:, None], st)
    want = [s[0] for s in case["run32"]["steps"]]
    assert [t.dtype for t in got[1:]] == [torch.int32] * (STEPS - 1)
    np.testing.assert_array_equal(torch.stack(got).numpy(), np.stack(want))
    assert int(st["len"]) == PROMPT + STEPS


def test_bf16_no_noisier_than_the_reference(case):
    cfg, tokens = case["cfg"], torch.from_numpy(case["tokens"])
    params = M.params_from_numpy(case["p16"], cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16

    def check(got, ref16, truth, what):
        err = np.abs(f32(got) - truth).max()
        ref_err = np.abs(f32(ref16) - truth).max()
        assert err <= BF16_NOISE * ref_err + 1e-3, (what, err, ref_err)

    check(M.full_logits(params, cfg, tokens)[0], case["full16"],
          case["full32"], "full logits")
    lg, st = M.prefill(params, cfg, tokens[:, :PROMPT])
    check(lg, case["run16"]["prefill"][0], case["run32"]["prefill"][0],
          "prefill logits")
    layout = M.tree_map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix("torch.")), st)
    assert layout == jax.tree.map(lambda a: (a.shape, a.dtype.name),
                                  case["run16"]["prefill"][1])
    st = serve._grow_cache(cfg, st, B, PROMPT + STEPS, "cpu")
    for (tok, _, want16, _), (_, _, truth, _) in zip(case["run16"]["steps"],
                                                     case["run32"]["steps"]):
        lg, st = M.decode_step(params, cfg, torch.tensor(tok[:, None]),
                               st)
        check(lg, want16, truth, "decode logits")
        assert bool(lg.isfinite().all())


@pytest.mark.parametrize("name", NAMES)
def test_serve_main_on_cpu(name, capsys):
    toks = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "9", "--gen", "4"])
    cfg = get_reduced(name)
    assert toks.shape == (3, 4) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert "[decode ]" in capsys.readouterr().out


def test_params_from_numpy_checks_the_tree():
    cfg = get_reduced("zamba2-7b")
    tree = np_tree(JM.init_model(jax_get_reduced("zamba2-7b"),
                                 jax.random.PRNGKey(1)))
    params = M.params_from_numpy(tree, cfg, "cpu")
    w = tree["mamba"]["in_proj"]
    assert w.dtype.name == "bfloat16"                # carried bit for bit
    assert params["mamba"]["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["mamba"]["in_proj"].view(torch.int16).numpy(),
        w.view(np.int16))
    bad_key = {**tree, "mamba": {**tree["mamba"], "extra": w}}
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy(bad_key, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        M.params_from_numpy(missing, cfg, "cpu")
    bad_shape = {**tree, "embed": tree["embed"][:-1]}
    with pytest.raises(ValueError, match="shape"):
        M.params_from_numpy(bad_shape, cfg, "cpu")
    bad_dtype = {**tree, "final_norm": {"scale": np.ones(64, np.float64)}}
    with pytest.raises(ValueError, match="dtype"):
        M.params_from_numpy(bad_dtype, cfg, "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_init_model_matches_the_reference_tree(name):
    cfg = get_reduced(name)
    want = np_tree(JM.init_model(jax_get_reduced(name),
                                 jax.random.PRNGKey(0)))
    got = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = M.tree_map(lambda a: (tuple(a.shape),
                                   str(a.dtype).removeprefix("torch.")), got)
    assert shapes == jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
    again = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    M.tree_map(lambda a, b: assert_equal(a, b), got, again)   # seeded
    w = {"ssm": lambda: got["layers"]["time_mix"]["wr"],
         "hybrid": lambda: got["mamba"]["in_proj"],
         "dense": lambda: got["layers"]["attn"]["wq"]}[cfg.family]().float()
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2 * std * (1 + 2 ** -7)   # cut at 2 sigma
    assert abs(float(w.std()) / std - 0.88) < 0.1            # trunc. normal


def test_configs_and_the_families_not_ported():
    """No family is left unported: every one of the reference's
    ``ARCH_NAMES`` resolves, full and reduced, to the reference's config,
    in its order, and builds a tree; an unknown arch still raises."""
    from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES
    assert ARCH_NAMES == JAX_ARCH_NAMES and len(ARCH_NAMES) == 10
    for name in ARCH_NAMES:
        assert dataclasses.astuple(get_config(name)) == \
            dataclasses.astuple(jax_get_config(name))
        assert dataclasses.astuple(get_reduced(name)) == \
            dataclasses.astuple(jax_get_reduced(name))
        assert M.init_model(get_config(name), None, "meta")
    assert {get_config(n).family for n in ARCH_NAMES} == set(M.FAMILIES)
    with pytest.raises(KeyError, match="unknown arch"):
        get_reduced("gpt-2")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")
    odd = dataclasses.replace(get_reduced("qwen2-1.5b"), family="encoder")
    with pytest.raises(ValueError, match="family 'encoder'"):
        M.init_model(odd, torch.Generator(), "cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("rwkv6-3b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        M.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        M.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--arch", "rwkv6-3b", "--reduced"])
