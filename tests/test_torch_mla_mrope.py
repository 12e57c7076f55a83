"""The port's MLA, M-RoPE, sinusoidal positions and codebook embedding
and heads against the JAX package's, one layer at a time on the CPU.

The reference's parameters (norm scales drawn from a seed, as
``tests/test_torch_dense.py``'s ``perturb`` draws them, so a wrong
scale path shows) are carried in as numpy arrays. Tolerances: float32
inputs within rtol = atol = 1e-5 (``ONE``); a bf16 cache leaf within one
bf16 ulp (``BF16_LEAF``); bf16 inputs keep their dtype and are held to
the float32 truth no worse than ``BF16_NOISE`` times the reference's own
bf16 error (``tests/test_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_dense import ONE, as_f32, bf16, check_noise, jtree, perturb
from test_torch_families import mrope_streams, tokens_of
from test_torch_lm import BF16_LEAF, F32, f32, np_tree, to_torch

B, PROMPT, S = 2, 8, 12


def _mla_case():
    jcfg = jax_get_reduced("deepseek-v3-671b")
    p = perturb(np_tree(JL.init_mla(jcfg, jax.random.PRNGKey(3))))
    x = np.random.default_rng(4).normal(
        0, 1, (B, PROMPT + 2, jcfg.d_model)).astype(np.float32)
    return jcfg, get_reduced("deepseek-v3-671b"), p, x


def _jax_mla(jcfg, p, x):
    """Prefill x[:, :PROMPT] with its (latent, k_rope) cache, then a
    2-token absorbed decode into a grown cache."""
    mla = jax.jit(JL.mla_attention, static_argnames=("cfg", "return_kv"))
    xj = jnp.asarray(x)
    out, (lat, kr) = mla(jtree(p), xj[:, :PROMPT], jcfg,
                         positions=jnp.arange(PROMPT), return_kv=True)
    cap = x.shape[1] + 2
    c_lat = jnp.zeros((B, cap, lat.shape[-1]), jnp.bfloat16).at[
        :, :PROMPT].set(lat)
    c_kr = jnp.zeros((B, cap, kr.shape[-1]), jnp.bfloat16).at[
        :, :PROMPT].set(kr)
    out_d, (c_lat, c_kr) = mla(jtree(p), xj[:, PROMPT:], jcfg,
                               positions=PROMPT + jnp.arange(2),
                               kv_cache=(c_lat, c_kr),
                               cache_len=jnp.int32(PROMPT))
    return [np.asarray(a) for a in (out, lat, kr, out_d, c_lat, c_kr)]


def _port_mla(cfg, p, x):
    pt, xt = to_torch(p), to_torch(x)
    out, (lat, kr) = L.mla_attention(pt, xt[:, :PROMPT], cfg,
                                     positions=torch.arange(PROMPT),
                                     return_kv=True)
    cap = x.shape[1] + 2
    c_lat = torch.zeros((B, cap, lat.shape[-1]), dtype=torch.bfloat16)
    c_lat[:, :PROMPT] = lat
    c_kr = torch.zeros((B, cap, kr.shape[-1]), dtype=torch.bfloat16)
    c_kr[:, :PROMPT] = kr
    out_d, cache = L.mla_attention(
        pt, xt[:, PROMPT:], cfg, positions=PROMPT + torch.arange(2),
        kv_cache=(c_lat, c_kr),
        cache_len=torch.tensor(PROMPT, dtype=torch.int32))
    assert cache[0] is c_lat and cache[1] is c_kr    # written in place
    return [out, lat, kr, out_d, c_lat, c_kr]


def test_mla_prefill_and_absorbed_decode_match_the_reference():
    """Float32 inputs with the norm scales drawn: the prefill's output
    and (latent, k_rope) cache, then a 2-token absorbed decode; then the
    same on bf16 inputs, no noisier than the reference."""
    jcfg, cfg, p, x = _mla_case()
    want = _jax_mla(jcfg, as_f32(p), x)
    got = _port_mla(cfg, as_f32(p), x)
    for what, g, w in zip(("out", "latent", "k_rope", "decode out",
                           "latent cache", "k_rope cache"), got, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, what
        tol = BF16_LEAF if w.dtype.name == "bfloat16" else ONE
        np.testing.assert_allclose(f32(g), f32(w), err_msg=what, **tol)
    ref16 = _jax_mla(jcfg, p, bf16(x))
    got16 = _port_mla(cfg, p, bf16(x))
    assert [g.dtype for g in got16] == [torch.bfloat16] * 6
    check_noise(got16[0], ref16[0], want[0], "MLA prefill out")
    check_noise(got16[3], ref16[3], want[3], "MLA decode out")


def test_mrope_matches_the_reference():
    """Three different position streams over the (4, 2, 2) sections of
    a head of 16; 1-D RoPE where ``mrope_sections`` is None."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, S, 4, 16)).astype(np.float32)
    pos = mrope_streams(B, S)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, None,
                         (4, 2, 2))
    got = L.apply_rope(to_torch(x), to_torch(pos), 1e6, None, (4, 2, 2))
    np.testing.assert_allclose(f32(got), np.asarray(want), **ONE)
    one_d = L.apply_rope(to_torch(x), to_torch(pos[0]), 1e6)
    assert np.abs(f32(one_d) - np.asarray(want)).max() > 1e-2
    with pytest.raises(ValueError, match="M-RoPE"):
        L.apply_rope(to_torch(x), to_torch(pos[0]), 1e6, None, (4, 2, 2))
    got16 = L.apply_rope(to_torch(bf16(x)), to_torch(pos), 1e6, None,
                         (4, 2, 2))
    assert got16.dtype == torch.bfloat16


def test_sinusoidal_positions_match_the_reference():
    """The static table bit for bit (the same numpy); the dynamic one
    within ``ONE`` for positions below 64, and up to 2047 within two
    ulps of the angle, 2048 * 2^-22: its float32 ``10000^(i/d)`` differs
    from XLA's by one ulp in 13 of musicgen's 768 frequencies."""
    got = L.sinusoidal_positions(40, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.sinusoidal_positions(40, 64)))
    pos = np.arange(2048, dtype=np.int32).reshape(2, 1024)
    want = np.asarray(JM._sinusoidal(jnp.asarray(pos), 1536))
    got = M._sinusoidal(to_torch(pos), 1536).numpy()
    np.testing.assert_allclose(got[0, :64], want[0, :64], **ONE)
    np.testing.assert_allclose(got, want, rtol=0, atol=2048 * 2 ** -22)


def test_codebook_embedding_and_heads():
    """K tables summed with the sinusoid (decode positions after the
    cache), K heads out: the reference's, in float32 and in bf16."""
    jcfg, cfg = (f("musicgen-medium") for f in (jax_get_reduced,
                                                 get_reduced))
    tree = np_tree(JM.init_model(jcfg, jax.random.PRNGKey(0)))
    toks = tokens_of(cfg, s=5)
    pos = np.arange(7, 12)
    for dtype in ("float32", "bfloat16"):
        p = as_f32(tree) if dtype == "float32" else tree
        params = M.params_from_numpy(p, cfg, "cpu")
        want = np.asarray(JM.embed_tokens(jtree(p), jcfg, jnp.asarray(toks),
                                          jnp.asarray(pos)))
        got = M.embed_tokens(params, cfg, to_torch(toks), to_torch(pos))
        assert str(got.dtype).removeprefix("torch.") == dtype
        tol = ONE if dtype == "float32" else BF16_LEAF
        np.testing.assert_allclose(f32(got), f32(want), **tol)
        logits = M.unembed_hidden(params, cfg, got)
        assert logits.shape == (B, 5, cfg.n_codebooks, cfg.vocab_size)
        np.testing.assert_allclose(
            f32(logits), np.asarray(JM.unembed_hidden(
                jtree(p), jcfg, jnp.asarray(got.float().numpy()))), **F32)
