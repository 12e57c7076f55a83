"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's, at reduced size on the CPU.

The reference's ``init_moe`` parameters are carried into the port as
numpy arrays. The port computes the dispatch and combine as gathers of
rows where the reference contracts one-hot tensors, so every case first
asserts the same routes (top-k indices) and the same capacity drops
(``keep``, from the reference's routes by its own cumulative-sum rule),
then compares values:

* float32 (parameters and input cast): y, aux and every gradient within
  rtol = atol = 2e-4 (``F32``, ``tests/test_torch_lm.py``'s bound);
* bf16: y is held to the float32 truth no worse than ``BF16_NOISE``
  times the reference's own bf16 error (``tests/test_torch_lm.py``);
* the cases of ``tests/test_moe.py`` one to one: top-k normalised (and
  the reference's tie-break), the group size divides (every t up to
  4096), grouping invariance with ample capacity, a deterministic merge
  (two calls, the same bits), capacity drops at ``capacity_factor=0.1``,
  and the balance loss of a collapsed router above a balanced one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import moe as JMOE
from repro_torch.configs import get_reduced
from repro_torch.models import moe as MOE
from test_torch_lm import BF16_NOISE, F32, f32, np_tree, to_torch

QWEN, DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v3-671b"


def configs(name: str, **moe):
    """The reduced config of both packages, with ``moe`` fields replaced."""
    jcfg, cfg = jax_get_reduced(name), get_reduced(name)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return jcfg, cfg


def draw(jcfg, b=2, s=16, seed=1):
    p = np_tree(JMOE.init_moe(jcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(seed).normal(
        0, 1, (b, s, jcfg.d_model)).astype(np.float32)
    return p, x


def as_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def jax_routes(jcfg, p, x, group_size=None):
    """The reference's top-k indices [G, T_g, k] and, by its cumulative
    sum over the one-hot routes, the keep mask."""
    mo = jcfg.moe
    t = x.shape[0] * x.shape[1]
    tg = group_size or JMOE._pick_group_size(t)
    xt = jnp.asarray(x).reshape(t // tg, tg, -1).astype(jnp.float32)
    _, idx = JMOE.route_topk(xt @ jnp.asarray(p["router"]), mo.top_k)
    idx = np.asarray(idx)
    g = idx.shape[0]
    flat = idx.reshape(g, -1)
    onehot = flat[..., None] == np.arange(mo.n_experts)
    pos = np.take_along_axis(np.cumsum(onehot, 1) - 1, flat[..., None], 2)
    cap = max(int(mo.capacity_factor * tg * mo.top_k / mo.n_experts), 4)
    return idx, (pos[..., 0] < cap).reshape(idx.shape)


def port_routes(cfg, p, x, group_size=None):
    t = x.shape[0] * x.shape[1]
    tg = group_size or MOE._pick_group_size(t)
    xt = to_torch(np.asarray(x)).reshape(t // tg, tg, -1)
    _, idx, _, keep, _, _ = MOE._plan(to_torch(p), xt, cfg)
    return idx.numpy(), keep.numpy()


def assert_same_routes(jcfg, cfg, p, x, group_size=None):
    want_idx, want_keep = jax_routes(jcfg, p, x, group_size)
    got_idx, got_keep = port_routes(cfg, p, x, group_size)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_keep, want_keep)
    return want_keep


def run_both(jcfg, cfg, p, x, group_size=None):
    want = JMOE.moe_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                        group_size=group_size)
    got = MOE.moe_mlp(to_torch(p), to_torch(np.asarray(x)), cfg,
                      group_size=group_size)
    return got, want


# -- routing -----------------------------------------------------------------


def test_route_topk_normalized():
    logits = np.random.default_rng(0).normal(0, 1, (32, 8)).astype(np.float32)
    w, idx = MOE.route_topk(torch.from_numpy(logits), 3)
    jw, jidx = JMOE.route_topk(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **F32)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    ref = np.argsort(-logits, axis=-1)[:, :3]
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(ref, -1))
    # ties go to the lower expert index, as jax.lax.top_k's
    tied = np.zeros((3, 8), np.float32)
    tied[:, 5] = 1.0
    _, idx = MOE.route_topk(torch.from_numpy(tied), 3)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(JMOE.route_topk(jnp.asarray(tied), 3)[1]))
    assert idx[0].tolist() == [5, 0, 1]


def test_pick_group_size_divides():
    for t in range(1, 4097):
        g = MOE._pick_group_size(t)
        assert g == JMOE._pick_group_size(t)
        assert t % g == 0 and 1 <= g <= 2048


# -- the layer ---------------------------------------------------------------


@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
@pytest.mark.parametrize("group_size", [None, 8])
def test_moe_mlp_float32_matches_the_reference(name, group_size):
    """qwen3-moe (no shared expert) and deepseek-v3 (one shared expert),
    one group of 32 tokens or four of 8."""
    jcfg, cfg = configs(name)
    p, x = draw(jcfg)
    p = as_f32(p)
    assert ("shared" in p) == (name == DEEPSEEK)
    keep = assert_same_routes(jcfg, cfg, p, x, group_size)
    assert keep.all()                          # E / k capacity: no drop
    (y, aux), (jy, jaux) = run_both(jcfg, cfg, p, x, group_size)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(f32(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


@pytest.mark.parametrize("name", [QWEN, DEEPSEEK])
def test_moe_mlp_bf16_no_noisier_than_the_reference(name):
    jcfg, cfg = configs(name)
    p, x = draw(jcfg)
    truth = np.asarray(JMOE.moe_mlp(jax.tree.map(jnp.asarray, as_f32(p)),
                                    jnp.asarray(bf16(x).astype(np.float32)),
                                    jcfg)[0])
    assert_same_routes(jcfg, cfg, p, bf16(x))
    (y, _), (jy, _) = run_both(jcfg, cfg, p, bf16(x))
    assert y.dtype == torch.bfloat16
    err, ref_err = (np.abs(f32(a) - truth).max() for a in (y, jy))
    assert err <= BF16_NOISE * ref_err + 1e-3, (err, ref_err)


@pytest.mark.parametrize("name,cf", [(QWEN, 4.0), (DEEPSEEK, 0.5)])
def test_moe_gradients_match_the_reference(name, cf):
    """Every parameter's and the input's gradient of sum(y * r) + aux in
    float32, through the gathers' own backward; with drops (deepseek at
    capacity_factor 0.5) too."""
    jcfg, cfg = configs(name, capacity_factor=cf)
    p, x = draw(jcfg)
    p = as_f32(p)
    keep = assert_same_routes(jcfg, cfg, p, x)
    assert keep.all() == (cf == 4.0)
    r = np.random.default_rng(2).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JMOE.moe_mlp(p, x, jcfg)
        return jnp.sum(y * r) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: to_torch(a).requires_grad_(), p)
    tx = to_torch(x).requires_grad_()
    y, aux = MOE.moe_mlp(tp, tx, cfg)
    (torch.sum(y * to_torch(r)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **F32)
    for (path, g), (_, jg) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t.grad.numpy(), tp))[0],
            jax.tree_util.tree_flatten_with_path(jg_p)[0]):
        np.testing.assert_allclose(g, np.asarray(jg), err_msg=str(path),
                                   **F32)


def test_moe_grouping_invariance_when_capacity_ample():
    """With no-drop capacity the group decomposition does not change the
    result; each grouping is also the reference's."""
    jcfg, cfg = configs(QWEN)
    p, x = draw(jcfg)
    x = bf16(x)
    ys = []
    for gs in (32, 8):
        assert_same_routes(jcfg, cfg, p, x, gs)
        (y, _), (jy, _) = run_both(jcfg, cfg, p, x, gs)
        np.testing.assert_allclose(f32(y), f32(jy), rtol=3e-2, atol=3e-2)
        ys.append(f32(y))
    np.testing.assert_allclose(ys[0], ys[1], rtol=3e-2, atol=3e-2)


def test_moe_deterministic_merge():
    """Two identical calls give the same bits (the reference's
    fixed-order merge; here gathers, no atomic adds)."""
    jcfg, cfg = configs(QWEN)
    p, x = draw(jcfg)
    a, b = (MOE.moe_mlp(to_torch(p), to_torch(bf16(x)), cfg)[0]
            for _ in range(2))
    assert torch.equal(a, b)


def test_moe_capacity_drops_tokens():
    """capacity_factor 0.1 (capacity 4 of 32 x 2 routes per expert): the
    reference's keep mask, its output, and a smaller norm than with E/k
    capacity (dropped routes add nothing)."""
    jcfg, cfg = configs(QWEN, capacity_factor=4.0)
    p, x = draw(jcfg, s=32)
    y_full = MOE.moe_mlp(to_torch(p), to_torch(bf16(x)), cfg)[0]
    jsq, sq = configs(QWEN, capacity_factor=0.1)
    keep = assert_same_routes(jsq, sq, p, bf16(x))
    assert 0 < keep.mean() < 0.5
    (y_drop, _), (jy, _) = run_both(jsq, sq, as_f32(p), x)
    np.testing.assert_allclose(f32(y_drop), np.asarray(jy), **F32)
    y_drop = MOE.moe_mlp(to_torch(p), to_torch(bf16(x)), sq)[0]
    assert float(y_drop.float().abs().sum()) < \
        float(y_full.float().abs().sum())
    # a token none of whose routes is kept gets exactly 0
    dropped = ~keep.reshape(-1, 2).any(-1)
    assert dropped.any()
    assert not f32(y_drop).reshape(-1, cfg.d_model)[dropped].any()


def test_moe_aux_loss_balanced_vs_collapsed():
    """The load-balance loss penalizes a collapsed router, in both
    packages alike."""
    jcfg, cfg = configs(QWEN)
    p, x = draw(jcfg, s=32)
    x = bf16(x)
    (_, aux_b), (_, jaux_b) = run_both(jcfg, cfg, p, x)
    collapsed = dict(p)
    router = np.zeros(p["router"].shape, np.float32)
    router[:, 0] = 50.0                         # everything to expert 0
    collapsed["router"] = router
    assert_same_routes(jcfg, cfg, collapsed, x)
    (_, aux_c), (_, jaux_c) = run_both(jcfg, cfg, collapsed, x)
    np.testing.assert_allclose(float(aux_b), float(jaux_b), **F32)
    np.testing.assert_allclose(float(aux_c), float(jaux_c), **F32)
    assert float(aux_c) > float(aux_b)


def test_init_moe_tree_and_seeding():
    jcfg, cfg = configs(DEEPSEEK)
    want = np_tree(JMOE.init_moe(jcfg, jax.random.PRNGKey(0)))
    got = MOE.init_moe(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    shapes = jax.tree.map(lambda a: (tuple(a.shape),
                                     str(a.dtype).removeprefix("torch.")),
                          got)
    assert shapes == jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
    again = MOE.init_moe(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(f32(a), f32(b)),
                 got, again)
    assert dataclasses.astuple(cfg.moe) == dataclasses.astuple(jcfg.moe)
