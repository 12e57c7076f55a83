"""Parity of the port's SNN training side with the JAX reference.

``repro_torch.snn`` (``models``, ``train``, ``quantize``) against
``repro.snn`` on params the JAX package drew, carried across with
``params_from_numpy``, and on the same numpy spike trains:

* ``forward`` / ``layer_spikes`` on feedforward and recurrent nets, with
  the hardware's delay and without: every layer's spike train is equal
  to the reference's at these seeds; currents and potentials, replayed
  step by step through the port's kernel wrappers, agree with the
  reference's at rtol 1e-5 / atol 1e-6;
* one training step's loss and gradients against ``jax.value_and_grad``
  of the reference's loss at rtol 1e-4 / atol 1e-6 (another summation
  order in the products, carried through T steps of BPTT);
* ``quantize`` gives identical integer arrays and ``LIFIntParams``;
* ``rate_encode`` statistics; ``train``/``evaluate`` need ``device="cpu"``
  without a card; ``evaluate`` scores as the reference's forward does.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.snn as ref_snn
from repro.snn.models import forward as jax_forward
from repro.snn.train import spike_count_loss as jax_loss
from repro_torch.kernels.lif_update import LIFUpdateFn, lif_update
from repro_torch.kernels.spike_accum import spike_accum
from repro_torch.snn import (MNIST_CONFIG, SHD_CONFIG, LIFParams,
                             QuantConfig, SNNConfig, forward, quantize)
from repro_torch.snn.models import (SNN, init_params, layer_spikes,
                                    params_from_numpy)
from repro_torch.snn.train import (evaluate, loss_and_grads,
                                   make_train_step, rate_encode,
                                   spike_count_loss, train)
from repro_torch.optimizer import AdamConfig, adam_init, adam_update

T, B, N_IN = 12, 4, 40
NETS = {"feedforward": dict(recurrent=False, surrogate="relu", alpha=0.25),
        "recurrent": dict(recurrent=True, surrogate="sigmoid",
                          alpha=0.03125)}


def _configs(net, delayed=True, layer_sizes=(N_IN, 24, 5)):
    kw = NETS[net]
    common = dict(layer_sizes=layer_sizes, recurrent=kw["recurrent"],
                  sparsity=0.5, surrogate=kw["surrogate"], timesteps=T,
                  delayed=delayed)
    return (ref_snn.SNNConfig(lif=ref_snn.LIFParams(alpha=kw["alpha"]),
                              **common),
            SNNConfig(lif=LIFParams(alpha=kw["alpha"]), **common))


def _setup(net, delayed=True, seed=0):
    jcfg, cfg = _configs(net, delayed)
    np_params = {k: np.asarray(v) for k, v in
                 ref_snn.init_params(jcfg, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    spikes = (rng.random((T, B, N_IN)) < 0.3).astype(np.float32)
    labels = rng.integers(0, cfg.layer_sizes[-1], B).astype(np.int32)
    return jcfg, cfg, np_params, spikes, labels


def _jax_replay(np_params, spikes, jcfg):
    """The reference's step, unrolled: per step and layer, (current,
    v_next, spikes), from ``repro.snn.lif.lif_step`` and ``@``."""
    w = ref_snn.masked_weights({k: jnp.asarray(v) for k, v in
                                np_params.items()}, jcfg)
    n = jcfg.n_layers
    vs = [jnp.zeros((B, k)) for k in jcfg.layer_sizes[1:]]
    prev = [jnp.zeros((B, k)) for k in jcfg.layer_sizes[1:]]
    out = []
    for t in range(spikes.shape[0]):
        layer_in, rows = jnp.asarray(spikes[t]), []
        for i in range(n):
            src = layer_in if i == 0 else (prev[i - 1] if jcfg.delayed
                                           else layer_in)
            cur = src @ w[f"w{i}"]
            if jcfg.recurrent and i < n - 1:
                cur = cur + prev[i] @ w[f"wr{i}"]
            v, s = ref_snn.lif_step(vs[i], cur, jcfg.lif, jcfg.surrogate)
            rows.append((cur, v, s))
            layer_in = s
        vs, prev = [r[1] for r in rows], [r[2] for r in rows]
        out.append([tuple(np.asarray(a) for a in r) for r in rows])
    return out


def _port_replay(params, spikes, cfg):
    """The same unrolled step through the port's kernel wrappers."""
    from repro_torch.snn.models import masked_weights
    w = masked_weights(params, cfg)
    n = cfg.n_layers
    vs = [torch.zeros((B, k)) for k in cfg.layer_sizes[1:]]
    prev = [torch.zeros((B, k)) for k in cfg.layer_sizes[1:]]
    out = []
    for t in range(spikes.shape[0]):
        layer_in, rows = torch.from_numpy(spikes[t]), []
        for i in range(n):
            src = layer_in if i == 0 else (prev[i - 1] if cfg.delayed
                                           else layer_in)
            cur = spike_accum(src, w[f"w{i}"])
            if cfg.recurrent and i < n - 1:
                cur = cur + spike_accum(prev[i], w[f"wr{i}"])
            v, s = lif_update(vs[i], cur, alpha=cfg.lif.alpha,
                              v_th=cfg.lif.v_threshold,
                              v_reset=cfg.lif.v_reset)
            rows.append((cur, v, s))
            layer_in = s
        vs, prev = [r[1] for r in rows], [r[2] for r in rows]
        out.append([tuple(a.numpy() for a in r) for r in rows])
    return out


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("delayed", [True, False])
def test_forward_matches_reference(net, delayed):
    jcfg, cfg, np_params, spikes, _ = _setup(net, delayed)
    params = params_from_numpy(np_params, cfg, "cpu")
    want = _jax_replay(np_params, spikes, jcfg)
    counts_ref, out_ref = jax_forward({k: jnp.asarray(v) for k, v in
                                       np_params.items()},
                                      jnp.asarray(spikes), jcfg)
    np.testing.assert_array_equal(np.asarray(out_ref),
                                  np.stack([r[-1][2] for r in want]))

    counts, out = forward(params, torch.from_numpy(spikes.astype(np.uint8)),
                          cfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_ref))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_ref))
    trains = layer_spikes(params, torch.from_numpy(spikes), cfg)
    for i, train_i in enumerate(trains):
        np.testing.assert_array_equal(
            train_i.numpy(), np.stack([r[i][2] for r in want]),
            err_msg=f"layer {i} spikes")
    assert 0 < float(trains[0].mean()) < 1        # the hidden layer fires

    got = _port_replay(params, spikes, cfg)
    for t, (rows_g, rows_w) in enumerate(zip(got, want)):
        for i, ((cur, v, s), (cur_r, v_r, s_r)) in enumerate(
                zip(rows_g, rows_w)):
            what = f"t={t} layer {i}"
            np.testing.assert_allclose(cur, cur_r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} current")
            np.testing.assert_allclose(v, v_r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} potential")
            np.testing.assert_array_equal(s, s_r, err_msg=f"{what} spikes")
            np.testing.assert_array_equal(s, trains[i][t].numpy())


@pytest.mark.parametrize("net", sorted(NETS))
def test_train_step_loss_and_grads_match_reference(net):
    jcfg, cfg, np_params, spikes, labels = _setup(net, seed=3)

    def loss_fn(p):
        counts, _ = jax_forward(p, jnp.asarray(spikes), jcfg)
        return jax_loss(counts, jnp.asarray(labels))

    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    params = params_from_numpy(np_params, cfg, "cpu")
    loss, counts, grads = loss_and_grads(params, torch.from_numpy(spikes),
                                         torch.from_numpy(labels), cfg)
    assert sorted(grads) == sorted(k for k in np_params
                                   if not k.startswith("mask"))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    for k, g in grads.items():
        g_ref = np.asarray(grads_ref[k])
        assert np.abs(g_ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    # the step: Adam over the trainable entries, masks untouched
    opt = AdamConfig(lr=1e-3)
    trainable = {k: v for k, v in params.items() if not k.startswith("mask")}
    step = make_train_step(cfg, opt, encode=False)
    new, state, loss2, acc = step(params, adam_init(trainable, opt),
                                  torch.from_numpy(spikes),
                                  torch.from_numpy(labels))
    want, _ = adam_update(grads, adam_init(trainable, opt), trainable, opt)
    assert float(loss2) == float(loss) and state.step == 1
    assert float(acc) == float((counts.argmax(-1).numpy() == labels).mean())
    for k, v in params.items():
        if k.startswith("mask"):
            assert new[k] is v
        else:
            assert torch.equal(new[k], want[k]) and not torch.equal(new[k], v)


def _grad_fn_names(node) -> list[str]:
    """The autograd nodes feeding ``node``, by class name."""
    return [type(f).__name__ for f, _ in node.next_functions
            if f is not None]


def test_shd_shaped_srnn_spikes_and_grads_match_reference():
    """The SHD SRNN's shape cut to a few neurons (recurrent, SHD's leak,
    sparsity and sigmoid surrogate, T = 6) through ``layer_spikes``:
    every layer's spikes equal the reference's, the gradients of the
    spike-count loss within rtol 1e-4 / atol 1e-6 (as above). The hidden
    layer's two currents reach the LIF step as two planes (no separate
    add in the graph), and the backward runs the LIF step's backward
    once per step and layer the loss depends on: with the hardware's
    delay a hidden layer's last step feeds nothing, so n T - n (n-1) / 2
    of them for n layers."""
    common = dict(layer_sizes=(70, 30, 20), recurrent=True,
                  sparsity=SHD_CONFIG.sparsity, surrogate="sigmoid",
                  timesteps=6)
    jcfg = ref_snn.SNNConfig(lif=ref_snn.LIFParams(alpha=0.03125), **common)
    cfg = SNNConfig(lif=SHD_CONFIG.lif, **common)
    np_params = {k: np.asarray(v) for k, v in
                 ref_snn.init_params(jcfg, jax.random.PRNGKey(2)).items()}
    rng = np.random.default_rng(2)
    spikes = (rng.random((6, 3, 70)) < 0.35).astype(np.float32)
    labels = rng.integers(0, 20, 3).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}

    def loss_fn(p):
        return jax_loss(jax_forward(p, jnp.asarray(spikes), jcfg)[0],
                        jnp.asarray(labels))

    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(jp)
    want = _jax_replay_trains(np_params, spikes, jcfg)

    params = params_from_numpy(np_params, cfg, "cpu")
    trained = {k: v.requires_grad_() for k, v in params.items()
               if not k.startswith("mask")}
    trains = layer_spikes(params, torch.from_numpy(spikes), cfg)
    for i, (got, w) in enumerate(zip(trains, want)):
        np.testing.assert_array_equal(got.detach().numpy(), w,
                                      err_msg=f"layer {i}")
    assert 0 < float(trains[0].detach().mean()) < 1
    assert float(trains[1].detach().sum()) > 0
    # the hidden layer's LIF step takes both currents, the output's one
    hidden = trains[0].grad_fn.next_functions[-1][0]     # step T-1, layer 0
    output = trains[1].grad_fn.next_functions[-1][0]
    assert _grad_fn_names(hidden) == ["LIFUpdateFnBackward",
                                      "SpikeAccumFnBackward",
                                      "SpikeAccumFnBackward"]
    assert _grad_fn_names(output) == ["LIFUpdateFnBackward",
                                      "SpikeAccumFnBackward"]

    mod = sys.modules[LIFUpdateFn.__module__]
    real_ref, calls = mod.lif_update_bwd_ref, []

    def spy(*args):
        calls.append(1)
        return real_ref(*args)

    loss = spike_count_loss(trains[-1].sum(0), torch.from_numpy(labels))
    mod.lif_update_bwd_ref = spy
    try:
        grads = torch.autograd.grad(loss, list(trained.values()))
    finally:
        mod.lif_update_bwd_ref = real_ref
    n = cfg.n_layers
    assert len(calls) == n * 6 - n * (n - 1) // 2
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    for k, g in zip(trained, grads):
        g_ref = np.asarray(grads_ref[k])
        assert np.abs(g_ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _jax_replay_trains(np_params, spikes, jcfg) -> list[np.ndarray]:
    """Every layer's spike train of the reference's forward, [T, B, n]."""
    w = ref_snn.masked_weights({k: jnp.asarray(v) for k, v in
                                np_params.items()}, jcfg)
    n, b = jcfg.n_layers, spikes.shape[1]
    vs = [jnp.zeros((b, k)) for k in jcfg.layer_sizes[1:]]
    prev = [jnp.zeros((b, k)) for k in jcfg.layer_sizes[1:]]
    trains = [[] for _ in range(n)]
    for t in range(spikes.shape[0]):
        layer_in = jnp.asarray(spikes[t])
        for i in range(n):
            src = layer_in if i == 0 else prev[i - 1]
            cur = src @ w[f"w{i}"]
            if jcfg.recurrent and i < n - 1:
                cur = cur + prev[i] @ w[f"wr{i}"]
            vs[i], s = ref_snn.lif_step(vs[i], cur, jcfg.lif, jcfg.surrogate)
            trains[i].append(np.asarray(s))
            layer_in = s
        prev = [tr[-1] for tr in trains]
    return [np.stack(tr) for tr in trains]


def test_train_from_carried_params_on_cpu():
    """``train(params=...)`` starts where the reference's params are: its
    first loss is the reference's loss there."""
    jcfg, cfg, np_params, spikes, labels = _setup("recurrent", seed=4)
    loss_ref = jax_loss(jax_forward({k: jnp.asarray(v) for k, v in
                                     np_params.items()},
                                    jnp.asarray(spikes), jcfg)[0],
                        jnp.asarray(labels))

    def data():
        while True:
            yield spikes, labels

    res = train(cfg, data(), 3, lr=1e-2, encode=False, device="cpu",
                params=params_from_numpy(np_params, cfg, "cpu"))
    assert len(res.loss_history) == 3 and res.wall_seconds > 0
    np.testing.assert_allclose(res.loss_history[0], float(loss_ref),
                               rtol=1e-4)
    assert res.loss_history[-1] < res.loss_history[0]
    for k, v in np_params.items():
        same = np.array_equal(res.params[k].numpy(), v)
        assert same == k.startswith("mask"), k


def test_evaluate_scores_as_the_reference():
    jcfg, cfg, np_params, _, _ = _setup("recurrent", seed=6)
    rng = np.random.default_rng(6)
    xs = (rng.random((10, T, N_IN)) < 0.3).astype(np.uint8)   # [N, T, n]
    ys = rng.integers(0, 5, 10).astype(np.int32)
    counts, _ = jax_forward({k: jnp.asarray(v) for k, v in
                             np_params.items()},
                            jnp.asarray(xs.transpose(1, 0, 2), jnp.float32),
                            jcfg)
    want = float((np.asarray(counts).argmax(-1) == ys).mean())
    got = evaluate(params_from_numpy(np_params, cfg, "cpu"), cfg, xs, ys,
                   encode=False, batch=3, device="cpu")
    assert got == want


def test_quantize_matches_reference():
    jcfg, cfg, np_params, _, _ = _setup("recurrent", seed=7)
    for bits in (4, 7):
        want = ref_snn.quantize({k: jnp.asarray(v) for k, v in
                                 np_params.items()}, jcfg,
                                ref_snn.QuantConfig(bits, 12))
        got = quantize(params_from_numpy(np_params, cfg, "cpu"), cfg,
                       QuantConfig(bits, 12))
        assert got.scale == want.scale and tuple(got.lif) == tuple(want.lif)
        assert got.layer_sizes == want.layer_sizes
        for a, b in zip(got.weights + got.rec_weights,
                        want.weights + want.rec_weights):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
        assert (got.sparsity, got.n_unique_weights, got.n_total_synapses) \
            == (want.sparsity, want.n_unique_weights, want.n_total_synapses)


def test_configs_and_init_match_reference():
    for mine, ref in ((MNIST_CONFIG, ref_snn.MNIST_CONFIG),
                      (SHD_CONFIG, ref_snn.SHD_CONFIG)):
        assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    cfg = dataclasses.replace(SHD_CONFIG, layer_sizes=(70, 30, 2))
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = ref_snn.init_params(
        ref_snn.SNNConfig(layer_sizes=(70, 30, 2), recurrent=True,
                          sparsity=cfg.sparsity), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert float(p["maskr0"].diagonal().abs().sum()) == 0.0     # no self-loops
    assert abs(float(p["mask0"].mean()) - (1 - cfg.sparsity)) < 0.03
    assert torch.equal(p["w0"], init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["w0"])


def test_module_holds_weights_as_parameters_and_masks_as_buffers():
    _, cfg, np_params, spikes, _ = _setup("recurrent")
    params = params_from_numpy(np_params, cfg, "cpu")
    model = SNN(cfg, params)
    assert sorted(n for n, _ in model.named_parameters()) == ["w0", "w1",
                                                              "wr0"]
    assert sorted(n for n, _ in model.named_buffers()) == ["mask0", "mask1",
                                                           "maskr0"]
    counts, out = model(torch.from_numpy(spikes))
    want = forward(params, torch.from_numpy(spikes), cfg)
    assert torch.equal(counts, want[0]) and torch.equal(out, want[1])
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in np_params.items()
                           if k != "wr0"}, cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({**np_params, "w1": np_params["w1"][:3]}, cfg,
                          "cpu")


def test_rate_encode_statistics_and_loss():
    img = torch.full((4, 10), 0.3)
    spikes = rate_encode(img, 200, torch.Generator().manual_seed(0))
    assert spikes.shape == (200, 4, 10) and spikes.dtype == torch.float32
    assert abs(float(spikes.mean()) - 0.3) < 0.03
    assert torch.equal(spikes, rate_encode(img, 200,
                                           torch.Generator().manual_seed(0)))
    counts = np.random.default_rng(0).random((6, 5)).astype(np.float32) * 4
    labels = np.arange(6, dtype=np.int32) % 5
    np.testing.assert_allclose(
        float(spike_count_loss(torch.from_numpy(counts),
                               torch.from_numpy(labels))),
        float(jax_loss(jnp.asarray(counts), jnp.asarray(labels))), rtol=1e-6)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, np_params, spikes, labels = _setup("feedforward")

    def data():
        while True:
            yield spikes, labels

    with pytest.raises(RuntimeError, match='device="cpu"'):
        train(cfg, data(), 1, lr=1e-3, encode=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluate(params_from_numpy(np_params, cfg, "cpu"), cfg, spikes[0],
                 labels)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        params_from_numpy(np_params, cfg)
