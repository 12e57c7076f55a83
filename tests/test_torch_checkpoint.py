"""The port's checkpoints, straggler monitor, step journal and training
CLI (``repro_torch.distributed``, ``repro_torch.launch.train``) against
the JAX package's, on the CPU.

The cases of ``tests/test_distributed.py`` (roundtrip, corruption,
uncommitted directories, async retention, the monitor, the journal's
torn tail) run against the port. Either package restores the other's
checkpoint of a reduced qwen2-1.5b's ``(params, opt_state)`` after one
Adam step: the same leaf paths, shapes, dtypes (bf16 included) and
values, bit for bit. The CLI runs as ``tests/test_launchers.py`` runs
the reference's, with ``--device cpu``; a run the reference started is
resumed by the port, and its losses are held to the reference resuming
the same run within ``RESUME_RTOL``: the models' bf16 parameters, so
two frameworks' losses differ by bf16 rounding (``BF16_LOSS_RTOL`` of
``tests/test_torch_lm_train.py``).
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.distributed import checkpoint as JC
from repro.launch.train import main as jax_main
from repro.models import model as JM
from repro.optimizer.adam import adam_update as jax_adam_update
from repro.train.steps import TrainHParams as JaxTrainHParams
from repro.train.steps import _adam_cfg as jax_adam_cfg
from repro.train.steps import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_reduced
from repro_torch.distributed import checkpoint as C
from repro_torch.distributed import (CheckpointManager, StepJournal,
                                     StragglerMonitor, latest_step,
                                     load_checkpoint, save_checkpoint)
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models.model import tree_map
from repro_torch.optimizer.adam import AdamState
from repro_torch.train.steps import TrainHParams, init_opt_state
from test_torch_lm_train import BF16_LOSS_RTOL

RESUME_RTOL = BF16_LOSS_RTOL


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((16, 8), generator=g),
                       "b": torch.zeros((8,)),
                       "h": torch.randn((4, 8), generator=g).bfloat16()},
            "step_count": 7}


def _zeros_like(tree):
    return {"layers": tree_map(torch.zeros_like, tree["layers"]),
            "step_count": 0}


def _same(a, b) -> None:
    assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, n_shards=2, extra={"loss": 1.5})
    assert latest_step(str(tmp_path)) == 3
    restored, extra = load_checkpoint(str(tmp_path), None, _zeros_like(t))
    assert extra["loss"] == 1.5
    tree_map(_same, restored["layers"], t["layers"])
    assert restored["step_count"] == 7 and type(restored["step_count"]) is int


def test_checkpoint_detects_corruption(tmp_path):
    t = _tree()
    d = save_checkpoint(str(tmp_path), 1, t)
    shard = os.path.join(d, "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(AssertionError, match="hash mismatch"):
        load_checkpoint(str(tmp_path), 1, _zeros_like(t))


def test_checkpoint_uncommitted_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_000000005")   # a crash mid-save
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, blocking=True)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(steps) == 2 and steps[-1].endswith("4")
    restored, _ = mgr.restore(_zeros_like(t))
    _same(restored["layers"]["w"], t["layers"]["w"])


def test_checkpoint_manager_snapshots_and_surfaces_errors(tmp_path,
                                                          monkeypatch):
    """``save`` copies the tree before it returns (an in-place update
    after it is not saved); a failed write raises on the next ``wait``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    want = t["layers"]["w"].clone()
    mgr.save(1, t)
    t["layers"]["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(_zeros_like(t))
    _same(restored["layers"]["w"], want)

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(C.np, "savez", broken)
    mgr.save(2, t)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                 # raised once
    assert latest_step(str(tmp_path)) == 1


def test_straggler_monitor_flags_persistent_slowdowns():
    mon = StragglerMonitor(window=8, threshold=2.0, hysteresis=2)
    fired = []
    for i in range(12):
        mon.start_step()
        mon._t0 -= 0.01                 # simulate 10 ms steps
        if i >= 10:
            mon._t0 -= 0.05             # 6x slowdown
        fired.append(mon.end_step(i))
    assert fired[11] and not any(fired[:10])
    assert mon.summary()["straggler_events"] >= 2


def test_journal_replay(tmp_path):
    j = StepJournal(str(tmp_path / "j.jsonl"))
    for s in range(5):
        j.record(s, data_offset=s * 128, seed=0, checkpoint_step=s - s % 2)
    rp = j.replay_point()
    assert rp["step"] == 4 and rp["data_offset"] == 512
    with open(tmp_path / "j.jsonl", "a") as f:   # a torn tail write
        f.write('{"step": 5, "data_off')
    assert j.replay_point()["step"] == 4


# -- either package restores the other's checkpoint ---------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def trained(request):
    """A reduced qwen2-1.5b (d_ff 256: int8 moments where asked) after one
    Adam step in the reference: (params, opt_state) as jax arrays."""
    jcfg = dataclasses.replace(jax_get_reduced("qwen2-1.5b"), d_ff=256)
    params = JM.init_model(jcfg, jax.random.PRNGKey(0))
    hp = JaxTrainHParams(quantized_opt_state=request.param)
    opt = jax_init_opt_state(params, hp)
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)), jnp.int32)
    grads = jax.grad(lambda p: JM.loss_fn(p, jcfg, {
        "tokens": tokens, "labels": tokens})[0])(params)
    params, opt = jax_adam_update(grads, opt, params, jax_adam_cfg(hp))
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), d_ff=256)
    return cfg, params, opt, request.param


def _port_like(cfg, quantized: bool):
    params = M.init_model(cfg, torch.Generator().manual_seed(9), "cpu")
    return params, init_opt_state(params, TrainHParams(
        quantized_opt_state=quantized))


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _assert_same_items(got, want) -> None:
    """The same paths, shapes, dtypes and bits (ints as int32 arrays)."""
    g = dict(C._items(got))
    w = dict(zip(JC._tree_paths(want), jax.tree.leaves(want)))
    assert g.keys() == w.keys()
    for k in w:
        a, b = g[k], w[k]
        if isinstance(a, int):
            assert _dtype(b) == "int32" and a == int(b), k
            continue
        assert (tuple(a.shape), _dtype(a)) == (np.shape(b), _dtype(b)), k
        np.testing.assert_array_equal(_as_np(a), _as_np(b), err_msg=k)


def test_port_restores_a_reference_checkpoint(tmp_path, trained):
    cfg, params, opt, quantized = trained
    JC.save_checkpoint(str(tmp_path), 1, (params, opt), extra={"loss": 2.5})
    (p, o), extra = load_checkpoint(str(tmp_path), None,
                                    _port_like(cfg, quantized))
    assert extra == {"loss": 2.5} and isinstance(o, AdamState)
    assert o.step == 1 and (o.m_scale is None) == (not quantized)
    _assert_same_items((p, o), (params, opt))


def test_reference_restores_a_port_checkpoint(tmp_path, trained):
    """The port saves what it restored of the reference's checkpoint; the
    reference restores it, and both manifests are the same but for the
    shard hashes (npz member order and timestamps differ)."""
    cfg, params, opt, quantized = trained
    for d in ("ref", "port"):
        os.makedirs(tmp_path / d)
    JC.save_checkpoint(str(tmp_path / "ref"), 1, (params, opt))
    (p, o), _ = load_checkpoint(str(tmp_path / "ref"), None,
                                _port_like(cfg, quantized))
    save_checkpoint(str(tmp_path / "port"), 1, (p, o))
    like = jax.tree.map(jnp.zeros_like, (params, opt))
    (jp, jo), _ = JC.load_checkpoint(str(tmp_path / "port"), None, like)
    _assert_same_items((p, o), (jp, jo))
    with open(tmp_path / "port" / "step_000000001" / "manifest.json") as f:
        port_manifest = json.load(f)
    with open(tmp_path / "ref" / "step_000000001" / "manifest.json") as f:
        ref_manifest = json.load(f)
    for m in (port_manifest, ref_manifest):
        del m["shard_hash"]
    assert port_manifest == ref_manifest


# -- the training CLI ----------------------------------------------------------

def test_train_cli_with_checkpoint_and_resume(tmp_path, capsys):
    d = str(tmp_path / "run")
    losses = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "8",
                         "--batch", "2", "--seq", "32", "--ckpt-dir", d,
                         "--ckpt-every", "4", "--device", "cpu"])
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 1.5
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_000000000", "step_000000004", "step_000000007"]
    more = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "12",
                       "--batch", "2", "--seq", "32", "--ckpt-dir", d,
                       "--ckpt-every", "4", "--resume", "--device", "cpu"])
    assert len(more) == 12 - 8
    assert "[resume] from checkpoint step 7, data offset 0" in \
        capsys.readouterr().out
    assert latest_step(d) == 11


def test_train_cli_microbatched():
    losses = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
                         "--batch", "4", "--seq", "16", "--micro", "2",
                         "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_synthetic_batch_is_the_reference_stream():
    from repro.launch.train import synthetic_batch as jax_batch
    jcfg, cfg = jax_get_reduced("qwen2-1.5b"), get_reduced("qwen2-1.5b")
    for step, offset in ((0, 0), (5, 3)):
        want = jax_batch(jcfg, 3, 7, step, offset)
        got = train.synthetic_batch(cfg, 3, 7, step, offset)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert got["labels"] is got["tokens"]


def test_port_resumes_a_reference_run(tmp_path):
    """The reference trains 4 steps into a directory; the port resumes
    it to 6, and the reference resumes a copy to 6."""
    args = ["--arch", "qwen2-1.5b", "--reduced", "--batch", "2", "--seq",
            "32", "--ckpt-every", "2"]
    d, copy = str(tmp_path / "run"), str(tmp_path / "copy")
    jax_main(args + ["--steps", "4", "--ckpt-dir", d])
    shutil.copytree(d, copy)
    want = jax_main(args + ["--steps", "6", "--ckpt-dir", copy, "--resume"])
    got = train.main(args + ["--steps", "6", "--ckpt-dir", d, "--resume",
                             "--device", "cpu"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=RESUME_RTOL)
    assert latest_step(d) == 5


def test_train_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])
