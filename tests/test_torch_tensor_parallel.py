"""The ruled steps' compute split (``distributed/tensor_parallel.py``) at
four ranks on the CPU: ONE spawned gloo group of four ``python -c``
workers on a ``FileStore`` runs every check of this module on the meshes
(2, 2) and (1, 4) (data x model) of the same group, and each test reads
its part of the results. The rules are the ``tp_ep`` profile's: the
batch over ``data``, attention, the MLPs and the vocabulary over
``model`` (the tensor axis), the experts over ``model`` (the expert
axis). Reduced qwen2-1.5b (tied head; 4 heads and 2 K/V heads, so the
K/V heads split at tp 2 and each rank holds both at tp 4) and reduced
qwen3-moe-30b-a3b (8 experts: 4 a rank at ep 2, 2 at ep 4).

* float32 parameters, against the one-process plain step from the same
  seed and batch: the loss within ``LOSS_RTOL``, every gradient leaf
  (the embedding and ``ln1`` included) within a relative norm of
  ``GRAD_RTOL``, and the last-token logits of the ruled prefill within
  ``LOGITS_RTOL`` of their largest magnitude (another summation order:
  the row-parallel products summed over ranks, the experts' partial
  outputs summed over ranks, the log-sum-exp over vocabulary shards);
* bf16 parameters, two ruled train steps against two plain ones, held
  to ``tests/test_torch_ranks.py``'s ``LOSS_RTOL_FIRST``, ``LOSS_RTOL``,
  ``MOMENT_RTOL`` and ``OFF_SHARE``; and two steps with int8 moments of
  a 3-layer, d_model-256 qwen3-moe on (2, 2), whose ``w_down`` moments
  put the experts over ``("model", "data")`` as deepseek-v3's do (the
  ruled step updates such a stack one layer at a time);
* the greedy tokens of a ruled prefill and 4 decode steps (the
  factories called the reference's way, ``make_prefill_step(cfg,
  rules)``, ``make_serve_step(cfg, rules)``) equal the plain ones, and
  each rank's cache holds its batch rows and its K/V heads;
* each rank's local blocks: its q heads, K/V heads, experts and
  vocabulary rows, each the right slice of the global leaf;
* the reference's jitted ``make_train_step(cfg, rules, hp)`` of reduced
  qwen3-moe-30b-a3b under its ``tp_ep`` rules on a forced 4-device CPU
  mesh (2, 2) (one subprocess, ``XLA_FLAGS``), its float32 parameters
  carried across with ``params_from_numpy``: the port's 4-rank step's
  loss within ``LOSS_RTOL`` of the reference's and its updated
  parameters within the reference-step rule of
  ``tests/test_torch_lm_train.py`` (every element within 2 lr, at most
  ``STEP_OUTLIERS`` of them outside ``STEP_TOL``). Both sides' per-device
  FLOPs of that step are printed beside each other, ungated.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ranks import (LOSS_RTOL, LOSS_RTOL_FIRST, MOMENT_RTOL,
                              OFF_SHARE, _leaves, _moments, _update_error)

ROOT = Path(__file__).resolve().parents[1]
B, S, PROMPT, GEN = 4, 16, 8, 4
ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b")
MESHES = ((2, 2), (1, 4))
LOSS_F32_RTOL = 1e-5      # float32: the same arithmetic in another order
GRAD_RTOL = 1e-5          # relative norm per leaf, float32
LOGITS_RTOL = 1e-5        # of the largest logit magnitude, float32
# the reference-step rule of tests/test_torch_lm_train.py (one step)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_OUTLIERS = 5e-3

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import SHAPES, get_reduced
from repro.distributed.sharding import MeshRules, param_shardings
from repro.launch.hlo_analysis import analyze
from repro.launch.strategy import pick_strategy
from repro.models import model as JM
from repro.train.steps import TrainHParams, init_opt_state, make_train_step
out, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = get_reduced("qwen3-moe-30b-a3b")
# jax.make_mesh's explicit axes make the reference's embedding gather
# raise under jax 0.9; a Mesh of the forced host devices does not
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
strat = pick_strategy(cfg, SHAPES["train_4k"])
assert strat.name == "tp_ep", strat.name
rules = MeshRules(mesh, strat.logical_rules)
hp = TrainHParams(loss_chunk=8)
p0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                  JM.init_model(cfg, jax.random.PRNGKey(0)))
tokens = np.random.default_rng(7).integers(
    0, cfg.vocab_size, (B, S)).astype(np.int32)
params = jax.device_put(jax.tree.map(jnp.asarray, p0),
                        param_shardings(p0, rules))
opt = init_opt_state(params, hp)
batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
compiled = jax.jit(make_train_step(cfg, rules, hp)).lower(
    params, opt, batch).compile()
acc = analyze(compiled.as_text())
p1, _, met = compiled(params, opt, batch)
flat = {}


def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(t)


walk(p0, ("p0",))
walk(jax.device_get(p1), ("p1",))
kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
np.savez(out, tokens=tokens, loss=np.float32(met["loss"]),
         flops=np.float64(acc["flops"]),
         coll=np.array([acc["coll"][k]["count"] for k in kinds]), **flat)
"""

WORKER = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshRules, batch_split,
                                              gather_tree, mesh_rules,
                                              tree_map)
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import init_distributed, mesh_over
from repro_torch.launch.serve import _grow_cache
from repro_torch.launch.strategy import pick_strategy
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, batch_shard, greedy,
                                     init_opt_state, make_prefill_step,
                                     make_serve_step, make_train_step,
                                     place_params, ruled_loss_and_grads)

rank, world, store, out, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
B, S, PROMPT, GEN = (int(a) for a in sys.argv[6:10])
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
res = {}


def tp_rules(cfg, mesh):
    strat = pick_strategy(cfg, SHAPES["train_4k"], override_profile="tp_ep")
    return MeshRules(mesh, strat.logical_rules)


def init(cfg, dtype=None):
    p = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return p if dtype is None else tree_map(lambda t: t.to(dtype), p)


for arch in ("qwen2-1.5b", "qwen3-moe-30b-a3b"):
    cfg = get_reduced(arch)
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_over(shape, ("data", "model"))
        rules = tp_rules(cfg, mesh)
        hp = TrainHParams(loss_chunk=8)
        r = res[(arch, shape)] = {}
        # float32: loss, every gradient, the prefill's logits
        p32 = init(cfg, torch.float32)
        batch = synthetic_batch(cfg, B, S, 0)
        loss, _, grads = ruled_loss_and_grads(place_params(p32, rules), cfg,
                                              batch, hp, rules)
        r["loss32"], r["grads32"] = float(loss), gather_tree(grads)
        logits, _ = make_prefill_step(cfg, rules)(
            p32, {"tokens": batch["tokens"]})
        r["logits32"] = logits
        # this rank's blocks of layer 0
        mine, split = batch_shard(batch, rules)
        with mesh_rules(rules), batch_split(split):
            plan = TP.plan_for(cfg)
            held = TP.hold(place_params(p32, rules), cfg)
            lp = TP.use(M._unstack(held["layers"], cfg.n_layers - (
                cfg.moe.n_dense_layers if cfg.moe else 0))[0])
            blocks = {"attn/wq": lp["attn"]["wq"], "attn/wk": lp["attn"]["wk"],
                      "embed": TP.use(held["embed"])}
            if cfg.moe:
                blocks["moe/w_gate"] = lp["moe"]["w_gate"]
        r["plan"] = (plan.attn, plan.kv, plan.vocab,
                     None if plan.tp is None else (plan.tp.size,
                                                   plan.tp.index),
                     None if plan.ep is None else (plan.ep.size,
                                                   plan.ep.index))
        r["blocks"] = blocks
        # bf16: two ruled train steps
        params, opt = init(cfg), None
        opt = init_opt_state(params, hp)
        step = make_train_step(cfg, rules, hp)
        losses = []
        for i in range(2):
            params, opt, met = step(params, opt, synthetic_batch(cfg, B, S, i))
            losses.append(float(met["loss"]))
        r["losses"], r["params"], r["opt"] = (losses, gather_tree(params),
                                              gather_tree(opt))
        # greedy decoding: the factories called the reference's way
        params = init(cfg)
        toks = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                             generator=torch.Generator().manual_seed(5))
        logits, st = make_prefill_step(cfg, rules)(params, {"tokens": toks})
        rows = batch_shard({"tokens": toks}, rules)[0]["tokens"].shape[0]
        st = _grow_cache(cfg, st, rows, PROMPT + GEN, "cpu")
        r["cache"] = tuple(st["main"]["k"].shape)
        nxt, seq = greedy(logits), []
        serve = make_serve_step(cfg, rules)
        for _ in range(GEN):
            nxt, st = serve(params, nxt[:, None], st)
            seq.append(nxt)
        r["tokens"] = torch.stack([greedy(logits)] + seq, 1)

# int8 moments re-homed onto the experts, on (2, 2): two float32 steps
import dataclasses
from repro_torch.train.steps import opt_state_shardings
cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"), n_layers=3,
                          d_model=256)
rules = tp_rules(cfg, mesh_over((2, 2), ("data", "model")))
hp = TrainHParams(loss_chunk=8, quantized_opt_state=True)
params = init(cfg, torch.float32)
opt = init_opt_state(params, hp)
step = make_train_step(cfg, rules, hp)
losses = []
for i in range(2):
    params, opt, met = step(params, opt, synthetic_batch(cfg, B, S, i))
    losses.append(float(met["loss"]))
res["int8"] = {"losses": losses, "params": gather_tree(params),
               "opt": gather_tree(opt), "w_down_moment_spec":
               opt_state_shardings(opt, params, rules).m["layers"]["moe"][
                   "w_down"].spec}

# the reference's tp_ep step on (2, 2): its float32 parameters, one step
cfg = get_reduced("qwen3-moe-30b-a3b")
z = np.load(ref)
tree = {}
for k in z.files:
    if k.startswith("p0/"):
        *path, leaf = k.split("/")[1:]
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
params = M.params_from_numpy(tree, cfg, "cpu")
hp = TrainHParams(loss_chunk=8)
tokens = torch.from_numpy(z["tokens"])
batch = {"tokens": tokens, "labels": tokens}
rules = tp_rules(cfg, mesh_over((2, 2), ("data", "model")))
step = make_train_step(cfg, rules, hp)
p1, _, met = step(params, init_opt_state(params, hp), batch)
_, acc = analyze(step, place_params(params, rules),
                 init_opt_state(params, hp), batch)
res["reference_step"] = {"loss": float(met["loss"]),
                         "params": gather_tree(p1), "flops": acc["flops"],
                         "coll": {k: v["count"] for k, v in
                                  acc["coll"].items()
                                  if isinstance(v, dict)}}
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The reference's step in one subprocess, then the four-rank worker
    once; (the reference's npz, [rank r's results])."""
    d = tmp_path_factory.mktemp("tp")
    ref = d / "reference.npz"
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(ref), str(B),
                          str(S)], env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d / "out"), str(ref), str(B), str(S), str(PROMPT), str(GEN)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return (dict(np.load(ref)),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


def _plain_f32(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, loss_and_grads,
                                         make_prefill_step)
    cfg = get_reduced(arch)
    params = tree_map(lambda t: t.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = synthetic_batch(cfg, B, S, 0)
    loss, _, grads = loss_and_grads(params, cfg, batch,
                                    TrainHParams(loss_chunk=8))
    logits, _ = make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
    return float(loss), grads, logits


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_f32_loss_gradients_and_logits_match_the_plain_step(group, arch,
                                                            shape):
    want_loss, want_grads, want_logits = _plain_f32(arch)
    want = dict(_leaves(want_grads))
    for r in group[1]:
        got = r[(arch, shape)]
        assert abs(got["loss32"] - want_loss) <= LOSS_F32_RTOL * want_loss
        grads = dict(_leaves(got["grads32"]))
        assert grads.keys() == want.keys()
        errs = {k: float((grads[k] - w).norm() / w.norm()) for k, w in
                want.items()}
        for k, err in errs.items():
            assert err <= GRAD_RTOL, (k, err)
        assert {"/embed", "/layers/ln1/scale"} <= errs.keys()
        lerr = float((got["logits32"] - want_logits).abs().max())
        assert lerr <= LOGITS_RTOL * float(want_logits.abs().max()), lerr


def _int8_cfg():
    """Reduced qwen3-moe with 3 layers (which 2 data ranks do not divide)
    and d_model 256 (one int8 block): its ``w_down`` moments re-home the
    ``data`` axis of d_model onto the experts, as deepseek-v3's do."""
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"), n_layers=3,
                               d_model=256)


def _plain_bf16(arch, cfg=None, dtype=None, **kw):
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)
    cfg = cfg or get_reduced(arch)
    hp = TrainHParams(loss_chunk=8, **kw)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if dtype is not None:
        params = tree_map(lambda t: t.to(dtype), params)
    p0 = dict(_leaves(params))
    opt = init_opt_state(params, hp)
    step = make_train_step(cfg, None, hp)
    losses = []
    for i in range(2):
        params, opt, met = step(params, opt, synthetic_batch(cfg, B, S, i))
        losses.append(float(met["loss"]))
    return losses, params, opt, p0


@pytest.mark.parametrize("arch,shape", CASES + [("int8", (2, 2))],
                         ids=IDS + ["int8-moments-on-the-experts"])
def test_bf16_train_steps_within_the_split_tolerances(group, arch, shape):
    """The bf16 runs; and (``int8``) two steps of :func:`_int8_cfg` with
    int8 moments on (2, 2), its stacked int8 leaves updated one layer at
    a time, in float32 (so that bf16 rounding of other gradient sums
    flips no update: both losses within ``LOSS_RTOL_FIRST``), held as
    ``tests/test_torch_ranks.py`` holds its int8 runs (no bound per
    element: a second moment that rounds to 0 on one side only)."""
    quantized = arch == "int8"
    if quantized:
        want_losses, want_params, want_opt, p0 = _plain_bf16(
            None, _int8_cfg(), torch.float32, quantized_opt_state=True)
        got = group[1][0]["int8"]
        assert got["w_down_moment_spec"][1] == ("model", "data")
        for r in group[1][1:]:
            assert r["int8"]["losses"] == got["losses"]
    else:
        want_losses, want_params, want_opt, p0 = _plain_bf16(arch)
        got = group[1][0][(arch, shape)]
        for r in group[1][1:]:
            assert r[(arch, shape)]["losses"] == got["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want_losses)]
    assert rel[0] <= LOSS_RTOL_FIRST and max(rel) <= (
        LOSS_RTOL_FIRST if quantized else LOSS_RTOL), rel
    mg, mw = _moments(got["opt"]), _moments(want_opt)
    assert mg.keys() == mw.keys()
    for k in mw:
        err = float((mg[k] - mw[k]).norm() / mw[k].norm())
        assert err <= MOMENT_RTOL, (k, err)
    n_off = n_all = 0
    for (k, a), (k2, b) in zip(_leaves(got["params"]), _leaves(want_params)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        err, tol = _update_error(a, b, p0[k])
        assert quantized or bool((err <= 2 * 3e-4 * 2 + tol).all()), k
        n_off, n_all = n_off + int((err > tol).sum()), n_all + a.numel()
    assert n_off <= OFF_SHARE * n_all, n_off / n_all


def _plain_tokens(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.train.steps import (greedy, make_prefill_step,
                                         make_serve_step)
    cfg = get_reduced(arch)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                         generator=torch.Generator().manual_seed(5))
    logits, st = make_prefill_step(cfg)(params, {"tokens": toks})
    st = _grow_cache(cfg, st, B, PROMPT + GEN, "cpu")
    nxt = greedy(logits)
    seq = [nxt]
    serve = make_serve_step(cfg)
    for _ in range(GEN):
        nxt, st = serve(params, nxt[:, None], st)
        seq.append(nxt)
    return torch.stack(seq, 1)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_ruled_decoding_gives_the_plain_tokens(group, arch, shape):
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    want = _plain_tokens(arch)
    data, tp = shape
    kv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else cfg.n_kv_heads
    for r in group[1]:
        got = r[(arch, shape)]
        assert torch.equal(got["tokens"], want)
        # [L, this rank's rows, capacity, its K/V heads, Dh]: the rules
        # reached both factories called the reference's way
        assert got["cache"] == (cfg.n_layers, B // data, PROMPT + GEN, kv,
                                cfg.resolved_head_dim)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_rank_holds_its_heads_experts_and_vocabulary(group, arch,
                                                          shape):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    cfg = get_reduced(arch)
    full = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    lay = {k: v[0].float() for k, v in full["layers"]["attn"].items()
           if k in ("wq", "wk")}
    if cfg.moe:
        lay["w_gate"] = full["layers"]["moe"]["w_gate"][0].float()
    data, tp = shape
    dh, rep = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    kv_split = cfg.n_kv_heads % tp == 0
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        m = rank % tp                              # the model coordinate
        assert got["plan"] == (True, kv_split, True, (tp, m),
                               (tp, m) if cfg.moe else None)
        hq = cfg.n_heads // tp
        blocks = got["blocks"]
        assert torch.equal(blocks["attn/wq"],
                           lay["wq"][:, m * hq * dh:(m + 1) * hq * dh])
        hk = cfg.n_kv_heads // tp if kv_split else cfg.n_kv_heads
        k0 = m * hk if kv_split else 0
        assert torch.equal(blocks["attn/wk"],
                           lay["wk"][:, k0 * dh:(k0 + hk) * dh])
        if not kv_split:         # this rank's q heads' K/V group
            assert (m * hq) // rep < cfg.n_kv_heads
        v = cfg.vocab_size // tp
        assert torch.equal(blocks["embed"],
                           full["embed"].float()[m * v:(m + 1) * v])
        if cfg.moe:
            e = cfg.moe.n_experts // tp
            assert torch.equal(blocks["moe/w_gate"],
                               lay["w_gate"][m * e:(m + 1) * e])


def test_the_references_tp_ep_step(group):
    ref, ranks = group
    want_loss = float(ref["loss"])
    for r in ranks:
        got = r["reference_step"]
        assert abs(got["loss"] - want_loss) <= LOSS_F32_RTOL * want_loss
    got = ranks[0]["reference_step"]
    start = {k[3:]: v for k, v in ref.items() if k.startswith("p0/")}
    n_out = n_all = 0
    for k, a in _leaves(got["params"]):
        w, a = ref["p1" + k], a.numpy()
        err = np.abs(a - w)
        assert err.max() <= 2 * 3e-4 * 1.001, k
        n_out += int((err > STEP_TOL["atol"]
                      + STEP_TOL["rtol"] * np.abs(w)).sum())
        n_all += w.size
        assert not np.array_equal(w, start[k[1:]]), k    # every leaf moved
    assert n_out <= STEP_OUTLIERS * n_all, n_out / n_all
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
    print(f"reduced qwen3-moe-30b-a3b tp_ep step on (2, 2), B = {B}, S = "
          f"{S}, per device: the reference's GSPMD program "
          f"{float(ref['flops']):.4e} FLOPs, collectives "
          f"{dict(zip(kinds, ref['coll'].tolist()))}; the port's rank 0 "
          f"{got['flops']:.4e} FLOPs, collectives {got['coll']}")
