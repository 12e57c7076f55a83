"""The ruled steps' compute split (``distributed/tensor_parallel.py``) at
four ranks on the CPU: ONE spawned gloo group of four ``python -c``
workers on a ``FileStore`` runs every check of this module on the meshes
(2, 2) and (1, 4) (data x model) of the same group, and each test reads
its part of the results. The rules are the ``tp_ep`` profile's: the
batch over ``data``, attention, MLA, the MLPs, the vocabulary and the
Mamba-2 and RWKV-6 heads over ``model`` (the tensor axis), the experts
over ``model`` (the expert axis). Reduced qwen2-1.5b (tied head; 4 heads
and 2 K/V heads, so the K/V heads split at tp 2, and at tp 4 each rank
holds both K/V heads' cache on a quarter of its capacity: the
split-capacity decode), reduced qwen3-moe-30b-a3b (8 experts: 4 a rank
at ep 2, 2 at ep 4), reduced deepseek-v3-671b (MLA, 4 heads), reduced
zamba2-7b (8 Mamba-2 heads, and 4 heads in the shared block) and
reduced rwkv6-3b (2 heads: on (2, 2) alone, since 4 ranks do not divide
them; ``ARCH_MESHES``).

* float32 parameters, against the one-process plain step from the same
  seed and batch: the loss within ``LOSS_RTOL``, every gradient leaf
  (the embedding and ``ln1`` included) within a relative norm of
  ``GRAD_RTOL``, and the last-token logits of the ruled prefill within
  ``LOGITS_RTOL`` of their largest magnitude (another summation order:
  the row-parallel products summed over ranks, the experts' partial
  outputs summed over ranks, the log-sum-exp over vocabulary shards, the
  gated norm's squares summed over ranks); each rank's first layer of
  the prefill's decode state (its batch rows, and its K/V heads or
  capacity rows, recurrent heads and conv channels) within
  ``STATE_RTOL`` of the plain state's slice (and one rounding of each
  value in the bf16 caches);
* bf16 parameters (qwen2-1.5b and qwen3-moe-30b-a3b,
  ``BF16_ARCHS``), two ruled train steps against two plain ones, held
  to ``tests/test_torch_ranks.py``'s ``LOSS_RTOL_FIRST``, ``LOSS_RTOL``,
  ``MOMENT_RTOL`` and ``OFF_SHARE``; and two steps with int8 moments of
  a 3-layer, d_model-256 qwen3-moe on (2, 2), whose ``w_down`` moments
  put the experts over ``("model", "data")`` as deepseek-v3's do (the
  ruled step updates such a stack one layer at a time);
* the greedy tokens of a ruled prefill and 4 decode steps (the
  factories called the reference's way, ``make_prefill_step(cfg,
  rules)``, ``make_serve_step(cfg, rules)``, the cache grown by
  ``launch.serve._grow_cache`` under the rules) equal the plain ones,
  and each rank's decode state has its batch rows, its K/V heads or
  capacity rows (C / tp), its recurrent heads and conv channels;
* reduced qwen2-1.5b with 6 q heads on (1, 4): the q heads do not
  split, the cache does on its capacity, so every rank scores all q
  heads against its ceil(C / 4) rows (a 7-token prompt: neither
  capacity divides 4); its greedy tokens equal the plain ones;
* each rank's local blocks: its q heads, K/V heads, MLA heads, Mamba-2
  and RWKV-6 heads, experts and vocabulary rows, each the right slice of
  the global leaf, and the leaves it uses whole;
* the reference's jitted ``make_train_step(cfg, rules, hp)`` of reduced
  qwen3-moe-30b-a3b under its ``tp_ep`` rules on a forced 4-device CPU
  mesh (2, 2) (one subprocess, ``XLA_FLAGS``), its float32 parameters
  carried across with ``params_from_numpy``: the port's 4-rank step's
  loss within ``LOSS_RTOL`` of the reference's and its updated
  parameters within the reference-step rule of
  ``tests/test_torch_lm_train.py`` (every element within 2 lr, at most
  ``STEP_OUTLIERS`` of them outside ``STEP_TOL``). Both sides' per-device
  FLOPs of that step are printed beside each other, ungated;
* in the same subprocess, the reference's jitted serve step (state
  donated) of reduced qwen2-1.5b on the forced (1, 4) mesh, its decode
  state placed by ``launch/specs.py``'s ``_state_sharding`` (the
  capacity split over ``model``: 2 K/V heads do not divide 4), from its
  float32 parameters: its greedy tokens equal the port's four-rank
  ruled decode of the same parameters on (1, 4).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_ranks import (LOSS_RTOL, LOSS_RTOL_FIRST, MOMENT_RTOL,
                              OFF_SHARE, _leaves, _moments, _update_error)

ROOT = Path(__file__).resolve().parents[1]
B, S, PROMPT, GEN = 4, 16, 8, 4
UNEVEN_PROMPT = 7         # the 6-q-head case: 7 and 7 + GEN rows on 4 ranks
ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b", "deepseek-v3-671b", "zamba2-7b",
         "rwkv6-3b")
MESHES = ((2, 2), (1, 4))
# rwkv6-3b's 2 heads split over 2 ranks, not 4
ARCH_MESHES = {a: MESHES[:1] if a == "rwkv6-3b" else MESHES for a in ARCHS}
# the bf16 two-step runs: the archs the update rules were drawn for (the
# plain rwkv6-3b step alone moves its moments past MOMENT_RTOL when its
# batch is cut in two microbatches)
BF16_ARCHS = ARCHS[:2]
LOSS_F32_RTOL = 1e-5      # float32: the same arithmetic in another order
GRAD_RTOL = 1e-5          # relative norm per leaf, float32
LOGITS_RTOL = 1e-5        # of the largest logit magnitude, float32
STATE_RTOL = 1e-5         # of the largest state magnitude, float32 (the
                          # bf16 caches: one rounding of each value more)
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

# the jitted serve step on (1, 4): the decode state capacity-split
from repro.launch.serve import _grow_cache
from repro.launch.specs import _state_sharding
from repro.train.steps import make_prefill_step, make_serve_step
PROMPT, GEN = int(sys.argv[4]), int(sys.argv[5])
cfg = get_reduced("qwen2-1.5b")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
rules = MeshRules(mesh, pick_strategy(cfg, SHAPES["decode_32k"])
                  .logical_rules)
q0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                  JM.init_model(cfg, jax.random.PRNGKey(1)))
prompt = np.random.default_rng(9).integers(
    0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
params = jax.device_put(jax.tree.map(jnp.asarray, q0),
                        param_shardings(q0, rules))
logits, st = jax.jit(make_prefill_step(cfg, rules))(
    params, {"tokens": jnp.asarray(prompt)})
st = _grow_cache(cfg, st, B, PROMPT + GEN)
placed = jax.tree.map(lambda l: _state_sharding(l, rules, B), st)
assert placed["main"]["k"].spec[2] == "model", placed["main"]["k"].spec
st = jax.device_put(st, placed)
serve = jax.jit(make_serve_step(cfg, rules), donate_argnums=(2,))
nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
seq = [nxt]
for _ in range(GEN):
    nxt, st = serve(params, nxt[:, None], st)
    seq.append(nxt)
walk(q0, ("q0",))
kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
np.savez(out, tokens=tokens, loss=np.float32(met["loss"]),
         flops=np.float64(acc["flops"]),
         coll=np.array([acc["coll"][k]["count"] for k in kinds]),
         dec_prompt=prompt, dec_tokens=np.stack(
             [np.asarray(t) for t in seq], 1),
         dec_k_spec=np.array([str(a) for a in placed["main"]["k"].spec]),
         **flat)
"""

WORKER = r"""
import dataclasses
import json
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshRules, batch_split,
                                              flat_tree, gather_tree,
                                              mesh_rules, tree_map)
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
B, S, PROMPT, GEN, UNEVEN_PROMPT = (int(a) for a in sys.argv[6:11])
ARCH_MESHES = {a: [tuple(m) for m in ms]
               for a, ms in json.loads(sys.argv[11]).items()}
BF16_ARCHS = json.loads(sys.argv[12])
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
res = {}


def tp_rules(cfg, mesh):
    strat = pick_strategy(cfg, SHAPES["train_4k"], override_profile="tp_ep")
    return MeshRules(mesh, strat.logical_rules)


def init(cfg, dtype=None):
    p = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return p if dtype is None else tree_map(lambda t: t.to(dtype), p)


def first_layer(cfg, held):
    # layer 0 of the main stack (and zamba2's shared block), gathered as
    # the layer uses it: this rank's blocks
    if cfg.family == "hybrid":
        return {"mamba": TP.use(M._unstack(held["mamba"], cfg.n_layers)[0]),
                "shared": TP.use(held["shared_attn_block"])}
    n = cfg.n_layers - (cfg.moe.n_dense_layers if cfg.moe else 0)
    return {"layers": TP.use(M._unstack(held["layers"], n)[0])}


def layer0_state(st):
    # the first layer's leaves of a decode state (the stacked dim 0)
    return {"/".join(map(str, k)): v[0].clone()
            for k, v in flat_tree(st).items() if k[-1] != "len"}


def decode(cfg, params, toks, rules):
    logits, st = make_prefill_step(cfg, rules)(params, {"tokens": toks})
    rows = batch_shard({"tokens": toks}, rules)[0]["tokens"].shape[0]
    st = _grow_cache(cfg, st, rows, toks.shape[1] + GEN, "cpu", rules)
    shapes = {"/".join(map(str, k)): tuple(v.shape)
              for k, v in flat_tree(st).items() if k[-1] != "len"}
    nxt, seq = greedy(logits), []
    serve = make_serve_step(cfg, rules)
    for _ in range(GEN):
        nxt, st = serve(params, nxt[:, None], st)
        seq.append(nxt)
    return torch.stack([greedy(logits)] + seq, 1), shapes


for arch, shapes in ARCH_MESHES.items():
    cfg = get_reduced(arch)
    for shape in shapes:
        mesh = mesh_over(shape, ("data", "model"))
        rules = tp_rules(cfg, mesh)
        hp = TrainHParams(loss_chunk=8)
        r = res[(arch, shape)] = {}
        # float32: loss, every gradient, the prefill's logits and state
        p32 = init(cfg, torch.float32)
        batch = synthetic_batch(cfg, B, S, 0)
        loss, _, grads = ruled_loss_and_grads(place_params(p32, rules), cfg,
                                              batch, hp, rules)
        r["loss32"], r["grads32"] = float(loss), gather_tree(grads)
        logits, st = make_prefill_step(cfg, rules)(
            p32, {"tokens": batch["tokens"]})
        r["logits32"], r["state32"] = logits, layer0_state(st)
        # this rank's blocks of layer 0
        mine, split = batch_shard(batch, rules)
        with mesh_rules(rules), batch_split(split):
            plan = TP.plan_for(cfg)
            held = TP.hold(place_params(p32, rules), cfg)
            blocks = {"/".join((part, *k)): v for part, lp in
                      first_layer(cfg, held).items()
                      for k, v in flat_tree(lp).items()}
            blocks["embed"] = TP.use(held["embed"])
        r["plan"] = (plan.attn, plan.kv, plan.vocab,
                     None if plan.tp is None else (plan.tp.size,
                                                   plan.tp.index),
                     None if plan.ep is None else (plan.ep.size,
                                                   plan.ep.index),
                     plan.heads, plan.cap)
        r["blocks"] = blocks
        # bf16: two ruled train steps
        if arch in BF16_ARCHS:
            params = init(cfg)
            opt = init_opt_state(params, hp)
            step = make_train_step(cfg, rules, hp)
            losses = []
            for i in range(2):
                params, opt, met = step(params, opt,
                                        synthetic_batch(cfg, B, S, i))
                losses.append(float(met["loss"]))
            r["losses"], r["params"], r["opt"] = (
                losses, gather_tree(params), gather_tree(opt))
        # greedy decoding: the factories called the reference's way
        params = init(cfg)
        toks = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                             generator=torch.Generator().manual_seed(5))
        r["tokens"], r["state"] = decode(cfg, params, toks, rules)

# q heads whole on every rank, the capacity split: 6 q heads (and 2 K/V
# heads) do not divide 4 ranks, so each rank scores all of them against
# its quarter of the cache and nothing is gathered; a prompt of
# UNEVEN_PROMPT tokens, so neither the prefill's capacity nor the grown
# one divides 4 (each rank's rows rounded up, the last zero-padded)
cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_heads=6, head_dim=16)
rules = tp_rules(cfg, mesh_over((1, 4), ("data", "model")))
with mesh_rules(rules), batch_split(None):
    plan = TP.plan_for(cfg)
toks = torch.randint(0, cfg.vocab_size, (B, UNEVEN_PROMPT),
                     generator=torch.Generator().manual_seed(5))
res["whole_q_heads"] = ((plan.attn, plan.kv, plan.cap),
                        *decode(cfg, init(cfg), toks, rules))

# the reference's jitted serve step's parameters, decoded on (1, 4)
z = np.load(ref)


def tree_of(prefix):
    tree = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            *path, leaf = k.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


cfg = get_reduced("qwen2-1.5b")
rules = MeshRules(mesh_over((1, 4), ("data", "model")),
                  pick_strategy(cfg, SHAPES["decode_32k"]).logical_rules)
res["reference_decode"] = decode(
    cfg, M.params_from_numpy(tree_of("q0"), cfg, "cpu"),
    torch.from_numpy(z["dec_prompt"]), rules)

# int8 moments re-homed onto the experts, on (2, 2): two float32 steps
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
params = M.params_from_numpy(tree_of("p0"), cfg, "cpu")
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
                          str(S), str(PROMPT), str(GEN)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d / "out"), str(ref), str(B), str(S), str(PROMPT), str(GEN),
         str(UNEVEN_PROMPT), json.dumps(ARCH_MESHES),
         json.dumps(BF16_ARCHS)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return (dict(np.load(ref)),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


@functools.lru_cache(maxsize=None)
def _plain_f32(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import flat_tree, tree_map
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
    logits, st = make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
    state = {"/".join(map(str, k)): v[0] for k, v in flat_tree(st).items()
             if k[-1] != "len"}
    return float(loss), grads, logits, state


# per decode-state leaf: its batch dim, counted from the end
_BATCH_FROM_END = {"k": 4, "v": 4, "latent": 3, "krope": 3, "ssm": 4,
                   "conv": 3, "wkv": 4, "tm_x": 2, "cm_x": 2}


def _plan(cfg, tp: int, m: int) -> tuple:
    """The recorded ``Plan`` fields each rank must have, from the
    config: (attn, kv, vocab, (tp, index), ep, heads, cap); ``heads``:
    MLA's, Mamba-2's or RWKV-6's heads divide ``tp``."""
    attn = not cfg.mla and cfg.n_heads % tp == 0
    kv = attn and cfg.n_kv_heads % tp == 0
    heads = (cfg.n_heads if cfg.mla else
             (cfg.ssm.expand * cfg.d_model if cfg.family == "hybrid"
              else cfg.d_model) // cfg.ssm.head_dim if cfg.ssm else 0)
    return (attn, kv, cfg.vocab_size % tp == 0, (tp, m),
            (tp, m) if cfg.moe else None, heads > 0 and heads % tp == 0,
            cfg.family != "ssm" and not kv)


def _state_slice(cfg, key: str, t: torch.Tensor, plan: tuple, rank: int,
                 shape: tuple) -> torch.Tensor:
    """Rank ``rank``'s part of a whole decode-state leaf ``t`` (layer 0,
    or a stack) on mesh ``shape``: its batch rows, and its K/V heads or
    capacity rows (of MLA's latent cache too), recurrent heads or conv
    channels."""
    data, tp = shape
    d, m = rank // tp, rank % tp
    _, kv, _, _, _, heads, cap = plan
    name = key.split("/")[-1] if not key.split("/")[-1].isdigit() \
        else key.split("/")[-2]
    bdim = t.ndim - _BATCH_FROM_END[name]
    rows = t.shape[bdim] // data
    t = t.narrow(bdim, d * rows, rows)
    if name in ("k", "v") and kv:
        n = t.shape[-2] // tp
        return t.narrow(t.ndim - 2, m * n, n)
    if name in ("k", "v", "latent", "krope") and cap:
        dim = t.ndim - (3 if name in ("k", "v") else 2)
        c = -(-t.shape[dim] // tp)
        t = F.pad(t, (0, 0) * (t.ndim - dim - 1) + (0, c * tp - t.shape[dim]))
        return t.narrow(dim, m * c, c)
    if name in ("ssm", "wkv") and heads:
        n = t.shape[-3] // tp
        return t.narrow(t.ndim - 3, m * n, n)
    if name == "conv" and heads:
        n_state = cfg.ssm.d_state
        di = (t.shape[-1] - 2 * n_state) // tp
        return torch.cat([t[..., m * di:(m + 1) * di],
                          t[..., t.shape[-1] - 2 * n_state:]], -1)
    return t


CASES = [(a, m) for a in ARCHS for m in ARCH_MESHES[a]]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_f32_loss_gradients_and_logits_match_the_plain_step(group, arch,
                                                            shape):
    """And each rank's first layer of the prefill's decode state within
    ``STATE_RTOL`` of its part of the plain one."""
    want_loss, want_grads, want_logits, want_state = _plain_f32(arch)
    want = dict(_leaves(want_grads))
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        assert abs(got["loss32"] - want_loss) <= LOSS_F32_RTOL * want_loss
        grads = dict(_leaves(got["grads32"]))
        assert grads.keys() == want.keys()
        errs = {k: float((grads[k] - w).norm() / w.norm()) for k, w in
                want.items()}
        for k, err in errs.items():
            assert err <= GRAD_RTOL, (k, err)
        first_norm = ("/mamba/ln/scale" if cfg.family == "hybrid"
                      else "/layers/ln1/scale")
        assert {"/embed", first_norm} <= errs.keys()
        lerr = float((got["logits32"] - want_logits).abs().max())
        assert lerr <= LOGITS_RTOL * float(want_logits.abs().max()), lerr
        assert got["state32"].keys() == want_state.keys()
        for k, w in want_state.items():
            part = _state_slice(cfg, k, w, got["plan"], rank, shape)
            g = got["state32"][k]
            assert g.shape == part.shape, (k, g.shape, part.shape)
            # the caches are bf16: one rounding of each value besides
            tol = (STATE_RTOL * float(w.float().abs().max())
                   + torch.finfo(w.dtype).eps * part.float().abs())
            err = (g.float() - part.float()).abs()
            assert bool((err <= tol).all()), (k, float(err.max()))


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


BF16_CASES = [(a, m) for a, m in CASES if a in BF16_ARCHS]


@pytest.mark.parametrize("arch,shape", BF16_CASES + [("int8", (2, 2))],
                         ids=[f"{a}-{m}" for a, m in BF16_CASES]
                         + ["int8-moments-on-the-experts"])
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


def _plain_tokens(arch, cfg=None, prompt=PROMPT):
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import flat_tree
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.train.steps import (greedy, make_prefill_step,
                                         make_serve_step)
    cfg = cfg or get_reduced(arch)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, prompt),
                         generator=torch.Generator().manual_seed(5))
    logits, st = make_prefill_step(cfg)(params, {"tokens": toks})
    st = _grow_cache(cfg, st, B, prompt + GEN, "cpu")
    shapes = {"/".join(map(str, k)): tuple(v.shape)
              for k, v in flat_tree(st).items() if k[-1] != "len"}
    nxt = greedy(logits)
    seq = [nxt]
    serve = make_serve_step(cfg)
    for _ in range(GEN):
        nxt, st = serve(params, nxt[:, None], st)
        seq.append(nxt)
    return torch.stack(seq, 1), shapes


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_ruled_decoding_gives_the_plain_tokens(group, arch, shape):
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    want, want_shapes = _plain_tokens(arch)
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        assert torch.equal(got["tokens"], want)
        # each leaf: this rank's rows, K/V heads or capacity rows (C /
        # tp where the K/V heads do not divide), recurrent heads and conv
        # channels; the rules reached both factories called the
        # reference's way, and the cache grown under them
        assert got["state"].keys() == want_shapes.keys()
        for k, sh in want_shapes.items():
            part = _state_slice(cfg, k, torch.empty(sh, device="meta"),
                                got["plan"], rank, shape)
            assert got["state"][k] == tuple(part.shape), k
    if arch == "qwen2-1.5b" and shape == (1, 4):      # the capacity split
        assert got["state"]["main/k"] == (cfg.n_layers, B, (PROMPT + GEN)
                                          // 4, cfg.n_kv_heads,
                                          cfg.resolved_head_dim)


def _cols(w, i, n):
    """Block i of n of ``w``'s last dim."""
    k = w.shape[-1] // n
    return w[..., i * k:(i + 1) * k]


def _rows(w, i, n):
    """Block i of n of ``w``'s first dim."""
    k = w.shape[0] // n
    return w[i * k:(i + 1) * k]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_rank_holds_its_heads_experts_and_vocabulary(group, arch,
                                                          shape):
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import flat_tree
    from repro_torch.models import model as M
    cfg = get_reduced(arch)
    full = {"/".join(k): v.float() for k, v in flat_tree(M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu")).items()}
    data, tp = shape
    dh, rep = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    kv_split = cfg.n_kv_heads % tp == 0
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        m = rank % tp                              # the model coordinate
        assert got["plan"] == _plan(cfg, tp, m)
        blocks = got["blocks"]
        want = {"embed": _rows(full["embed"], m, tp)}
        if cfg.family in ("dense", "moe") and not cfg.mla:
            hq = cfg.n_heads // tp
            want["layers/attn/wq"] = full["layers/attn/wq"][0][
                :, m * hq * dh:(m + 1) * hq * dh]
            hk = cfg.n_kv_heads // tp if kv_split else cfg.n_kv_heads
            k0 = m * hk if kv_split else 0
            want["layers/attn/wk"] = full["layers/attn/wk"][0][
                :, k0 * dh:(k0 + hk) * dh]
            if not kv_split:         # this rank's q heads' K/V group
                assert (m * hq) // rep < cfg.n_kv_heads
        if cfg.moe:
            want["layers/moe/w_gate"] = _rows(
                full["layers/moe/w_gate"][0], m, tp)
        if cfg.mla:                  # whole heads; the latents whole
            for k in ("wq_b", "wkv_b"):
                want[f"layers/attn/{k}"] = _cols(
                    full[f"layers/attn/{k}"][0], m, tp)
            for k in ("wq_a", "wkv_a"):
                want[f"layers/attn/{k}"] = full[f"layers/attn/{k}"][0]
            want["layers/attn/wo"] = _rows(full["layers/attn/wo"][0], m, tp)
        if cfg.family == "hybrid":   # whole heads; in_proj / conv whole
            for k in ("a_log", "dt_bias", "d_skip"):
                want[f"mamba/{k}"] = _cols(full[f"mamba/{k}"][0], m, tp)
            want["mamba/out_proj"] = _rows(full["mamba/out_proj"][0], m, tp)
            for k in ("in_proj", "conv_w", "norm/scale"):
                want[f"mamba/{k}"] = full[f"mamba/{k}"][0]
            for k in ("wq", "wk", "wv"):
                want[f"shared/shared_attn/{k}"] = _cols(
                    full[f"shared_attn_block/shared_attn/{k}"], m, tp)
            want["shared/shared_mlp/w_down"] = _rows(
                full["shared_attn_block/shared_mlp/w_down"], m, tp)
        if cfg.family == "ssm":      # whole heads; the decay LoRA whole
            for k in ("wr", "wk", "wv", "wg"):
                want[f"layers/time_mix/{k}"] = _cols(
                    full[f"layers/time_mix/{k}"][0], m, tp)
            want["layers/time_mix/u"] = _rows(full["layers/time_mix/u"][0],
                                              m, tp)
            want["layers/time_mix/wo"] = _rows(full["layers/time_mix/wo"][0],
                                               m, tp)
            want["layers/channel_mix/wk"] = _cols(
                full["layers/channel_mix/wk"][0], m, tp)
            want["layers/channel_mix/wv"] = _rows(
                full["layers/channel_mix/wv"][0], m, tp)
            for k in ("time_mix/w2", "time_mix/w0", "channel_mix/wr"):
                want[f"layers/{k}"] = full[f"layers/{k}"][0]
        for k, w in want.items():
            assert torch.equal(blocks[k].float(), w), k


def test_capacity_split_decode_with_whole_q_heads(group):
    """Reduced qwen2-1.5b with 6 q heads (2 K/V heads) on (1, 4): the q
    heads do not split 4 ways, so attention runs whole on every rank
    (``Plan.attn`` false) while the cache is split on its capacity; every
    rank scores all 6 heads against its C / 4 rows and the partial
    softmaxes merge. The prompt's UNEVEN_PROMPT rows and the grown
    capacity do not divide 4: each rank holds ceil(C / 4) rows, the last
    zero-padded. The greedy tokens equal the plain decode's."""
    import dataclasses
    from repro_torch.configs import get_reduced
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_heads=6,
                              head_dim=16)
    want, want_shapes = _plain_tokens(None, cfg, UNEVEN_PROMPT)
    rows = -(-(UNEVEN_PROMPT + GEN) // 4)
    for r in group[1]:
        plan, tokens, shapes = r["whole_q_heads"]
        assert plan == (False, False, True)
        assert torch.equal(tokens, want)
        assert shapes.keys() == want_shapes.keys()
        for k in ("main/k", "main/v"):
            assert shapes[k] == (cfg.n_layers, B, rows, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)


def test_the_references_capacity_split_serve_step(group):
    """The reference's jitted serve step on (1, 4), its state placed by
    ``_state_sharding`` (the capacity over ``model``), against the
    port's four-rank ruled decode of the same float32 parameters: the
    same greedy tokens, and each rank's cache a quarter of the
    capacity."""
    from repro_torch.configs import get_reduced
    ref, ranks = group
    cfg = get_reduced("qwen2-1.5b")
    assert list(ref["dec_k_spec"]) == ["None", "data", "model", "None",
                                       "None"]
    want = torch.from_numpy(ref["dec_tokens"])
    for r in ranks:
        tokens, shapes = r["reference_decode"]
        assert torch.equal(tokens, want.to(tokens.dtype))
        assert shapes["main/k"] == (cfg.n_layers, B, (PROMPT + GEN) // 4,
                                    cfg.n_kv_heads, cfg.resolved_head_dim)


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
