"""``tp_ep_full``'s expert parallelism (``models/moe.py``,
``distributed/tensor_parallel.py``) at four ranks on the CPU: each rank
owns whole experts and the tokens move to them by all-to-all over
``data``. ONE spawned gloo group of four ``python -c`` workers on a
``FileStore`` runs every check of this module on the meshes (2, 2) and
(4, 1) (data x model) of the same group, while one subprocess runs the
reference's jitted ``tp_ep_full`` train step on a forced 4-device (2, 2)
CPU mesh; each test reads its part of the results.

Reduced deepseek-v3-671b (MLA, one shared expert) and reduced
qwen3-moe-30b-a3b, 8 experts each: 2 a rank on either mesh, the expert
stacks held as DTensor places ``("model", "data")``'s shards (rank (d,
m) holds block d * n_model + m). Float32 parameters, against the
one-process plain step from the same seed and batch:

* form (a), each routing group within one data shard (B = 16, S = 512:
  one group of 2048 tokens a rank on (4, 1), two on (2, 2)): the loss
  within ``LOSS_F32_RTOL``, every gradient leaf within ``GRAD_RTOL``,
  the prefill's last-token logits within ``LOGITS_RTOL`` of their
  largest magnitude; the counted all-to-all bytes equal 6 exchanges (the
  forward's two, the remat'd recompute's two, the backward's two) of
  every MoE layer's [n_data, E_loc, G C, D] buffer, and the counted
  all-gather bytes are below the ``tp_ep`` step's on the same mesh by
  the expert stacks that step gathers (two passes of [E / n_model, D,
  F] per stack and MoE layer);
* form (b), a group spanning the data shards (B = 4, S = 16): the loss
  and every gradient the same way; the greedy tokens of a ruled prefill
  and 4 decode steps (the serve step's groups span the shards) equal the
  plain ones;
* each rank's expert blocks of layer 0 (not gathered), and its plan:
  ``Plan.ep`` over ``model`` where it has more than one rank,
  ``Plan.a2a`` over ``data``;
* the backward run on a thread of its own, with no active batch split
  (a card's autograd device thread): the remat'd MoE layers recompute
  under the forward's split, the gradients bit for bit;
* int8 moments (deepseek-v3's Adam) on (2, 2): two steps of a 3-layer,
  d_model-256 qwen3-moe held as ``tests/test_torch_tensor_parallel.py``
  holds its int8 runs, the ``w_down`` moments split as the experts are,
  and Adam on each expert stack runs no collective;
* a one-rank ``data`` axis, (1, 4), gives the ``tp_ep`` step bit for bit
  (the loss and every gradient), with no exchange group;
* the fault: 6 experts, which ``model`` (2) divides and ``model`` x
  ``data`` (4) does not, are replicated by ``param_pspec``; ``hold``
  succeeds, ``Plan.ep`` and ``Plan.a2a`` are None, and the four-rank
  loss and gradients match the plain step;
* the reference's jitted ``make_train_step`` of reduced
  qwen3-moe-30b-a3b under its own ``tp_ep_full`` rules on (2, 2) (B =
  16, S = 512), its float32 parameters carried across with
  ``params_from_numpy``: the port's four-rank step's loss within
  ``LOSS_F32_RTOL`` of the reference's and its updated parameters by
  the rule of ``tests/test_torch_tensor_parallel.py``'s
  ``test_the_references_tp_ep_step``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ranks import _leaves
from test_torch_tensor_parallel import (GRAD_RTOL, LOGITS_RTOL,
                                        LOSS_F32_RTOL, STEP_OUTLIERS,
                                        STEP_TOL)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-v3-671b", "qwen3-moe-30b-a3b")
MESHES = ((2, 2), (4, 1))
WIDE = (16, 512)          # form (a): B, S
NARROW = (4, 16)          # form (b)
PROMPT, GEN = 8, 4
FAULT_EXPERTS = 6         # divides model (2), not model x data (4)
THREADS = "2"             # each worker's and the reference's CPU threads

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import SHAPES, get_reduced
from repro.distributed.sharding import MeshRules, param_shardings
from repro.launch.strategy import pick_strategy
from repro.models import model as JM
from repro.train.steps import TrainHParams, init_opt_state, make_train_step
out, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = get_reduced("qwen3-moe-30b-a3b")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
strat = pick_strategy(cfg, SHAPES["train_4k"], override_profile="tp_ep_full")
assert strat.logical_rules["expert"] == ("model", "data"), strat
rules = MeshRules(mesh, strat.logical_rules)
hp = TrainHParams(loss_chunk=512)
p0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                  JM.init_model(cfg, jax.random.PRNGKey(0)))
tokens = np.random.default_rng(7).integers(
    0, cfg.vocab_size, (B, S)).astype(np.int32)
shardings = param_shardings(p0, rules)
assert shardings["layers"]["moe"]["w_gate"].spec[1] == ("model", "data")
params = jax.device_put(jax.tree.map(jnp.asarray, p0), shardings)
batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
p1, _, met = jax.jit(make_train_step(cfg, rules, hp))(
    params, init_opt_state(params, hp), batch)
flat = {}


def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(t)


walk(p0, ("p0",))
walk(jax.device_get(p1), ("p1",))
np.savez(out + ".tmp.npz", tokens=tokens, loss=np.float32(met["loss"]),
         **flat)
os.replace(out + ".tmp.npz", out)
"""

WORKER = r"""
import dataclasses
import json
import os
import sys
import threading
import time
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
cfg_args = json.loads(sys.argv[6])
ARCHS, MESHES = cfg_args["archs"], [tuple(m) for m in cfg_args["meshes"]]
WIDE, NARROW = cfg_args["wide"], cfg_args["narrow"]
PROMPT, GEN, FAULT_EXPERTS = (cfg_args["prompt"], cfg_args["gen"],
                              cfg_args["fault_experts"])
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
hp = TrainHParams(loss_chunk=512)
res = {}


def rules_of(cfg, shape, profile="tp_ep_full"):
    strat = pick_strategy(cfg, SHAPES["train_4k"], override_profile=profile)
    return MeshRules(mesh_over(shape, ("data", "model")), strat.logical_rules)


def init(cfg, dtype=None):
    p = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return p if dtype is None else tree_map(lambda t: t.to(dtype), p)


def counted(cfg, rules, params, batch):
    (loss, _, grads), acc = analyze(
        lambda: ruled_loss_and_grads(params, cfg, batch, hp, rules))
    coll = {k: v["bytes"] for k, v in acc["coll"].items()
            if isinstance(v, dict)}
    return float(loss), gather_tree(grads), coll


def plan_of(cfg, rules, batch):
    split = batch_shard(batch, rules)[1]
    with mesh_rules(rules), batch_split(split):
        plan = TP.plan_for(cfg)
        held = TP.hold(place_params(init(cfg, torch.float32), rules), cfg)
        n = cfg.n_layers - cfg.moe.n_dense_layers
        layer = TP.use(M._unstack(held["layers"], n)[0])
    return ({g: None if getattr(plan, g) is None else
             (getattr(plan, g).dim, getattr(plan, g).size,
              getattr(plan, g).index) for g in ("ep", "a2a")},
            layer["moe"]["w_gate"].clone())


def decode(cfg, params, toks, rules):
    logits, st = make_prefill_step(cfg, rules)(params, {"tokens": toks})
    rows = batch_shard({"tokens": toks}, rules)[0]["tokens"].shape[0]
    st = _grow_cache(cfg, st, rows, toks.shape[1] + GEN, "cpu", rules)
    nxt, seq = greedy(logits), []
    serve = make_serve_step(cfg, rules)
    for _ in range(GEN):
        nxt, st = serve(params, nxt[:, None], st)
        seq.append(nxt)
    return torch.stack([greedy(logits)] + seq, 1)


for arch in ARCHS:
    cfg = get_reduced(arch)
    p32 = init(cfg, torch.float32)
    for shape in MESHES:
        rules = rules_of(cfg, shape)
        r = res[(arch, shape)] = {}
        wide = synthetic_batch(cfg, *WIDE, 0)
        r["plan"], r["w_gate"] = plan_of(cfg, rules, wide)
        placed = place_params(p32, rules)
        r["wide"] = counted(cfg, rules, placed, wide)
        r["wide_tp_ep_coll"] = counted(cfg, rules_of(cfg, shape, "tp_ep"),
                                       place_params(p32, rules_of(
                                           cfg, shape, "tp_ep")), wide)[2]
        r["logits"] = make_prefill_step(cfg, rules)(
            p32, {"tokens": wide["tokens"]})[0]
        r["narrow"] = counted(cfg, rules, placed,
                              synthetic_batch(cfg, *NARROW, 0))
        toks = torch.randint(0, cfg.vocab_size, (NARROW[0], PROMPT),
                             generator=torch.Generator().manual_seed(5))
        r["tokens"] = decode(cfg, init(cfg), toks, rules)

# the remat'd recompute on another thread (a card's backward runs on
# autograd's device thread, which sees no active batch split): form (b)
def local_grads(cfg, rules, params, batch, thread):
    from repro_torch.train.steps import _with_local
    mine, split = batch_shard(batch, rules)
    leaves = tree_map(lambda t: _with_local(t, TP.local_block(t).detach())
                      .requires_grad_(), params)
    flat = []
    tree_map(flat.append, leaves)
    with mesh_rules(rules), batch_split(split):
        loss, _ = M.loss_fn(leaves, cfg, mine, remat=True, loss_chunk=512)

    def backward():
        got.extend(torch.autograd.grad(loss, flat, allow_unused=True,
                                       materialize_grads=True))
    got = []
    if thread:
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    else:
        with mesh_rules(rules), batch_split(split):
            backward()
    return [TP.local_block(g) for g in got]


cfg = get_reduced("qwen3-moe-30b-a3b")
rules = rules_of(cfg, (2, 2))
placed = place_params(init(cfg, torch.float32), rules)
narrow = synthetic_batch(cfg, *NARROW, 0)
res["threaded"] = [local_grads(cfg, rules, placed, narrow, t)
                   for t in (False, True)]

# int8 moments (deepseek-v3's Adam) on (2, 2): two steps of a 3-layer,
# d_model-256 qwen3-moe (one int8 block); then Adam on each expert stack
# alone (its own values as the gradient), counted
from repro_torch.optimizer.adam import bias_corrections
from repro_torch.train.steps import (_adam_cfg, opt_state_shardings,
                                     ruled_adam_leaf)
cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"), n_layers=3,
                          d_model=256)
rules = rules_of(cfg, (2, 2))
hp8 = TrainHParams(loss_chunk=8, quantized_opt_state=True)
params = init(cfg, torch.float32)
opt = init_opt_state(params, hp8)
step = make_train_step(cfg, rules, hp8)
losses = []
for i in range(2):
    params, opt, met = step(params, opt,
                            synthetic_batch(cfg, NARROW[0], NARROW[1], i))
    losses.append(float(met["loss"]))
adam, opt_cfg = {}, _adam_cfg(hp8)
for name in ("w_gate", "w_up", "w_down"):
    p = params["layers"]["moe"][name]
    m, v, ms, vs = (t["layers"]["moe"][name] for t in opt[1:])
    new, acc = analyze(ruled_adam_leaf, p, p, m, v, ms, vs,
                       *bias_corrections(opt.step, opt_cfg), opt_cfg)
    adam[name] = ({k: c["bytes"] for k, c in acc["coll"].items()
                   if isinstance(c, dict)},
                  [(type(x).__name__, getattr(x, "dim", None))
                   for x in new[0].placements], ms.numel() > 0)
res["int8"] = {"losses": losses, "params": gather_tree(params),
               "opt": gather_tree(opt),
               "spec": opt_state_shardings(opt, params, rules).m["layers"][
                   "moe"]["w_down"].spec, "adam": adam}

# a one-rank data axis: tp_ep_full is the tp_ep step
cfg = get_reduced("qwen3-moe-30b-a3b")
p32 = init(cfg, torch.float32)
narrow = synthetic_batch(cfg, *NARROW, 0)
one = {}
for profile in ("tp_ep_full", "tp_ep"):
    rules = rules_of(cfg, (1, 4), profile)
    one[profile] = (plan_of(cfg, rules, narrow)[0],
                    counted(cfg, rules, place_params(p32, rules), narrow))
res["one_data_rank"] = one

# the fault: experts that model x data does not divide stay replicated
cfg = get_reduced("qwen3-moe-30b-a3b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, n_experts=FAULT_EXPERTS))
rules = rules_of(cfg, (2, 2))
wide = synthetic_batch(cfg, *WIDE, 0)
placed = place_params(init(cfg, torch.float32), rules)
res["fault"] = {"plan": plan_of(cfg, rules, wide)[0],
                "placements": [type(p).__name__ for p in
                               placed["layers"]["moe"]["w_gate"].placements],
                "wide": counted(cfg, rules, placed, wide)}

# the reference's tp_ep_full step on (2, 2): its float32 parameters
while not os.path.exists(ref):
    time.sleep(0.2)
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


cfg = get_reduced("qwen3-moe-30b-a3b")
params = M.params_from_numpy(tree_of("p0"), cfg, "cpu")
tokens = torch.from_numpy(z["tokens"])
step = make_train_step(cfg, rules_of(cfg, (2, 2)), hp)
p1, _, met = step(params, init_opt_state(params, hp),
                  {"tokens": tokens, "labels": tokens})
res["reference_step"] = {"loss": float(met["loss"]),
                         "params": gather_tree(p1)}
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(OMP_NUM_THREADS=THREADS, MKL_NUM_THREADS=THREADS, **extra)
    return env


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The reference's step in one subprocess beside the four-rank worker
    (which waits for its npz only at the end); (the reference's npz,
    [rank r's results])."""
    d = tmp_path_factory.mktemp("ep")
    ref = d / "reference.npz"
    jax_side = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref), *map(str, WIDE)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    args = json.dumps({"archs": ARCHS, "meshes": MESHES, "wide": WIDE,
                       "narrow": NARROW, "prompt": PROMPT, "gen": GEN,
                       "fault_experts": FAULT_EXPERTS})
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d / "out"), str(ref), args],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    _, err = jax_side.communicate(timeout=600)
    if jax_side.returncode != 0:
        for p in procs:
            p.kill()
        pytest.fail(err[-4000:])
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return (dict(np.load(ref)),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


def _cfg(arch, n_experts=None):
    import dataclasses
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    if n_experts is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts))


_PLAIN: dict = {}


def _plain(arch, batch_shape, n_experts=None, logits=False):
    """The one-process plain step's (loss, {path: gradient}, logits) of
    float32 ``arch`` on ``synthetic_batch(cfg, *batch_shape, 0)``."""
    key = (arch, batch_shape, n_experts, logits)
    if key not in _PLAIN:
        from repro_torch.distributed.sharding import tree_map
        from repro_torch.launch.train import synthetic_batch
        from repro_torch.models import model as M
        from repro_torch.train.steps import (TrainHParams, loss_and_grads,
                                             make_prefill_step)
        cfg = _cfg(arch, n_experts)
        params = tree_map(lambda t: t.float(), M.init_model(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        batch = synthetic_batch(cfg, *batch_shape, 0)
        loss, _, grads = loss_and_grads(params, cfg, batch,
                                        TrainHParams(loss_chunk=512))
        out = make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})[0] \
            if logits else None
        _PLAIN[key] = (float(loss), dict(_leaves(grads)), out)
    return _PLAIN[key]


def _check_loss_and_grads(got, want):
    loss, grads, _ = got
    want_loss, want_grads, _ = want
    assert abs(loss - want_loss) <= LOSS_F32_RTOL * want_loss, (loss,
                                                                want_loss)
    grads = dict(_leaves(grads))
    assert grads.keys() == want_grads.keys()
    for k, w in want_grads.items():
        err = float((grads[k] - w).norm() / w.norm())
        assert err <= GRAD_RTOL, (k, err)


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m}" for a, m in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_exchanging_step_matches_the_plain_step(group, arch, shape):
    """Form (a): the loss, every gradient and the prefill's logits."""
    want = _plain(arch, WIDE, logits=True)
    for r in group[1]:
        got = r[(arch, shape)]
        _check_loss_and_grads(got["wide"], want)
        err = float((got["logits"] - want[2]).abs().max())
        assert err <= LOGITS_RTOL * float(want[2].abs().max()), err


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_spanning_groups_match_the_plain_step(group, arch, shape):
    """Form (b): the loss, every gradient (the aux's counts are the whole
    batch's) and the greedy tokens of a prefill and GEN decode steps."""
    from test_torch_tensor_parallel import _plain_tokens
    want = _plain(arch, NARROW)
    tokens = _plain_tokens(arch, prompt=PROMPT)[0]
    for r in group[1]:
        got = r[(arch, shape)]
        _check_loss_and_grads(got["narrow"], want)
        assert torch.equal(got["tokens"], tokens)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_each_rank_owns_whole_experts(group, arch, shape):
    """Rank (d, m) uses block d * n_model + m of each expert stack as it
    holds it (DTensor's order), and plans ``ep`` over ``model`` (where it
    has more than one rank) and the exchange over ``data``."""
    from repro_torch.distributed.sharding import flat_tree
    from repro_torch.models import model as M
    cfg = _cfg(arch)
    full = flat_tree(M.init_model(cfg, torch.Generator().manual_seed(0),
                                  "cpu"))[("layers", "moe", "w_gate")][0]
    data, tp = shape
    e = cfg.moe.n_experts // (data * tp)
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        d, m = divmod(rank, tp)
        assert got["plan"] == {"ep": ("model", tp, m) if tp > 1 else None,
                               "a2a": ("data", data, d)}
        block = d * tp + m
        assert torch.equal(got["w_gate"], full[block * e:(block + 1) * e]
                           .float())


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_tokens_move_instead_of_the_experts(group, arch, shape):
    """The counted all-to-all bytes are six exchanges of each MoE layer's
    buffer; the all-gather bytes are below the ``tp_ep`` step's by the
    expert stacks that step gathers (forward and remat'd recompute)."""
    cfg = _cfg(arch)
    mo, (b, s), (data, tp) = cfg.moe, WIDE, shape
    n_moe = cfg.n_layers - mo.n_dense_layers
    tokens = b // data * s                       # a rank's tokens
    tg = 2048                                    # _pick_group_size
    cap = max(int(mo.capacity_factor * tg * mo.top_k / mo.n_experts), 4)
    e = mo.n_experts // (data * tp)
    buffer = data * e * (tokens // tg) * cap * cfg.d_model * 4
    stacks = 2 * n_moe * 3 * (mo.n_experts // tp) * cfg.d_model \
        * mo.d_ff_expert * 4
    for r in group[1]:
        got = r[(arch, shape)]
        coll, before = got["wide"][2], got["wide_tp_ep_coll"]
        assert coll["all-to-all"] == 6 * n_moe * buffer, coll
        assert before["all-to-all"] == 0, before
        assert before["all-gather"] - coll["all-gather"] >= stacks, (
            before["all-gather"], coll["all-gather"], stacks)


def test_the_recompute_on_another_thread_keeps_the_split(group):
    """Reduced qwen3-moe on (2, 2), form (b): the backward, and with it
    each remat'd layer's recompute, run on a thread of its own that has
    no active batch split (as autograd's device thread on a card): the
    same gradients bit for bit as a backward inside the split."""
    for r in group[1]:
        inside, thread = r["threaded"]
        assert len(inside) == len(thread)
        for a, b in zip(inside, thread):
            assert torch.equal(a, b)


def test_int8_moments_keep_the_expert_shards(group):
    """Two steps of a 3-layer, d_model-256 qwen3-moe with int8 moments
    on (2, 2) (B = 4, S = 16), as ``tests/test_torch_tensor_parallel.py``
    holds its int8 runs against the plain steps; the ``w_down`` moments
    split the experts over ``("model", "data")`` as the stack does, and
    Adam on each expert stack (``ruled_adam_leaf``, the ruled step's
    update of one leaf) runs no collective and keeps both shards."""
    import dataclasses
    from test_torch_ranks import (LOSS_RTOL_FIRST, MOMENT_RTOL, OFF_SHARE,
                                  _moments, _update_error)
    from test_torch_tensor_parallel import _plain_bf16
    cfg = dataclasses.replace(_cfg("qwen3-moe-30b-a3b"), n_layers=3,
                              d_model=256)
    want_losses, want_params, want_opt, p0 = _plain_bf16(
        None, cfg, torch.float32, quantized_opt_state=True)
    got = group[1][0]["int8"]
    assert got["spec"][1] == ("model", "data")
    assert got["adam"]["w_down"][2]                  # int8 moments
    for r in group[1]:
        assert r["int8"]["losses"] == got["losses"]
        for name, (coll, placed, _) in r["int8"]["adam"].items():
            assert not any(coll.values()), (name, coll)
            assert placed == [("Shard", 1), ("Shard", 1)], (name, placed)
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want_losses)]
    assert max(rel) <= LOSS_RTOL_FIRST, rel
    mg, mw = _moments(got["opt"]), _moments(want_opt)
    assert mg.keys() == mw.keys()
    for k in mw:
        err = float((mg[k] - mw[k]).norm() / mw[k].norm())
        assert err <= MOMENT_RTOL, (k, err)
    n_off = n_all = 0
    for (k, a), (k2, b) in zip(_leaves(got["params"]), _leaves(want_params)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        err, tol = _update_error(a, b, p0[k])
        n_off, n_all = n_off + int((err > tol).sum()), n_all + a.numel()
    assert n_off <= OFF_SHARE * n_all, n_off / n_all


def test_one_data_rank_is_the_tp_ep_step(group):
    """On (1, 4) the ``tp_ep_full`` rules split the experts over
    ``model`` alone: no exchange group, and the ``tp_ep`` step's loss and
    gradients bit for bit."""
    for r in group[1]:
        full, ep = r["one_data_rank"]["tp_ep_full"], \
            r["one_data_rank"]["tp_ep"]
        assert full[0]["a2a"] is None and full[0]["ep"] == ep[0]["ep"]
        assert full[0]["ep"][:2] == ("model", 4)
        assert full[1][0] == ep[1][0]
        a, b = dict(_leaves(full[1][1])), dict(_leaves(ep[1][1]))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert full[1][2]["all-to-all"] == 0


def test_experts_the_axes_do_not_divide_run_replicated(group):
    """FAULT_EXPERTS experts divide ``model`` but not ``model`` x
    ``data``: ``param_pspec`` replicates them, ``hold`` succeeds with no
    expert group, and every rank runs all of them on its own tokens: the
    plain step's loss and gradients."""
    want = _plain("qwen3-moe-30b-a3b", WIDE, FAULT_EXPERTS)
    for r in group[1]:
        got = r["fault"]
        assert got["plan"] == {"ep": None, "a2a": None}
        assert got["placements"] == ["Replicate", "Replicate"]
        _check_loss_and_grads(got["wide"], want)
        assert got["wide"][2]["all-to-all"] == 0


def test_the_references_tp_ep_full_step(group):
    """The reference's jitted step under its ``tp_ep_full`` rules on (2,
    2), and the port's four-rank step from the same float32 parameters:
    the loss within ``LOSS_F32_RTOL``, every updated element within 2 lr,
    at most ``STEP_OUTLIERS`` of them outside ``STEP_TOL``, every leaf
    moved."""
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
        assert not np.array_equal(w, start[k[1:]]), k
    assert n_out <= STEP_OUTLIERS * n_all, n_out / n_all
