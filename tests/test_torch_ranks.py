"""The port's mesh side at two ranks on the CPU: ONE spawned gloo group
(two processes on a ``FileStore``) runs every check of this module, and
each test reads its part of the results.

* the ruled train step (``make_train_step(cfg, rules, hp)``, the cell's
  strategy rules) of a reduced qwen2-1.5b (fsdp) and a reduced
  qwen3-moe-30b-a3b (tp_ep) on meshes (2, 1) and (1, 2), with
  microbatches and int8 moments in some runs, against the one-process
  plain step from the same seed and batches, two steps each: where the
  batch is split, the first loss within ``LOSS_RTOL_FIRST``, the second
  within ``LOSS_RTOL``, every leaf's Adam moments within
  ``MOMENT_RTOL`` of the plain step's (norm-wise), and the updates
  p - p0 element by element: at most ``OFF_SHARE`` of the tree's
  elements off, and none by more than 2 lr a step with float32
  moments. The tp_ep run on (1, 2) splits no batch but computes
  attention tensor-parallel and the MoE expert-parallel over ``model``
  (``distributed/tensor_parallel.py``), so its sums run in another
  order: it is held to the same tolerances. The tp_ep run on a one-rank
  (1, 1) mesh (rank 0 alone) is the plain step: parameters and moments
  bit for bit. Every local block of every parameter and moment has its
  shard shape;
* the MoE layer under a two-shard ``batch_split``, a routing group
  inside a shard and one spanning both: each rank's output rows equal
  the whole batch's, the shards' aux losses average to the whole batch's,
  and the summed gradients (parameters and input rows) match;
* the compressed all-reduce over ``data`` (int8 payloads and scales on
  the wire): the sum of both ranks' dequantized payloads, bit for bit;
* ``logical_constraint`` on DTensors: redistributed to the batch
  placement, and the (3, 5) array left whole on the axis that does not
  divide it;
* a checkpoint of a (2, 1) run resharded (``reshard_tree``) onto the
  (1, 2) mesh of ``replan_mesh(2, model_parallel=2)``, whose rules split
  attention and the MLP over ``model``: the resumed step's loss within
  ``LOSS_RTOL_FIRST`` of the plain step's from the restored state and
  its updates within ``OFF_SHARE`` of them, and the uninterrupted run's
  loss within ``LOSS_RTOL``; the training CLI's
  straggler policy (``remesh``) leaves the next step unchanged;
* the ruled prefill and decode step on the serving mesh: each rank's
  cache holds its half of the batch, and the gathered logits and tokens
  are the one-process step's;
* the train CLI at two ranks against one process (losses), and the serve
  CLI at two ranks (the same tokens).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

LOSS_RTOL_FIRST = 1e-5     # the same parameters, another summation order
LOSS_RTOL = 2e-3           # after Adam steps whose sign(g) may flip
# Each leaf's Adam moments (the reduced gradients' running sums), as a
# norm-wise relative error: bf16 gradients of a batch cut in two round
# at other shapes. Cutting the same batch into two microbatches moves
# the plain step's moments as far (the MoE router's most: its routes
# flip at capacity); a shard's gradient dropped, or left unreduced,
# moves them by 54-68 % (planted faults).
MOMENT_RTOL = 0.25
# The share of the tree's elements whose update p - p0 is off the plain
# step's by more than ``_update_error``'s tolerance (PR 22's rule for
# the plain step against the reference): where Adam's sign(g) flips on
# a gradient at rounding noise (a key bias's is all noise: softmax does
# not see a bias added to every key's score), and where an int8 second
# moment rounds to zero in one step and not in the other (the
# reference's Adam-8bit arithmetic, kept as it is; no bound per element
# then). A skipped update leaves every element off.
OFF_SHARE = 0.01

B, S = 4, 16
RUNS = (("qwen2-1.5b", (2, 1), {}, 2),
        ("qwen2-1.5b", (1, 2), {"n_micro": 2}, 2),
        ("qwen3-moe-30b-a3b", (2, 1), {}, 2),
        ("qwen3-moe-30b-a3b", (1, 2), {"quantized_opt_state": True}, 2),
        ("qwen3-moe-30b-a3b", (2, 1), {"quantized_opt_state": True,
                                       "n_micro": 2}, 2),
        ("qwen3-moe-30b-a3b", (1, 1), {"quantized_opt_state": True}, 2))

WORKER = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import torch.distributed as dist
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.distributed.compression import (compress_error_feedback,
                                                 compressed_allreduce,
                                                 init_error)
from repro_torch.distributed.elastic import (replan_mesh, reshard_tree,
                                             rules_for)
from repro_torch.distributed.sharding import (LOGICAL_RULES_1POD, BatchSplit,
                                              MeshRules, batch_split,
                                              gather_tree, logical_constraint,
                                              mesh_rules, param_shardings,
                                              tree_map_with_path)
from repro_torch.launch.mesh import (init_distributed, make_rules,
                                    make_serving_mesh, mesh_over)
from repro_torch.launch.serve import _grow_cache
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.strategy import pick_strategy
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import remesh, synthetic_batch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train.steps import (TrainHParams, greedy, init_opt_state,
                                     make_prefill_step, make_serve_step,
                                     make_train_step, opt_state_shardings)

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, out, work = sys.argv[3], sys.argv[4], sys.argv[5]
B, S = int(sys.argv[6]), int(sys.argv[7])
RUNS = eval(sys.argv[8])
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
res = {}


def shard_mismatches(tree, shardings):
    bad = []

    def one(path, x, sh):
        if isinstance(x, int):
            return
        want = sh.shard_shape(tuple(x.shape))
        if tuple(x.to_local().shape) != want:
            bad.append((path, tuple(x.to_local().shape), want))
    tree_map_with_path(one, tree, shardings)
    return bad


def leaves(tree):
    out = []
    tree_map_with_path(lambda _, t: out.append(t), tree)
    return out


def init(cfg, hp):
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return params, init_opt_state(params, hp)


for arch, shape, kw, steps in RUNS:
    cfg = get_reduced(arch)
    mesh = mesh_over(shape, ("data", "model"))
    if mesh.get_coordinate() is None:       # a mesh of rank 0 alone
        continue
    strat = pick_strategy(cfg, SHAPES["train_4k"])
    rules = MeshRules(mesh, strat.logical_rules)
    hp = TrainHParams(loss_chunk=8, **kw)
    params, opt = init(cfg, hp)
    step = make_train_step(cfg, rules, hp)
    losses = []
    for i in range(steps):
        params, opt, met = step(params, opt, synthetic_batch(cfg, B, S, i))
        losses.append(float(met["loss"]))
    bad = shard_mismatches(params, param_shardings(params, rules))
    osh = opt_state_shardings(opt, params, rules)
    for t, sh in zip(opt[1:], osh[1:]):
        if t is not None:
            bad += shard_mismatches(t, sh)
    res[(arch, shape, str(kw))] = {"losses": losses,
                                   "params": gather_tree(params),
                                   "opt": gather_tree(opt),
                                   "bad_shards": bad}

# the MoE layer under a two-shard batch split
cfg = get_reduced("qwen3-moe-30b-a3b")
mesh = mesh_over((2, 1), ("data", "model"))
g = torch.Generator().manual_seed(3)
p = MOE.init_moe(cfg, g, torch.device("cpu"))
p = {k: v.float() for k, v in p.items()}
x = torch.randn(4, 8, cfg.d_model, generator=g)
w = torch.randn(4, 8, cfg.d_model, generator=g)
moe = {}
for group in (8, 32):                  # inside a shard; spanning both
    pw = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    y, aux = MOE.moe_mlp(pw, xw, cfg, group_size=group)
    ((y * w).sum() + aux).backward()
    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    rows = slice(2 * rank, 2 * rank + 2)
    xl = x[rows].clone().requires_grad_()
    with batch_split(BatchSplit(mesh, ("data",))):
        yl, auxl = MOE.moe_mlp(pl, xl, cfg, group_size=group)
    ((yl * w[rows]).sum() + auxl / 2).backward()
    aux_mean = auxl.detach().clone()
    dist.all_reduce(aux_mean)
    y, aux = y.detach(), aux.detach()
    errs = {"y": float((yl.detach() - y[rows]).abs().max()),
            "aux": float((aux_mean / 2 - aux).abs()),
            "aux_value": float(aux),
            "x_grad": float((xl.grad - xw.grad[rows]).abs().max())}
    for k in p:
        gsum = pl[k].grad.clone()
        dist.all_reduce(gsum)
        errs["grad_" + k] = float((gsum - pw[k].grad).abs().max()
                                  / pw[k].grad.abs().max())
    moe[group] = errs
res["moe"] = moe

# the compressed all-reduce over data, bit for bit with the two payloads
def grads_of(r):
    gg = torch.Generator().manual_seed(100 + r)
    return {"w": torch.randn(33, 47, generator=gg),
            "b": {"c": torch.randn(5, generator=gg)}}
total, err = compressed_allreduce(grads_of(rank), init_error(grads_of(rank)),
                                  mesh, "data")
deq = [compress_error_feedback(grads_of(r), init_error(grads_of(r)))[1]
       for r in range(2)]
res["allreduce"] = (torch.equal(total["w"], deq[0]["w"] + deq[1]["w"])
                    and torch.equal(total["b"]["c"],
                                    deq[0]["b"]["c"] + deq[1]["b"]["c"]))

# logical_constraint on DTensors
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
rules = MeshRules(mesh, LOGICAL_RULES_1POD)
full = torch.arange(24.0).reshape(4, 6)
xd = distribute_tensor(full, mesh, [Replicate(), Replicate()])
odd = distribute_tensor(torch.ones(3, 5), mesh, [Replicate(), Replicate()])
with mesh_rules(rules):
    yd = logical_constraint(xd, "batch", None)
    zd = logical_constraint(odd, "batch", "tensor")
res["constraint"] = (list(yd.placements) == [Shard(0), Replicate()]
                     and torch.equal(yd.full_tensor(), full)
                     # 3 rows do not divide over data's 2; model's 1 does
                     and list(zd.placements) == [Replicate(), Shard(1)]
                     and torch.equal(zd.full_tensor(), torch.ones(3, 5)))

# a checkpoint of a (2, 1) run resharded onto (1, 2)
cfg = get_reduced("qwen2-1.5b")
hp = TrainHParams(loss_chunk=8)
rules_a = rules_for(mesh)
step_a = make_train_step(cfg, rules_a, hp)
params, opt = init(cfg, hp)
params, opt, _ = step_a(params, opt, synthetic_batch(cfg, B, S, 0))
state = gather_tree((params, opt))
if rank == 0:
    save_checkpoint(work, 1, state)
dist.barrier()
restored, _ = load_checkpoint(work, 1, init(cfg, hp))
mesh_b = replan_mesh(2, model_parallel=2)
p_b, o_b = reshard_tree(restored, mesh_b)
batch1 = synthetic_batch(cfg, B, S, 1)
p_b, o_b, m_b = make_train_step(cfg, rules_for(mesh_b), hp)(p_b, o_b, batch1)
p_p, o_p, m_p = make_train_step(cfg, None, hp)(*restored, batch1)
p_a, o_a, m_a = step_a(params, opt, batch1)
p_b = gather_tree(p_b)
res["resume"] = {
    "mesh": tuple(mesh_b.mesh.shape), "names": mesh_b.mesh_dim_names,
    "loss_plain": float(m_p["loss"]), "params": p_b, "plain": p_p,
    "restored": restored[0],
    "loss": float(m_b["loss"]), "uninterrupted": float(m_a["loss"])}
# the straggler policy: snapshot, re-plan over the ranks, reshard
p_r, o_r, rules_r = remesh(params, opt, rules_a)
p_r, _, m_r = make_train_step(cfg, rules_r, hp)(p_r, o_r, batch1)
res["remesh"] = (tuple(rules_r.mesh.mesh.shape),
                 float(m_r["loss"]) == float(m_a["loss"]) and
                 torch.equal(gather_tree(p_r)["embed"],
                             gather_tree(p_a)["embed"]))

# the ruled prefill and decode step on the serving mesh: each rank
# serves its half of the batch, the logits and tokens come back whole
cfg = get_reduced("qwen2-1.5b")
params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
toks = torch.randint(0, cfg.vocab_size, (B, 8),
                     generator=torch.Generator().manual_seed(5))
srules = make_rules(make_serving_mesh())
logits, st = make_prefill_step(cfg, rules=srules)(params, {"tokens": toks})
nxt, st = make_serve_step(cfg, rules=srules)(
    params, greedy(logits)[:, None], _grow_cache(cfg, st, B // 2, 9, "cpu"))
want_logits, want_st = make_prefill_step(cfg)(params, {"tokens": toks})
want_nxt, want_st = make_serve_step(cfg)(
    params, greedy(want_logits)[:, None],
    _grow_cache(cfg, want_st, B, 9, "cpu"))
rows = slice(rank * B // 2, (rank + 1) * B // 2)
res["serve_split"] = {
    "cache_rows": st["main"]["k"].shape[1],
    "cache_err": float((st["main"]["k"].float()
                        - want_st["main"]["k"][:, rows].float()).abs().max()),
    "cache_max": float(want_st["main"]["k"].float().abs().max()),
    "logits_err": float((logits.float() - want_logits.float()).abs().max()),
    "logits_max": float(want_logits.float().abs().max()),
    "tokens_equal": torch.equal(nxt, want_nxt)}

# the CLIs at two ranks
res["train_cli"] = train_main(["--arch", "qwen2-1.5b", "--reduced",
                               "--steps", "3", "--batch", str(B), "--seq",
                               str(S), "--device", "cpu", "--ckpt-dir",
                               work + "/cli", "--ckpt-every", "2"])
res["serve_cli"] = serve_main(["--arch", "qwen2-1.5b", "--reduced",
                               "--batch", "2", "--prompt-len", "8", "--gen",
                               "4", "--device", "cpu"])
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two-rank worker once; (rank 0's results, rank 1's)."""
    d = tmp_path_factory.mktemp("ranks")
    (d / "work").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(d / "store"),
         str(d / "out"), str(d / "work"), str(B), str(S), repr(RUNS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return [torch.load(d / f"out.{r}", weights_only=False) for r in range(2)]


def _plain(arch, kw, steps):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                         make_train_step)
    cfg = get_reduced(arch)
    hp = TrainHParams(loss_chunk=8, **kw)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params, hp)
    step = make_train_step(cfg, None, hp)
    losses = []
    for i in range(steps):
        params, opt, met = step(params, opt, synthetic_batch(cfg, B, S, i))
        losses.append(float(met["loss"]))
    return losses, params, opt


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _moments(opt) -> dict:
    """{(moment, path): float32 value}: int8 moments dequantized."""
    out = {}
    for name in ("m", "v"):
        scales = dict(_leaves(getattr(opt, name + "_scale") or {}))
        for k, x in _leaves(getattr(opt, name)):
            s = scales.get(k)
            if s is not None and s.numel() > 0:
                x = (x.float() * s).reshape(*x.shape[:-2], -1)
            out[(name, k)] = x.float()
    return out


def _update_error(p, want, p0, lr=3e-4):
    """(|u - w|, the elementwise tolerance) of a leaf's update u = p - p0
    against the plain step's w: a quarter of a step (lr / 4) plus one
    rounding of the weight (its dtype's eps). A flipped sign moves a
    weight 2 lr the other way; a skipped update leaves it lr short."""
    u, w = (p.float() - p0.float()), (want.float() - p0.float())
    return (u - w).abs(), lr / 4 + torch.finfo(p.dtype).eps * \
        want.float().abs()


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}"
                         if isinstance(r, tuple) else str(r))
def test_ruled_step_matches_the_plain_step(ranks, run):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    arch, shape, kw, steps = run
    got = ranks[0][(arch, shape, str(kw))]
    if shape != (1, 1):
        assert got["losses"] == ranks[1][(arch, shape, str(kw))]["losses"]
    want_losses, want_params, want_opt = _plain(arch, kw, steps)
    if shape == (1, 1):       # one rank: the plain step
        assert got["losses"] == want_losses
        for (k, a), (_, b) in zip(_leaves(got["params"]),
                                  _leaves(want_params)):
            assert torch.equal(a, b), k
        mg, mw = _moments(got["opt"]), _moments(want_opt)
        assert mg.keys() == mw.keys()
        for k in mw:
            assert torch.equal(mg[k], mw[k]), k
        return
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want_losses)]
    assert rel[0] <= LOSS_RTOL_FIRST and max(rel) <= LOSS_RTOL, rel
    # the reduced gradients, through the moments they feed
    mg, mw = _moments(got["opt"]), _moments(want_opt)
    assert mg.keys() == mw.keys()
    errs = {k: float((mg[k] - mw[k]).norm() / mw[k].norm()) for k in mw}
    for k, err in errs.items():
        assert err <= MOMENT_RTOL, (k, err)
    # the updates, element by element
    p0 = dict(_leaves(M.init_model(get_reduced(arch),
                                   torch.Generator().manual_seed(0), "cpu")))
    n_off, n_all, worst = 0, 0, {}
    for (k, a), (k2, b) in zip(_leaves(got["params"]), _leaves(want_params)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        err, tol = _update_error(a, b, p0[k])
        off = int((err > tol).sum())
        n_off, n_all = n_off + off, n_all + a.numel()
        worst[k] = off / a.numel()
        if not kw.get("quantized_opt_state"):
            # no sign flip moves a weight more than 2 lr a step
            assert bool((err <= 2 * 3e-4 * steps + tol).all()), k
    assert n_all == sum(t.numel() for t in p0.values())
    assert n_off <= OFF_SHARE * n_all, (n_off / n_all, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3])
    print(f"{arch} {shape} {kw}: moments at most {max(errs.values()):.4f} "
          f"off norm-wise; {n_off / n_all:.5f} of the updates off")


@pytest.mark.parametrize("rank", [0, 1])
def test_every_local_block_has_its_shard_shape(ranks, rank):
    for arch, shape, kw, _ in RUNS:
        if rank and shape == (1, 1):
            continue
        assert ranks[rank][(arch, shape, str(kw))]["bad_shards"] == [], \
            (arch, shape, kw)


@pytest.mark.parametrize("group", [8, 32])
def test_moe_under_a_batch_split(ranks, group):
    for r in ranks:
        e = r["moe"][group]
        assert e["y"] == 0.0 and e["x_grad"] <= 1e-6, e
        assert e["aux"] <= 1e-6 * abs(e["aux_value"]), e
        for k, v in e.items():
            if k.startswith("grad_"):
                assert v <= 1e-5, (k, v)


def test_compressed_allreduce_and_constraints(ranks):
    for r in ranks:
        assert r["allreduce"] is True
        assert r["constraint"] is True


def test_ruled_serving_splits_the_batch(ranks):
    for r in ranks:
        got = r["serve_split"]
        assert got["cache_rows"] == B // 2          # this rank's shard only
        # the same rows at another batch size: matmuls at other shapes
        assert got["logits_err"] <= 2.0 ** -20 * got["logits_max"], got
        assert got["cache_err"] <= 2.0 ** -8 * got["cache_max"], got  # bf16
        assert got["tokens_equal"] is True


def test_checkpoint_resharded_onto_a_new_mesh(ranks):
    for r in ranks:
        got = r["resume"]
        assert got["mesh"] == (1, 2) and got["names"] == ("data", "model")
        assert abs(got["loss"] - got["loss_plain"]) <= \
            LOSS_RTOL_FIRST * abs(got["loss_plain"])
        n_off = n_all = 0
        p0 = dict(_leaves(got["restored"]))
        for (k, a), (k2, b) in zip(_leaves(got["params"]),
                                   _leaves(got["plain"])):
            assert k == k2 and a.shape == b.shape, k
            err, tol = _update_error(a, b, p0[k])
            assert bool((err <= 2 * 3e-4 + tol).all()), k
            n_off, n_all = n_off + int((err > tol).sum()), n_all + a.numel()
        assert n_off <= OFF_SHARE * n_all, n_off / n_all
        assert abs(got["loss"] - got["uninterrupted"]) <= \
            LOSS_RTOL * abs(got["uninterrupted"])
        assert r["remesh"] == ((2, 1), True)


def test_clis_at_two_ranks(ranks, tmp_path):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    want = train_main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
                       "--batch", str(B), "--seq", str(S), "--device",
                       "cpu"])
    for r in ranks:
        got = r["train_cli"]
        assert len(got) == 3 and abs(got[0] - want[0]) <= \
            LOSS_RTOL_FIRST * abs(want[0])
        assert all(abs(a - b) <= LOSS_RTOL * abs(b)
                   for a, b in zip(got, want)), (got, want)
    assert ranks[0]["train_cli"] == ranks[1]["train_cli"]
    toks = serve_main(["--arch", "qwen2-1.5b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    for r in ranks:
        assert (r["serve_cli"] == toks).all()
