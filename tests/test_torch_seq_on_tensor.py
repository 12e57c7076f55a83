"""Sequence parallelism over the tensor axis (``Plan.sp``: the rules put
``seq`` on ``model`` beside ``tensor``, the dry run's ``--seq-shard``) at
four ranks on the CPU. ONE spawned gloo group of four ``python -c``
workers on a ``FileStore`` runs every four-rank check of this module on
the meshes (1, 4) and (2, 2) (data x model) of the same group, beside one
subprocess that runs the reference's jitted steps on a forced 4-device
(1, 4) CPU mesh; each test reads its part of the results. The rules are
``prefill_32k``'s ``tp_ep`` with ``"seq": "model"``.

* Float32 parameters of reduced qwen2-1.5b (GQA attention split: path
  (a)), of qwen2-1.5b with 6 q heads and a vocabulary of 250, which 4
  ranks do not divide (the attention on each segment alone, path (b),
  and a head computed whole that counts the loss once), qwen2-vl-7b
  (M-RoPE's [3, B, S] positions), qwen3-moe-30b-a3b (the MoE's tokens
  gathered before routing, its aux counted once), deepseek-v3-671b
  (MLA, path (a)) and with 6 MLA heads (gathered, whole, narrowed),
  rwkv6-3b (2 heads: on (1, 4) the WKV carry of path (b), on (2, 2)
  path (a)), zamba2-7b (Mamba-2 and the shared block, path (a)) and with
  d_model 48 (6 Mamba-2 heads: path (b), the conv's previous rows and
  the SSD carry) and musicgen-medium (codebooks): against the
  one-process plain step from the same seed and batch, the train step's
  loss within ``LOSS_F32_RTOL`` and every gradient leaf within a
  relative norm of ``GRAD_RTOL``; the ruled prefill's last-token logits
  within ``LOGITS_RTOL`` of their largest magnitude; the greedy tokens of
  a prefill and GEN decode steps (the cache grown under the rules) equal;
  each rank's ``Plan.sp`` (the ``model`` group at its coordinate), its
  tokens its batch rows of its segment, and every leaf of its prefill's
  decode state the plain prefill's state cut to the placement
  ``mesh_plan`` gives the decode (``tensor_parallel.state_block``), of
  its shape and dtype, within ``STATE_RTOL`` (and one rounding of each
  value in the bf16 caches);
* a one-rank ``model`` axis (4, 1): the step, prefill and decode equal
  the same rules' with ``"seq": None`` bit for bit, ``Plan.sp`` None; a
  sequence that 4 does not divide (S = 15) keeps the sequences whole,
  the same bit for bit;
* the reference's jitted ``make_train_step`` and ``make_prefill_step``
  of reduced qwen2-1.5b, qwen3-moe-30b-a3b, deepseek-v3-671b, rwkv6-3b
  and zamba2-7b under the same rules on a
  forced (1, 4) mesh, from the same float32 parameters carried across
  with ``params_from_numpy``: the port's four-rank loss within
  ``LOSS_RTOL`` of the reference's and its last-token logits within
  ``LOGITS_RTOL`` of their largest magnitude.

One process, no group: the dry run counts the last segment's first rank
(rank 15) of a ``--seq-shard`` ``prefill_32k`` or MoE ``train_4k`` cell,
and rank 0 without the flag.
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

from test_torch_ranks import LOSS_RTOL, _leaves
from test_torch_tensor_parallel import (GRAD_RTOL, LOGITS_RTOL,
                                        LOSS_F32_RTOL, STATE_RTOL)

ROOT = Path(__file__).resolve().parents[1]
B, S, PROMPT, GEN = 4, 16, 8, 4
THREADS = "2"             # each process's CPU threads
# (case, arch, config changes, meshes)
CASES = (("qwen2", "qwen2-1.5b", {}, ((1, 4), (2, 2))),
         ("qwen2-odd", "qwen2-1.5b", {"n_heads": 6, "vocab_size": 250},
          ((1, 4),)),
         ("qwen2-vl", "qwen2-vl-7b", {}, ((1, 4),)),
         ("qwen3-moe", "qwen3-moe-30b-a3b", {}, ((1, 4), (2, 2))),
         ("deepseek", "deepseek-v3-671b", {}, ((1, 4),)),
         ("deepseek-odd", "deepseek-v3-671b", {"n_heads": 6}, ((1, 4),)),
         ("rwkv6", "rwkv6-3b", {}, ((1, 4), (2, 2))),
         ("zamba2", "zamba2-7b", {}, ((1, 4),)),
         ("zamba2-odd", "zamba2-7b", {"d_model": 48}, ((1, 4),)),
         ("musicgen", "musicgen-medium", {}, ((1, 4), (2, 2))))
# (name, arch, mesh, S): each keeps Plan.sp None and the step, prefill
# and decode of the same rules with "seq": None bit for bit
WHOLE = (("one-rank-model", "qwen2-1.5b", (4, 1), S),
         ("indivisible", "qwen2-1.5b", (1, 4), 15))
REFERENCE_ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                   "rwkv6-3b", "zamba2-7b")

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
from repro.train.steps import (TrainHParams, init_opt_state,
                               make_prefill_step, make_train_step)
out, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
# jax.make_mesh's explicit axes make the reference's embedding gather
# raise under jax 0.9; a Mesh of the forced host devices does not
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
flat = {}


def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(t)


for arch in sys.argv[4].split(","):
    cfg = get_reduced(arch)
    strat = pick_strategy(cfg, SHAPES["prefill_32k"])
    assert strat.name == "tp_ep", strat.name
    rules = MeshRules(mesh, dict(strat.logical_rules, seq="model"))
    hp = TrainHParams(loss_chunk=8)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      JM.init_model(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    params = jax.device_put(jax.tree.map(jnp.asarray, p0),
                            param_shardings(p0, rules))
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    _, _, met = jax.jit(make_train_step(cfg, rules, hp))(
        params, init_opt_state(params, hp), batch)
    logits, _ = jax.jit(make_prefill_step(cfg, rules))(
        params, {"tokens": jnp.asarray(tokens)})
    flat[f"{arch}/tokens"] = tokens
    flat[f"{arch}/loss"] = np.float32(met["loss"])
    flat[f"{arch}/logits"] = np.asarray(logits, np.float32)
    walk(p0, (arch, "p0"))
np.savez(out + ".tmp.npz", **flat)
os.replace(out + ".tmp.npz", out)
"""

WORKER = r"""
import dataclasses
import json
import os
import sys
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
from repro_torch.launch.mesh import init_distributed, mesh_over
from repro_torch.launch.serve import _grow_cache
from repro_torch.launch.strategy import pick_strategy
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, batch_shard, greedy,
                                     make_prefill_step, make_serve_step,
                                     place_params, ruled_loss_and_grads)

rank, world, store, out, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
args = json.loads(sys.argv[6])
B, S, PROMPT, GEN = args["b"], args["s"], args["prompt"], args["gen"]
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
hp = TrainHParams(loss_chunk=8)
res = {}


def config(arch, changes):
    return dataclasses.replace(get_reduced(arch), **changes)


def rules_of(cfg, shape, seq="model"):
    strat = pick_strategy(cfg, SHAPES["prefill_32k"])
    assert strat.name == "tp_ep", strat
    return MeshRules(mesh_over(tuple(shape), ("data", "model")),
                     dict(strat.logical_rules, seq=seq))


def f32(cfg):
    return tree_map(lambda t: t.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))


def prompt_of(cfg, n):
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return torch.randint(0, cfg.vocab_size, (B, n, *k),
                         generator=torch.Generator().manual_seed(5))


def prefill_batch(cfg, s):
    batch = synthetic_batch(cfg, B, s, 0)
    return {k: v for k, v in batch.items() if k != "labels"}


def sp_of(cfg, rules, batch):
    mine, split = batch_shard(batch, rules, cfg)
    with mesh_rules(rules), batch_split(split):
        sp = TP.plan_for(cfg).sp
    return mine, None if sp is None else (sp.dim, sp.size, sp.index)


def decode(cfg, params, toks, rules):
    with torch.no_grad():
        logits, st = make_prefill_step(cfg, rules)(params, {"tokens": toks})
        rows = batch_shard({"tokens": toks}, rules)[0]["tokens"].shape[0]
        st = _grow_cache(cfg, st, rows, toks.shape[1] + GEN, "cpu", rules)
        nxt, seq = greedy(logits), []
        serve = make_serve_step(cfg, rules)
        for _ in range(GEN):
            nxt, st = serve(params, nxt[:, None], st)
            seq.append(nxt)
    return torch.stack([greedy(logits)] + seq, 1)


def state_pairs(cfg, params, batch, rules):
    # the ruled prefill's state and the plain prefill's, cut to this
    # rank's batch rows and to the placement mesh_plan gives the decode
    with torch.no_grad():
        _, got = make_prefill_step(cfg, rules)(params, batch)
        _, want = make_prefill_step(cfg)(params, batch)
    split = batch_shard(batch, rules)[1]
    plan = TP.mesh_plan(cfg, rules)
    got, pairs = flat_tree(got), {}
    for path, w in flat_tree(want).items():
        if path[-1] != "len":
            w = split.local(w.transpose(0, 1)).transpose(0, 1)
            w = TP.state_block(cfg, plan, path, w)
        pairs[path] = (got[path], w)
    return pairs


def ruled(cfg, rules, batch):
    loss, _, grads = ruled_loss_and_grads(place_params(f32(cfg), rules),
                                          cfg, batch, hp, rules)
    return float(loss), gather_tree(grads)


for case, arch, changes, shapes in args["cases"]:
    cfg = config(arch, changes)
    batch = synthetic_batch(cfg, B, S, 0)
    for shape in shapes:
        rules = rules_of(cfg, shape)
        mine, sp = sp_of(cfg, rules, batch)
        r = res[(case, tuple(shape))] = {"sp": sp, "mine": mine}
        r["ruled"] = ruled(cfg, rules, batch)
        pre = prefill_batch(cfg, S)
        with torch.no_grad():
            r["logits"] = make_prefill_step(cfg, rules)(f32(cfg), pre)[0]
        r["state"] = state_pairs(cfg, f32(cfg), pre, rules)
        r["tokens"] = decode(cfg, f32(cfg), prompt_of(cfg, PROMPT), rules)

# the whole-sequence cases: Plan.sp None, and the same rules with "seq":
# None bit for bit
for name, arch, shape, s in args["whole"]:
    cfg = get_reduced(arch)
    batch = synthetic_batch(cfg, B, s, 0)
    got, want = (rules_of(cfg, shape, seq) for seq in ("model", None))
    steps = [ruled(cfg, r, batch) for r in (got, want)]
    same = steps[0][0] == steps[1][0] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            sorted(flat_tree(steps[0][1]).items()),
            sorted(flat_tree(steps[1][1]).items())))
    with torch.no_grad():
        outs = [make_prefill_step(cfg, r)(f32(cfg), prefill_batch(cfg, s))
                for r in (got, want)]
    same = same and torch.equal(outs[0][0], outs[1][0]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            sorted(flat_tree(outs[0][1]).items()),
            sorted(flat_tree(outs[1][1]).items())))
    toks = [decode(cfg, f32(cfg), prompt_of(cfg, s), r) for r in (got, want)]
    res[name] = {"sp": sp_of(cfg, got, batch)[1],
                 "same": same and torch.equal(*toks), "ruled": steps[0]}

# the reference's jitted steps on (1, 4), from its parameters
while not os.path.exists(ref):
    time.sleep(0.2)
z = np.load(ref)


def tree_of(prefix):
    tree = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return tree


for arch in args["reference"]:
    cfg = get_reduced(arch)
    params = M.params_from_numpy(tree_of(f"{arch}/p0"), cfg, "cpu")
    tokens = torch.from_numpy(z[f"{arch}/tokens"])
    rules = rules_of(cfg, (1, 4))
    loss, _, _ = ruled_loss_and_grads(place_params(params, rules), cfg,
                                      {"tokens": tokens, "labels": tokens},
                                      hp, rules)
    with torch.no_grad():
        logits = make_prefill_step(cfg, rules)(params, {"tokens": tokens})[0]
    res[("reference", arch)] = {"loss": float(loss), "logits": logits}
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(OMP_NUM_THREADS=THREADS, MKL_NUM_THREADS=THREADS, **extra)
    return env


def _popen(*argv):
    return subprocess.Popen([sys.executable, "-c", *map(str, argv)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The reference's steps in one subprocess beside the four-rank
    worker (which waits for the reference's npz only at the end); (the
    reference's npz, [rank r's results])."""
    d = tmp_path_factory.mktemp("sp")
    ref = d / "reference.npz"
    jax_side = _popen(REFERENCE, ref, B, S, ",".join(REFERENCE_ARCHS))
    args = json.dumps({"b": B, "s": S, "prompt": PROMPT, "gen": GEN,
                       "cases": CASES, "whole": WHOLE,
                       "reference": REFERENCE_ARCHS})
    procs = [_popen(WORKER, r, 4, d / "store", d / "out", ref, args)
             for r in range(4)]
    _, err = jax_side.communicate(timeout=600)
    assert jax_side.returncode == 0, err[-4000:]
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (_, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return (dict(np.load(ref)),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


def _config(arch, changes):
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), **changes)


@functools.lru_cache(maxsize=None)
def _plain(case, s=S):
    """The one-process plain step's float32 loss and gradients, the last
    prefill logits and the greedy tokens of ``case``."""
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainHParams, greedy,
                                         loss_and_grads, make_prefill_step,
                                         make_serve_step)
    _, arch, changes, _ = next(c for c in CASES + tuple(
        (w[0], w[1], {}, ()) for w in WHOLE) if c[0] == case)
    cfg = _config(arch, changes)
    params = tree_map(lambda t: t.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = synthetic_batch(cfg, B, s, 0)
    loss, _, grads = loss_and_grads(params, cfg, batch,
                                    TrainHParams(loss_chunk=8))
    with torch.no_grad():
        logits = make_prefill_step(cfg)(params, {
            k: v for k, v in batch.items() if k != "labels"})[0]
        k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        toks = torch.randint(0, cfg.vocab_size, (B, PROMPT, *k),
                             generator=torch.Generator().manual_seed(5))
        lg, st = make_prefill_step(cfg)(params, {"tokens": toks})
        st = _grow_cache(cfg, st, B, PROMPT + GEN, "cpu")
        nxt, seq = greedy(lg), []
        serve = make_serve_step(cfg)
        for _ in range(GEN):
            nxt, st = serve(params, nxt[:, None], st)
            seq.append(nxt)
    return (float(loss), dict(_leaves(grads)), logits,
            torch.stack([greedy(lg)] + seq, 1))


def _near_plain(case, got, s=S) -> None:
    want_loss, want = _plain(case, s)[:2]
    loss, grads = got
    assert abs(loss - want_loss) <= LOSS_F32_RTOL * want_loss, (loss,
                                                                want_loss)
    grads = dict(_leaves(grads))
    assert grads.keys() == want.keys()
    for k, w in want.items():
        err = float((grads[k] - w).norm() / w.norm())
        assert err <= GRAD_RTOL, (k, err)


def _near_logits(got, want) -> None:
    scale = float(want.abs().max())
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float((got - want).abs().max()) <= LOGITS_RTOL * scale


SPLIT = [(c[0], m) for c in CASES for m in c[3]]
IDS = [f"{c}-{m}" for c, m in SPLIT]


@pytest.mark.parametrize("case,shape", SPLIT, ids=IDS)
def test_the_train_step_matches_the_plain_step(group, case, shape):
    """And each rank's ``Plan.sp`` is ``model`` at its coordinate, and its
    tokens, labels and positions its batch rows of its segment."""
    from repro_torch.launch.train import synthetic_batch
    _, arch, changes, _ = next(c for c in CASES if c[0] == case)
    batch = synthetic_batch(_config(arch, changes), B, S, 0)
    data, model = shape
    rows, seg = B // data, S // model
    for rank, r in enumerate(group[1]):
        got = r[(case, shape)]
        d, m = divmod(rank, model)
        assert got["sp"] == ("model", model, m)
        rs, ss = slice(d * rows, (d + 1) * rows), slice(m * seg,
                                                        (m + 1) * seg)
        assert got["mine"].keys() == batch.keys()
        for k in ("tokens", "labels"):
            assert torch.equal(got["mine"][k], batch[k][rs, ss]), k
        if "positions" in batch:                 # M-RoPE's [3, B, S]
            assert torch.equal(got["mine"]["positions"],
                               batch["positions"][:, rs, ss])
        _near_plain(case, got["ruled"])


@pytest.mark.parametrize("case,shape", SPLIT, ids=IDS)
def test_the_prefill_and_decode_match_the_plain_ones(group, case, shape):
    """The last-token logits, every rank's decode state in ``mesh_plan``'s
    placement, and the greedy tokens of the prefill and GEN steps."""
    _, _, logits, tokens = _plain(case)
    for r in group[1]:
        got = r[(case, shape)]
        _near_logits(got["logits"], logits)
        for path, (g, w) in got["state"].items():
            assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape,
                                                               w.shape)
            # the caches are bf16: one rounding of each value besides
            tol = (STATE_RTOL * float(w.float().abs().max())
                   + torch.finfo(w.dtype).eps * w.float().abs()
                   if w.is_floating_point() else 0)
            err = (g.float() - w.float()).abs()
            assert bool((err <= tol).all()), (path, float(err.max()))
        assert torch.equal(got["tokens"], tokens)


@pytest.mark.parametrize("case", WHOLE, ids=[c[0] for c in WHOLE])
def test_whole_sequence_cases_keep_the_step(group, case):
    name, _, _, s = case
    for r in group[1]:
        got = r[name]
        assert got["sp"] is None and got["same"], name
        _near_plain(name, got["ruled"], s)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_the_references_jitted_steps(group, arch):
    ref, ranks = group
    want_loss = float(ref[f"{arch}/loss"])
    want = torch.from_numpy(ref[f"{arch}/logits"])
    for r in ranks:
        got = r[("reference", arch)]
        assert abs(got["loss"] - want_loss) <= LOSS_RTOL * want_loss
        _near_logits(got["logits"], want)


CELLS = (("qwen2-1.5b", "prefill_32k"), ("rwkv6-3b", "prefill_32k"),
         ("qwen3-moe-30b-a3b", "train_4k"), ("deepseek-v3-671b",
                                             "prefill_32k"))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_dry_run_counts_the_last_segment(arch, shape):
    """``--seq-shard`` splits each sequence over the 16 ranks of
    ``model``: the last segment's first rank is rank 15 of both meshes
    (coordinates (0, 15) and (0, 0, 15)); without the flag, and for the
    decode cells, rank 0."""
    from repro_torch.launch.dryrun import cell, counted_rank
    for mesh in ("single", "multi"):
        for flag, want in ((True, 15), (False, 0)):
            cfg, sh, _, rules = cell(arch, shape, mesh, seq_shard=flag)
            assert counted_rank(cfg, sh, rules) == want, (mesh, flag)
        cfg, sh, _, rules = cell(arch, "decode_32k", mesh, seq_shard=True)
        assert counted_rank(cfg, sh, rules) == 0, mesh
