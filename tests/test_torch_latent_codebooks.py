"""The last splits of the default ``tp_ep`` rules
(``distributed/tensor_parallel.py``, ``models/layers.py``,
``models/model.py``) at four ranks on the CPU: MLA's latent cache held
on its capacity rows over ``model`` (``Plan.cap``, the absorbed decode's
partial softmaxes merged in the latent space), and the codebook heads
vocabulary-parallel and the codebook embeddings codebook-parallel
(``Plan.vocab``, ``Plan.books``). ONE spawned gloo group of four ``python
-c`` workers on a ``FileStore`` runs every four-rank check of this
module on the meshes (1, 4) and (2, 2) (data x model) of the same group,
beside one subprocess that runs the reference's jitted serve step on a
forced 4-device (1, 4) CPU mesh and one one-rank group (a (1, 1) mesh);
each test reads its part of the results.

* Reduced deepseek-v3-671b under ``decode_32k``'s rules (``tp_ep``) on
  (1, 4) and (2, 2): the greedy tokens of a ruled prefill and GEN decode
  steps (the cache grown by ``launch.serve._grow_cache`` under the
  rules) equal the plain one-process decode's, and each rank's
  ``latent`` / ``krope`` is [L, B / data, ceil(C / model), .]; on (1, 4)
  also a prompt of UNEVEN_PROMPT tokens (neither the prompt's nor the
  grown capacity divides 4), and 6 heads, which 4 ranks do not divide:
  every rank then scores every head against its rows and still merges.
* The reference's jitted serve step of reduced deepseek-v3-671b on
  (1, 4), its state placed by its own ``_state_sharding`` (the latent
  rank over ``model``, asserted), from its float32 parameters carried
  across with ``params_from_numpy``: the port's four-rank decode of the
  same parameters gives the same greedy tokens.
* Reduced musicgen-medium (K = 2 codebooks, V = 64) under ``tp_ep``
  rules on (2, 2), where the codebook split (K over 2) and the
  vocabulary split both apply, and on (1, 4), where only the vocabulary
  split does: the float32 train step's loss within ``LOSS_F32_RTOL`` and
  every gradient within ``GRAD_RTOL`` of the plain step, the last-token
  prefill logits within ``LOGITS_RTOL`` of their largest magnitude, the
  greedy [B, K] tokens of GEN decode steps equal, and each rank's
  ``lm_heads`` block as the layer uses it equal to its vocabulary
  columns of the global leaf (never gathered over ``model``), its
  ``embed_codebooks`` block its codebooks.
* A one-rank (1, 1) mesh: the ruled musicgen-medium train step, prefill
  and decode equal the plain ones bit for bit, and a deepseek-v3 decode's
  plan splits nothing.
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
                                        LOSS_F32_RTOL, _plain_tokens)

ROOT = Path(__file__).resolve().parents[1]
B, S, PROMPT, GEN = 4, 16, 8, 4
UNEVEN_PROMPT = 7         # 7 and 7 + GEN rows: neither divides 4 ranks
ODD_HEADS = 6             # MLA heads that 4 ranks do not divide
MESHES = ((1, 4), (2, 2))
THREADS = "2"             # each process's CPU threads

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import SHAPES, get_reduced
from repro.distributed.sharding import MeshRules, param_shardings
from repro.launch.serve import _grow_cache
from repro.launch.specs import _state_sharding
from repro.launch.strategy import pick_strategy
from repro.models import model as JM
from repro.train.steps import make_prefill_step, make_serve_step
out, B, PROMPT, GEN = sys.argv[1], *(int(a) for a in sys.argv[2:5])
cfg = get_reduced("deepseek-v3-671b")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
strat = pick_strategy(cfg, SHAPES["decode_32k"])
assert strat.name == "tp_ep", strat.name
rules = MeshRules(mesh, strat.logical_rules)
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
st = jax.device_put(st, placed)
serve = jax.jit(make_serve_step(cfg, rules), donate_argnums=(2,))
nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
seq = [nxt]
for _ in range(GEN):
    nxt, st = serve(params, nxt[:, None], st)
    seq.append(nxt)
flat = {}


def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(t)


walk(q0, ("q0",))
specs = {k: np.array([str(a) for a in placed["main"][k].spec])
         for k in ("latent", "krope")}
np.savez(out + ".tmp.npz", prompt=prompt,
         tokens=np.stack([np.asarray(t) for t in seq], 1),
         latent_spec=specs["latent"], krope_spec=specs["krope"], **flat)
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
MESHES = [tuple(m) for m in args["meshes"]]
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
res = {}


def rules_of(cfg, shape):
    # decode_32k's rules: tp_ep for every arch (the train step of a
    # dense or audio arch would default to fsdp)
    strat = pick_strategy(cfg, SHAPES["decode_32k"])
    assert strat.name == "tp_ep", strat
    return MeshRules(mesh_over(shape, ("data", "model")), strat.logical_rules)


def init(cfg, dtype=None):
    p = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return p if dtype is None else tree_map(lambda t: t.to(dtype), p)


def prompt_of(cfg, n):
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return torch.randint(0, cfg.vocab_size, (B, n, *k),
                         generator=torch.Generator().manual_seed(5))


def decode(cfg, params, toks, rules):
    with torch.no_grad():
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


def plan_of(cfg, rules):
    with mesh_rules(rules), batch_split(None):
        plan = TP.plan_for(cfg)
    return {"tp": None if plan.tp is None else (plan.tp.size, plan.tp.index),
            "cap": plan.cap, "heads": plan.heads, "vocab": plan.vocab,
            "books": plan.books}


# MLA's latent cache on its capacity rows: reduced deepseek-v3
ds = get_reduced("deepseek-v3-671b")
odd = dataclasses.replace(ds, n_heads=args["odd_heads"])
for shape in MESHES:
    rules = rules_of(ds, shape)
    res[("mla", shape)] = (plan_of(ds, rules),
                           *decode(ds, init(ds), prompt_of(ds, PROMPT),
                                   rules))
rules = rules_of(ds, (1, 4))
res["mla_uneven"] = decode(ds, init(ds), prompt_of(ds, args["uneven"]),
                           rules)
res["mla_odd_heads"] = (plan_of(odd, rules),
                        *decode(odd, init(odd),
                                prompt_of(odd, args["uneven"]), rules))

# the codebook heads: reduced musicgen-medium
mg = get_reduced("musicgen-medium")
hp = TrainHParams(loss_chunk=8)
p32 = init(mg, torch.float32)
batch = synthetic_batch(mg, B, S, 0)
for shape in MESHES:
    rules = rules_of(mg, shape)
    r = res[("codebooks", shape)] = {"plan": plan_of(mg, rules)}
    loss, _, grads = ruled_loss_and_grads(place_params(p32, rules), mg,
                                          batch, hp, rules)
    r["loss"], r["grads"] = float(loss), gather_tree(grads)
    r["logits"] = make_prefill_step(mg, rules)(
        p32, {"tokens": batch["tokens"]})[0]
    with mesh_rules(rules), batch_split(batch_shard(batch, rules)[1]):
        held = TP.hold(place_params(p32, rules), mg)
        r["lm_heads"] = TP.use(held["lm_heads"]).clone()
        r["embed_codebooks"] = TP.use(held["embed_codebooks"]).clone()
    r["tokens"] = decode(mg, init(mg), prompt_of(mg, PROMPT), rules)[0]

# the reference's jitted serve step's parameters, decoded on (1, 4)
while not os.path.exists(ref):
    time.sleep(0.2)
z = np.load(ref)
tree = {}
for k in z.files:
    if k.startswith("q0/"):
        *path, leaf = k.split("/")[1:]
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
res["reference_decode"] = decode(
    ds, M.params_from_numpy(tree, ds, "cpu"),
    torch.from_numpy(z["prompt"]), rules_of(ds, (1, 4)))
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""

ONE_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshRules, batch_split,
                                              flat_tree, gather_tree,
                                              mesh_rules)
from repro_torch.launch.mesh import init_distributed
from repro_torch.launch.serve import _grow_cache
from repro_torch.launch.strategy import pick_strategy
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, greedy, init_opt_state,
                                     make_prefill_step, make_serve_step,
                                     make_train_step)
init_distributed("cpu", store=dist.HashStore(), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
res = {}
cfg = get_reduced("deepseek-v3-671b")
rules = MeshRules(mesh, pick_strategy(cfg, SHAPES["decode_32k"])
                  .logical_rules)
with mesh_rules(rules), batch_split(None):
    plan = TP.plan_for(cfg)
res["mla_plan"] = (plan.tp, plan.cap, plan.heads, plan.vocab, plan.books)
cfg = get_reduced("musicgen-medium")
hp = TrainHParams(loss_chunk=8)
toks = torch.randint(0, cfg.vocab_size, (2, 8, cfg.n_codebooks),
                     generator=torch.Generator().manual_seed(5))
for name in ("ruled", "plain"):
    r = None if name == "plain" else MeshRules(
        mesh, pick_strategy(cfg, SHAPES["decode_32k"]).logical_rules)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params, hp)
    params, opt, met = make_train_step(cfg, r, hp)(
        params, opt, synthetic_batch(cfg, 4, 16, 0))
    with torch.no_grad():
        logits, st = make_prefill_step(cfg, r)(params, {"tokens": toks})
        st = _grow_cache(cfg, st, 2, 8 + 2, "cpu", r)
        nxt, seq = greedy(logits), []
        step = make_serve_step(cfg, r)
        for _ in range(2):
            nxt, st = step(params, nxt[:, None], st)
            seq.append(nxt)
    res[name] = (float(met["loss"]), flat_tree(gather_tree(params)), logits,
                 seq, flat_tree(st))
torch.save(res, sys.argv[1])
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
    """The reference's serve step and the one-rank group, each in a
    subprocess, beside the four-rank worker (which waits for the
    reference's npz only at the end); (the reference's npz, the one-rank
    results, [rank r's results])."""
    d = tmp_path_factory.mktemp("latent")
    ref, one = d / "reference.npz", d / "one_rank.pt"
    jax_side = _popen(REFERENCE, ref, B, PROMPT, GEN)
    one_rank = _popen(ONE_RANK, one)
    args = json.dumps({"b": B, "s": S, "prompt": PROMPT, "gen": GEN,
                       "uneven": UNEVEN_PROMPT, "odd_heads": ODD_HEADS,
                       "meshes": MESHES})
    procs = [_popen(WORKER, r, 4, d / "store", d / "out", ref, args)
             for r in range(4)]
    _, err = jax_side.communicate(timeout=600)
    if jax_side.returncode != 0:
        for p in procs:
            p.kill()
        pytest.fail(err[-4000:])
    for p in [one_rank] + procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    return (dict(np.load(ref)), torch.load(one, weights_only=False),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


def _cfg(arch, **kw):
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), **kw)


def _cache_shapes(cfg, shape, capacity) -> dict:
    """Each rank's ``latent`` / ``krope`` of every transformer part: [L,
    B / data, ceil(C / model), r or dr]."""
    data, tp = shape
    rows = -(-capacity // tp)
    parts = {"dense": cfg.moe.n_dense_layers,
             "main": cfg.n_layers - cfg.moe.n_dense_layers}
    return {f"{part}/{k}": (n, B // data, rows, w) for part, n in
            parts.items() for k, w in (("latent", cfg.mla.kv_lora_rank),
                                       ("krope", cfg.mla.qk_rope_head_dim))}


@pytest.mark.parametrize("shape", MESHES, ids=map(str, MESHES))
def test_latent_cache_split_decode_gives_the_plain_tokens(group, shape):
    """Every rank holds its capacity rows of the latent cache and RoPE
    key (and its heads where 4 heads divide the model axis); the greedy
    tokens of a prefill and GEN decode steps equal the plain decode's."""
    cfg = _cfg("deepseek-v3-671b")
    want = _plain_tokens(None, cfg, PROMPT)[0]
    data, tp = shape
    for rank, r in enumerate(group[2]):
        plan, tokens, shapes = r[("mla", shape)]
        assert plan == {"tp": (tp, rank % tp), "cap": True, "heads": True,
                        "vocab": True, "books": False}
        assert torch.equal(tokens, want)
        assert shapes == _cache_shapes(cfg, shape, PROMPT + GEN), shapes


def test_uneven_capacity_is_regathered_and_padded(group):
    """An UNEVEN_PROMPT-token prompt on (1, 4): the prefill's 7 rows and
    the grown 11 hold ceil(C / 4) rows a rank, the last zero-padded, and
    ``_grow_cache`` regathers the prefill's rows before cutting the new
    capacity: the plain tokens."""
    cfg = _cfg("deepseek-v3-671b")
    want = _plain_tokens(None, cfg, UNEVEN_PROMPT)[0]
    for r in group[2]:
        tokens, shapes = r["mla_uneven"]
        assert torch.equal(tokens, want)
        assert shapes == _cache_shapes(cfg, (1, 4), UNEVEN_PROMPT + GEN)


def test_heads_that_do_not_divide_still_merge(group):
    """ODD_HEADS MLA heads on 4 ranks: ``Plan.heads`` false, ``Plan.cap``
    true; every rank runs every head whole against its rows and the
    partial softmaxes merge: the plain tokens."""
    cfg = _cfg("deepseek-v3-671b", n_heads=ODD_HEADS)
    want = _plain_tokens(None, cfg, UNEVEN_PROMPT)[0]
    for rank, r in enumerate(group[2]):
        plan, tokens, shapes = r["mla_odd_heads"]
        assert plan == {"tp": (4, rank), "cap": True, "heads": False,
                        "vocab": True, "books": False}
        assert torch.equal(tokens, want)
        assert shapes == _cache_shapes(cfg, (1, 4), UNEVEN_PROMPT + GEN)


def test_the_references_latent_split_serve_step(group):
    """The reference's jitted serve step on (1, 4) holds the latent rank
    and the RoPE dim over ``model`` (its ``_state_sharding``); the port's
    four-rank decode of the same float32 parameters, on capacity rows,
    gives its greedy tokens."""
    ref, _, ranks = group
    for k in ("latent_spec", "krope_spec"):
        assert list(ref[k]) == ["None", "data", "None", "model"], ref[k]
    cfg = _cfg("deepseek-v3-671b")
    want = torch.from_numpy(ref["tokens"])
    for r in ranks:
        tokens, shapes = r["reference_decode"]
        assert torch.equal(tokens, want.to(tokens.dtype))
        assert shapes == _cache_shapes(cfg, (1, 4), PROMPT + GEN)


_PLAIN: dict = {}


def _plain_codebooks():
    """The plain one-process musicgen-medium: the float32 step's (loss,
    {path: gradient}), its prefill's last-token logits, the bf16 greedy
    [B, GEN + 1, K] tokens, and the float32 parameters."""
    if not _PLAIN:
        from repro_torch.distributed.sharding import tree_map
        from repro_torch.launch.serve import _grow_cache
        from repro_torch.launch.train import synthetic_batch
        from repro_torch.models import model as M
        from repro_torch.train.steps import (TrainHParams, greedy,
                                             loss_and_grads,
                                             make_prefill_step,
                                             make_serve_step)
        cfg = _cfg("musicgen-medium")
        params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        p32 = tree_map(lambda t: t.float(), params)
        batch = synthetic_batch(cfg, B, S, 0)
        loss, _, grads = loss_and_grads(p32, cfg, batch,
                                        TrainHParams(loss_chunk=8))
        logits = make_prefill_step(cfg)(p32, {"tokens": batch["tokens"]})[0]
        toks = torch.randint(0, cfg.vocab_size, (B, PROMPT, cfg.n_codebooks),
                             generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            first, st = make_prefill_step(cfg)(params, {"tokens": toks})
            st = _grow_cache(cfg, st, B, PROMPT + GEN, "cpu")
            nxt = greedy(first)
            seq, serve = [nxt], make_serve_step(cfg)
            for _ in range(GEN):
                nxt, st = serve(params, nxt[:, None], st)
                seq.append(nxt)
        _PLAIN.update(loss=float(loss), grads=dict(_leaves(grads)),
                      logits=logits, tokens=torch.stack(seq, 1), params=p32)
    return _PLAIN


@pytest.mark.parametrize("shape", MESHES, ids=map(str, MESHES))
def test_codebook_steps_match_the_plain_step(group, shape):
    """The loss, every gradient (the codebook tables' and heads'
    included), the prefill's logits and the greedy [B, K] tokens."""
    want = _plain_codebooks()
    for r in group[2]:
        got = r[("codebooks", shape)]
        loss = got["loss"]
        assert abs(loss - want["loss"]) <= LOSS_F32_RTOL * want["loss"]
        grads = dict(_leaves(got["grads"]))
        assert grads.keys() == want["grads"].keys()
        assert {"/lm_heads", "/embed_codebooks"} <= grads.keys()
        for k, w in want["grads"].items():
            err = float((grads[k] - w).norm() / w.norm())
            assert err <= GRAD_RTOL, (k, err)
        err = float((got["logits"] - want["logits"]).abs().max())
        assert err <= LOGITS_RTOL * float(want["logits"].abs().max()), err
        assert got["tokens"].shape == (B, GEN + 1, 2)
        assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("shape", MESHES, ids=map(str, MESHES))
def test_each_rank_keeps_its_codebook_blocks(group, shape):
    """``lm_heads`` [K, D, V] as the layer uses it is the rank's V / model
    columns (not gathered over ``model``); ``embed_codebooks`` [K, V, D]
    its K / model codebooks where ``model`` divides K (2 on (2, 2)), else
    all of them."""
    full = _plain_codebooks()["params"]
    data, tp = shape
    k_split = 2 % tp == 0
    for rank, r in enumerate(group[2]):
        got = r[("codebooks", shape)]
        m = rank % tp
        assert got["plan"] == {"tp": (tp, m), "cap": False, "heads": False,
                               "vocab": True, "books": k_split}
        v = full["lm_heads"].shape[-1] // tp
        assert torch.equal(got["lm_heads"],
                           full["lm_heads"][..., m * v:(m + 1) * v])
        k = 2 // tp if k_split else 2
        first = m * k if k_split else 0
        assert torch.equal(got["embed_codebooks"],
                           full["embed_codebooks"][first:first + k])


def test_one_rank_is_the_plain_step(group):
    """On a (1, 1) mesh nothing splits: musicgen-medium's ruled train
    step, prefill and two decode steps equal the plain ones bit for bit
    (the loss, every parameter, the logits, the tokens and the state),
    and deepseek-v3's decode plan has no group."""
    one = group[1]
    assert one["mla_plan"] == (None, False, False, False, False)
    ruled, plain = one["ruled"], one["plain"]
    assert ruled[0] == plain[0]
    for i in (1, 4):
        assert ruled[i].keys() == plain[i].keys()
        for k in plain[i]:
            assert torch.equal(ruled[i][k], plain[i][k]), (i, k)
    assert torch.equal(ruled[2], plain[2])
    assert all(torch.equal(a, b) for a, b in zip(ruled[3], plain[3]))
