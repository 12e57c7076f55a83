"""The ruled train step's sequence split (``Plan.seq``: the multi-pod
``fsdp`` rules put ``seq`` on ``pod``) at four ranks on the CPU: ONE
spawned gloo group of four ``python -c`` workers on a ``FileStore`` runs
every multi-rank check of this module on the meshes (2, 2, 1), (2, 1, 2)
and (4, 1, 1) (pod x data x model) of the same group, after one
subprocess that runs the reference's jitted multi-pod step; each test
reads its part of the results. The rules are ``_rules("fsdp", True)``:
the batch over ``("data", "model")``, parameters over every axis, each
sequence over ``pod`` in contiguous segments (four on (4, 1, 1), which
chains the carried states over four segments).

* float32 parameters of reduced qwen2-1.5b (GQA), qwen2-vl-7b (M-RoPE's
  [3, B, S] positions), musicgen-medium ([B, S, K] codebook tokens and
  labels, sinusoidal positions), rwkv6-3b (the token shifts and the WKV
  carry), zamba2-7b (the conv window, the SSD carry and the shared
  attention block), qwen3-moe-30b-a3b (the MoE) and deepseek-v3-671b
  (MLA, a leading dense layer, a shared expert), against the
  one-process plain step from the same seed and batch: the loss within
  ``LOSS_F32_RTOL``, every gradient leaf within a relative norm of
  ``GRAD_RTOL`` (``tests/test_torch_tensor_parallel.py``'s constants);
  each rank's ``Plan.seq`` (size and index) and its tokens, labels and
  positions, which must be its batch rows of its segment. The MoE archs
  route at capacity factor ``CAPACITY``, so that tokens are dropped:
  every routing call's T_g, capacity and drops, and the aux, must be
  the plain step's. At S = 16 a routing group spans the segments (form
  (b): every rank routes more than its segment); at B = 2, S = 4096 on
  (2, 2, 1) each 2048-token segment is one group (form (a): each rank
  routes its own segment);
* the whole-sequence cases, each with ``Plan.seq`` None and its step
  equal bit for bit to the same rules' step with ``"seq": None`` (the
  step as it was before the split), and within the tolerances of the
  plain step: a one-rank ``pod`` axis (1, 2, 2), a sequence that does
  not divide over ``pod`` (S = 15), and zamba2-7b's segments shorter
  than its conv window (S = 4 over 4);
  ``seq`` on the tensor axis (``tp_ep``'s multi-pod rules with ``seq``
  on ``model``, the dry run's ``--seq-shard``) keeps ``Plan.seq`` None
  too, and is split by ``Plan.sp`` instead (``model``'s group; the
  split's own checks are ``tests/test_torch_seq_on_tensor.py``'s),
  within the plain step's tolerances;
* the reference's jitted ``make_train_step(cfg, rules, hp)`` of reduced
  qwen2-1.5b, rwkv6-3b, qwen3-moe-30b-a3b and deepseek-v3-671b under
  its own multi-pod ``fsdp`` rules on a forced 4-device CPU mesh (2, 2,
  1) (one subprocess, ``XLA_FLAGS``),
  its float32 parameters carried across with ``params_from_numpy``: the
  port's four-rank step's loss within ``LOSS_RTOL`` of the reference's
  and its updated parameters within the reference-step rule of
  ``tests/test_torch_lm_train.py`` (every element within 2 lr, at most
  ``STEP_OUTLIERS`` of them outside ``STEP_TOL``).

One process, no group: the chunked WKV-6 and SSD forms run from a
non-zero state equal the zero-state pass plus the carried state's
contribution (``wkv6_entering``, ``ssd_entering``), and a sequence cut
into 2 or 4 segments, each run from zero and folded
(``tensor_parallel.fold_carries``), equals the whole sequence's chunked
pass, within ``CARRY_RTOL``; ``seq_dim`` splits the MoE and MLA configs
over ``pod`` under the multi-pod ``fsdp`` rules and not under their
default ``tp_ep`` ones; and the dry run counts the first rank of the
last segment (rank 256 of 512) in exactly the multi-pod ``train_4k``
cells whose sequences split.
"""
import dataclasses
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
from test_torch_tensor_parallel import (GRAD_RTOL, LOSS_F32_RTOL, STEP_OUTLIERS,
                                        STEP_TOL)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
ARCHS = ("qwen2-1.5b", "qwen2-vl-7b", "musicgen-medium", "rwkv6-3b",
         "zamba2-7b") + MOE_ARCHS
MESHES = ((2, 2, 1), (2, 1, 2), (4, 1, 1))
REFERENCE_ARCHS = ("qwen2-1.5b", "rwkv6-3b") + MOE_ARCHS
# the MoE archs route at this capacity factor here (the reduced configs'
# 4.0 drops nothing): tokens are dropped, so the routing groups, the
# capacity and the drops are held to the plain step's
CAPACITY = 1.0
# MoE form (a): B = 2, S = 4096 on (2, 2, 1), one row a rank, 2048-token
# segments, each the default 2048-token routing group; (arch, mesh)
FORM_A_B, FORM_A_S, FORM_A_CHUNK = 2, 4096, 512
FORM_A = tuple((a, (2, 2, 1)) for a in MOE_ARCHS)
# (name, arch, mesh, S, profile, seq rule): each must leave Plan.seq None
WHOLE = (("one-rank-pod", "qwen2-1.5b", (1, 2, 2), S, "fsdp", "pod"),
         ("indivisible", "qwen2-1.5b", (2, 2, 1), 15, "fsdp", "pod"),
         ("seq-on-tensor", "qwen2-1.5b", (2, 1, 2), S, "tp_ep", "model"),
         ("short-conv-segment", "zamba2-7b", (4, 1, 1), 4, "fsdp", "pod"))
# the carry formula against the chunked forms' own carried state, float32
# (another summation order: the segment's decays summed whole)
CARRY_RTOL = 1e-5

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
# jax.make_mesh's explicit axes make the reference's embedding gather
# raise under jax 0.9; a Mesh of the forced host devices does not
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2, 1),
                         ("pod", "data", "model"))
flat = {}


def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + (k,))
    else:
        flat["/".join(path)] = np.asarray(t)


for arch in sys.argv[4].split(","):
    cfg = get_reduced(arch)
    strat = pick_strategy(cfg, SHAPES["train_4k"], multi_pod=True,
                          override_profile="fsdp")
    assert strat.name == "fsdp" and strat.logical_rules["seq"] == "pod"
    rules = MeshRules(mesh, strat.logical_rules)
    hp = TrainHParams(loss_chunk=8)
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      JM.init_model(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    params = jax.device_put(jax.tree.map(jnp.asarray, p0),
                            param_shardings(p0, rules))
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    p1, _, met = jax.jit(make_train_step(cfg, rules, hp))(
        params, init_opt_state(params, hp), batch)
    flat[f"{arch}/tokens"] = tokens
    flat[f"{arch}/loss"] = np.float32(met["loss"])
    walk(p0, (arch, "p0"))
    walk(jax.device_get(p1), (arch, "p1"))
np.savez(out, **flat)
"""

WORKER = r"""
import json
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import dataclasses
import torch.distributed as dist
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshRules, batch_split,
                                              gather_tree, mesh_rules,
                                              tree_map)
from repro_torch.launch.mesh import init_distributed, mesh_over
from repro_torch.launch.strategy import _rules, pick_strategy
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train.steps import (TrainHParams, batch_shard,
                                     init_opt_state, make_train_step,
                                     place_params, ruled_loss_and_grads)

rank, world, store, out, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
B, S = int(sys.argv[6]), int(sys.argv[7])
ARCHS, MESHES, WHOLE, REFERENCE_ARCHS, CAPACITY = (json.loads(a)
                                                   for a in sys.argv[8:13])
FORM_A, FORM_A_B, FORM_A_S, FORM_A_CHUNK = json.loads(sys.argv[13])
init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world)
AXES = ("pod", "data", "model")
hp = TrainHParams(loss_chunk=8)
res = {}
ROUTES = []
_plan = MOE._plan


def recording(p, xt, cfg, split=None):
    # each MoE routing call's (tokens routed, T_g, capacity, drops)
    out = _plan(p, xt, cfg, split)
    ROUTES.append((xt.shape[0] * xt.shape[1], xt.shape[1], out[4],
                   int((~out[3]).sum())))
    return out


MOE._plan = recording


def config(arch):
    cfg = get_reduced(arch)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY))


def f32(cfg):
    return tree_map(lambda t: t.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))


def ruled(cfg, rules, batch, hp=hp):
    ROUTES.clear()
    loss, met, grads = ruled_loss_and_grads(place_params(f32(cfg), rules),
                                            cfg, batch, hp, rules)
    return float(loss), gather_tree(grads), float(met["aux"]), list(ROUTES)


def seq_plan(cfg, rules, batch):
    mine, split = batch_shard(batch, rules, cfg)
    with mesh_rules(rules), batch_split(split):
        seq = TP.plan_for(cfg).seq
    return mine, None if seq is None else (seq.dim, seq.size, seq.index)


for arch in ARCHS:
    cfg = config(arch)
    batch = synthetic_batch(cfg, B, S, 0)
    for shape in MESHES:
        rules = MeshRules(mesh_over(tuple(shape), AXES), _rules("fsdp", True))
        mine, seq = seq_plan(cfg, rules, batch)
        res[(arch, tuple(shape))] = {"seq": seq, "mine": mine,
                                     "ruled": ruled(cfg, rules, batch)}

# the MoE's form (a): each routing group within one segment
for arch, shape in FORM_A:
    cfg = config(arch)
    batch = synthetic_batch(cfg, FORM_A_B, FORM_A_S, 0)
    rules = MeshRules(mesh_over(tuple(shape), AXES), _rules("fsdp", True))
    res[("form-a", arch)] = {"seq": seq_plan(cfg, rules, batch)[1],
                             "ruled": ruled(cfg, rules, batch, TrainHParams(
                                 loss_chunk=FORM_A_CHUNK))}

# the whole-sequence cases: Plan.seq None, and the step of the same rules
# with "seq": None bit for bit; seq on the tensor axis is Plan.sp's split
# instead (tests/test_torch_seq_on_tensor.py)
for name, arch, shape, s, profile, seq_rule in WHOLE:
    cfg = get_reduced(arch)
    batch = synthetic_batch(cfg, B, s, 0)
    mesh = mesh_over(tuple(shape), AXES)
    logical = dict(_rules(profile, True), seq=seq_rule)
    rules = MeshRules(mesh, logical)
    got = ruled(cfg, rules, batch)
    want = ruled(cfg, MeshRules(mesh, dict(logical, seq=None)), batch)
    same = got[0] == want[0] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            sorted(TP.flat_tree(got[1]).items()),
            sorted(TP.flat_tree(want[1]).items())))
    split = batch_shard(batch, rules, cfg)[1]
    with mesh_rules(rules), batch_split(split):
        sp = TP.plan_for(cfg).sp
    if seq_rule == "model":
        same = sp is not None and sp.dim == "model"
    res[name] = {"seq": seq_plan(cfg, rules, batch)[1], "same": same,
                 "ruled": got}

# the reference's multi-pod step on (2, 2, 1): its parameters, one step
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


for arch in REFERENCE_ARCHS:
    cfg = get_reduced(arch)
    params = M.params_from_numpy(tree_of(f"{arch}/p0"), cfg, "cpu")
    tokens = torch.from_numpy(z[f"{arch}/tokens"])
    strat = pick_strategy(cfg, SHAPES["train_4k"], multi_pod=True,
                          override_profile="fsdp")
    rules = MeshRules(mesh_over((2, 2, 1), AXES), strat.logical_rules)
    step = make_train_step(cfg, rules, hp)
    p1, _, met = step(params, init_opt_state(params, hp),
                      {"tokens": tokens, "labels": tokens})
    res[("reference", arch)] = {"loss": float(met["loss"]),
                                "params": gather_tree(p1)}
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
    """The reference's steps in one subprocess, then the four-rank worker
    once; (the reference's npz, [rank r's results])."""
    d = tmp_path_factory.mktemp("sp")
    ref = d / "reference.npz"
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(ref), str(B),
                          str(S), ",".join(REFERENCE_ARCHS)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d / "out"), str(ref), str(B), str(S), json.dumps(ARCHS),
         json.dumps(MESHES), json.dumps(WHOLE), json.dumps(REFERENCE_ARCHS),
         json.dumps(CAPACITY),
         json.dumps([FORM_A, FORM_A_B, FORM_A_S, FORM_A_CHUNK])],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, e[-4000:]
    return (dict(np.load(ref)),
            [torch.load(d / f"out.{r}", weights_only=False)
             for r in range(4)])


def _config(arch):
    """The reduced config, an MoE's at capacity factor ``CAPACITY``."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY))


@functools.lru_cache(maxsize=None)
def _plain(arch, b=B, s=S, chunk=8):
    """The one-process plain step's float32 loss, gradients and aux, and
    each of the MoE's routing calls (tokens routed, T_g, capacity,
    entries dropped), forward and recompute."""
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.train.steps import TrainHParams, loss_and_grads
    cfg = _config(arch)
    params = tree_map(lambda t: t.float(), M.init_model(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    routes, real = [], MOE._plan

    def recording(p, xt, cfg, split=None):
        out = real(p, xt, cfg, split)
        routes.append((xt.shape[0] * xt.shape[1], xt.shape[1], out[4],
                       int((~out[3]).sum())))
        return out
    MOE._plan = recording
    try:
        loss, met, grads = loss_and_grads(params, cfg,
                                          synthetic_batch(cfg, b, s, 0),
                                          TrainHParams(loss_chunk=chunk))
    finally:
        MOE._plan = real
    return float(loss), dict(_leaves(grads)), float(met["aux"]), routes


def _near_plain(arch, got, b=B, s=S, chunk=8) -> None:
    want_loss, want = _plain(arch, b, s, chunk)[:2]
    loss, grads = got[:2]
    assert abs(loss - want_loss) <= LOSS_F32_RTOL * want_loss, (loss,
                                                                want_loss)
    grads = dict(_leaves(grads))
    assert grads.keys() == want.keys()
    for k, w in want.items():
        err = float((grads[k] - w).norm() / w.norm())
        assert err <= GRAD_RTOL, (k, err)


def _same_routes(arch, gots, b=B, s=S, chunk=8) -> set:
    """Every rank's MoE routing (``gots``: each rank's ruled results)
    against the plain step's, call by call: the same T_g and capacity,
    and the plain step's drops once for each time the batch's groups
    were routed over the ranks (a group every rank of a pod routes
    counts on each); the aux the plain step's on every rank, within
    ``LOSS_F32_RTOL``. Returns the tokens each rank routed per call."""
    want_aux, want = _plain(arch, b, s, chunk)[2:]
    assert sum(d for *_, d in want), "the plain step dropped no token"
    for got in gots:
        assert abs(got[2] - want_aux) <= LOSS_F32_RTOL * want_aux, (
            got[2], want_aux)
        assert len(got[3]) == len(want)
    routed = set()
    for i, (t, tg, cap, dropped) in enumerate(want):
        calls = [got[3][i] for got in gots]
        assert all(c[1:3] == (tg, cap) for c in calls), (calls, tg, cap)
        total = sum(c[0] for c in calls)
        assert total % t == 0
        assert sum(c[3] for c in calls) == total // t * dropped, (
            i, calls, dropped)
        routed |= {c[0] for c in calls}
    return routed


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_sequence_split_matches_the_plain_step(group, arch, shape):
    """And each rank's ``Plan.seq`` is ``pod`` at its coordinate, and its
    tokens, labels and positions are its batch rows of its segment."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import synthetic_batch
    cfg = get_reduced(arch)
    batch = synthetic_batch(cfg, B, S, 0)
    pods, data, model = shape
    rows, seg = B // (data * model), S // pods
    for rank, r in enumerate(group[1]):
        got = r[(arch, shape)]
        pod, shard = rank // (data * model), rank % (data * model)
        assert got["seq"] == ("pod", pods, pod)
        rs, ss = slice(shard * rows, (shard + 1) * rows), \
            slice(pod * seg, (pod + 1) * seg)
        assert got["mine"].keys() == batch.keys()
        for k in ("tokens", "labels"):
            assert torch.equal(got["mine"][k], batch[k][rs, ss]), k
        if "positions" in batch:                 # M-RoPE's [3, B, S]
            assert torch.equal(got["mine"]["positions"],
                               batch["positions"][:, rs, ss])
        _near_plain(arch, got["ruled"])
    if arch in MOE_ARCHS:         # form (b): a group spans the segments
        routed = _same_routes(arch, [r[(arch, shape)]["ruled"]
                                     for r in group[1]])
        assert min(routed) > rows * seg, routed


@pytest.mark.parametrize("arch,shape", FORM_A,
                         ids=[f"{a}-{m}" for a, m in FORM_A])
def test_moe_groups_within_one_segment(group, arch, shape):
    """The MoE's form (a): at B = 2, S = 4096 each rank routes its own
    2048-token segment, one routing group, with no gather; its groups,
    drops and aux are the plain step's, and so are its loss and
    gradients."""
    pods, data, model = shape
    rows, seg = FORM_A_B // (data * model), FORM_A_S // pods
    gots = []
    for rank, r in enumerate(group[1]):
        got = r[("form-a", arch)]
        assert got["seq"] == ("pod", pods, rank // (data * model))
        gots.append(got["ruled"])
    size = (FORM_A_B, FORM_A_S, FORM_A_CHUNK)
    assert _same_routes(arch, gots, *size) == {rows * seg}
    for got in gots:
        _near_plain(arch, got, *size)


@pytest.mark.parametrize("case", WHOLE, ids=[c[0] for c in WHOLE])
def test_whole_sequence_cases_keep_the_step(group, case):
    name, arch, _, s, _, _ = case
    for r in group[1]:
        got = r[name]
        assert got["seq"] is None and got["same"], name
        _near_plain(arch, got["ruled"], s=s)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_the_references_multi_pod_step(group, arch):
    ref, ranks = group
    want_loss = float(ref[f"{arch}/loss"])
    for r in ranks:
        assert abs(r[("reference", arch)]["loss"] - want_loss) \
            <= LOSS_RTOL * want_loss
    got = ranks[0][("reference", arch)]
    n_out = n_all = 0
    for k, a in _leaves(got["params"]):
        w, a = ref[f"{arch}/p1{k}"], a.numpy()
        err = np.abs(a - w)
        assert err.max() <= 2 * 3e-4 * 1.001, k
        n_out += int((err > STEP_TOL["atol"]
                      + STEP_TOL["rtol"] * np.abs(w)).sum())
        n_all += w.size
        assert not np.array_equal(w, ref[f"{arch}/p0{k}"]), k  # it moved
    assert n_out <= STEP_OUTLIERS * n_all, n_out / n_all


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def _wkv6_inputs(gen, b=2, s=48, h=2, n=8):
    r, k, v = (torch.randn(b, s, h, n, generator=gen) for _ in range(3))
    w_log = -torch.exp(torch.randn(b, s, h, n, generator=gen) - 2)
    u = torch.randn(h, n, generator=gen) * 0.1
    return r, k, v, w_log, u


def _ssd_inputs(gen, b=2, s=48, h=3, p=4, n=8):
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a_log = torch.randn(h, generator=gen) * 0.5
    bb, c = (torch.randn(b, s, n, generator=gen) for _ in range(2))
    return x, dt, a_log, bb, c


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
@pytest.mark.parametrize("segments", [2, 4])
def test_the_carry_formula(kind, segments):
    """From a non-zero state S0: one pass over the whole sequence against
    ``segments`` passes from zero, the state entering each folded from
    the segments before it (S0 entering the first, a segment of its own
    with no decay), each segment's output plus ``*_entering`` of that
    state, and the last state plus its decayed entering state. Segments
    of 12 or 24 tokens, chunks of 8: a segment ends mid-chunk."""
    from repro_torch.distributed.tensor_parallel import fold_carries
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv as RW
    gen = torch.Generator().manual_seed(segments)
    if kind == "wkv6":
        r, k, v, w_log, u = _wkv6_inputs(gen)
        s0 = torch.randn(r.shape[0], r.shape[2], r.shape[3], r.shape[3],
                         generator=gen)

        def run(sl, st):
            return RW.wkv6_chunked(r[:, sl], k[:, sl], v[:, sl],
                                   w_log[:, sl], u, st, chunk=8)

        def entering(sl, s_in):
            return RW.wkv6_entering(r[:, sl], w_log[:, sl], s_in)

        def log_decay(sl):
            return w_log[:, sl].sum(1)[..., None]
    else:
        x, dt, a_log, bb, c = _ssd_inputs(gen)
        s0 = torch.randn(x.shape[0], x.shape[2], x.shape[3], c.shape[-1],
                         generator=gen)

        def run(sl, st):
            return M2.ssd_chunked(x[:, sl], dt[:, sl], a_log, bb[:, sl],
                                  c[:, sl], st, chunk=8)

        def entering(sl, s_in):
            return M2.ssd_entering(dt[:, sl], a_log, c[:, sl], s_in)

        def log_decay(sl):
            return (-torch.exp(a_log) * dt[:, sl]).sum(1)[..., None, None]
    whole_y, whole_s = run(slice(None), s0)
    length = whole_y.shape[1] // segments
    cuts = [slice(i * length, (i + 1) * length) for i in range(segments)]
    passes = [run(sl, torch.zeros_like(s0)) for sl in cuts]
    parts = torch.stack([torch.stack([s0, torch.zeros_like(s0)])] + [
        torch.stack([st, log_decay(sl).expand_as(st)])
        for sl, (_, st) in zip(cuts, passes)])
    s_in = fold_carries(parts)[1:]
    y = torch.cat([yl + entering(sl, si) for sl, (yl, _), si in
                   zip(cuts, passes, s_in)], dim=1)
    last = passes[-1][1] + torch.exp(log_decay(cuts[-1])) * s_in[-1]
    assert _rel(y, whole_y) <= CARRY_RTOL
    assert _rel(last, whole_s) <= CARRY_RTOL


TRAIN_ARCHS = ("stablelm-12b", "glm4-9b", "chatglm3-6b", "qwen2-1.5b",
               "musicgen-medium", "rwkv6-3b", "zamba2-7b", "qwen2-vl-7b",
               "qwen3-moe-30b-a3b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_the_dry_run_counts_the_last_segment(arch):
    """The multi-pod ``train_4k`` cell of every non-MoE arch splits its
    sequences over ``pod`` (4096 tokens, 2048 a segment) and counts rank
    256 of 512, and so do the MoE archs' under ``--profile fsdp``; under
    their default ``tp_ep`` rules (``seq`` None), and in every
    single-mesh cell, the sequences stay whole and rank 0 counts."""
    from repro_torch.launch.dryrun import cell, counted_rank
    moe = arch in MOE_ARCHS
    cells = [("multi", None, 0 if moe else 256), ("single", None, 0)]
    if moe:
        cells.append(("multi", "fsdp", 256))
    for mesh, profile, want in cells:
        cfg, shape, _, rules = cell(arch, "train_4k", mesh, profile=profile)
        assert counted_rank(cfg, shape, rules) == want, (mesh, profile)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_the_moe_and_mla_configs_split_over_pod(arch):
    """``seq_dim`` at full width, ``train_4k``: ``pod`` under the
    multi-pod ``fsdp`` rules, None under the arch's default ``tp_ep``
    rules (``seq`` None) on either mesh."""
    from repro_torch.distributed.sharding import _names
    from repro_torch.distributed.tensor_parallel import seq_dim
    from repro_torch.launch.dryrun import cell
    for mesh, profile, want in (("multi", "fsdp", "pod"),
                                ("multi", None, None),
                                ("single", None, None)):
        cfg, shape, strat, rules = cell(arch, "train_4k", mesh,
                                        profile=profile)
        assert strat.name == (profile or "tp_ep")
        batch = tuple(_names(strat.logical_rules["batch"]))
        assert seq_dim(cfg, rules, batch, shape.seq_len) == want, (mesh,
                                                                  profile)
