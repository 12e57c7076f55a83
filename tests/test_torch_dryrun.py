"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro/launch/dryrun.py``), with no device:

* **argument bytes** of all 32 cells on both production meshes: the
  port's inputs placed on a fake group of 256 / 512 ranks (one
  subprocess for the 64 pairs) and counted by ``analyze``, equal to the
  sum of shard bytes of the reference's ``jax.eval_shape`` stand-ins on
  jax's ``AbstractMesh`` (no compile). The one stand-in the port does not
  hold on the device is Adam's step, a host ``int`` (the reference's a
  4-byte int32 array);
* **one full-width cell** through the CLI in a subprocess (qwen2-1.5b
  ``train_4k`` single, ~10 s): the JSON holds the reference's
  ``run_cell`` keys but for the renamed and dropped ones the module's
  docstring names, a useful-flop ratio in (0.5, 1], and a peak at least
  the arguments;
* **reduced cells' FLOPs** against the reference's ``analyze`` of the
  same reduced step, jitted on one CPU device with ``rules=None``, at B
  = 1 and S = 1024 (the reference's attention pads its keys to blocks of
  1024, so a shorter S counts padding the port does not compute). Dense
  (qwen2-1.5b) and recurrent (rwkv6-3b) prefill and decode: equal. MoE
  (qwen3-moe-30b-a3b): the reference dispatches tokens to experts and
  combines them back by one-hot einsums, 4·G·T_g·E·C·(k + D) FLOPs per
  MoE layer, where the port gathers rows; its prefill equals the
  reference's less exactly that, and its decode lies between the two
  (XLA turns some of those einsums into multiplies at T_g = 1). Train
  cells, dense and recurrent: within 5 % (each side's remat recompute);
* ``--all`` skips the cells whose JSON is cached and runs the rest as
  subprocesses of the port's own module;
* the expert-parallel MoE: the reduced qwen3-moe prefill as rank 0 of a
  fake (1, 4) group counts a quarter of the one-rank prefill's expert
  products (one subprocess).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro import configs as RCF
from repro.launch import specs as RSP
from repro.launch import strategy as RST
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.models.moe import _pick_group_size
from repro.train import steps as RS
from repro_torch import configs as TCF
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as TSP
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.train import steps as TS

ROOT = Path(__file__).resolve().parents[1]
CELLS = RCF.all_cells()
PAIRS = [(a, s, m) for m in ("single", "multi") for a, s in CELLS]
TRAIN_TOL = 0.05


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


ARGUMENT_BYTES = """
import json
from repro_torch.configs import all_cells
from repro_torch.launch.dryrun import (cell, cell_specs, materialize,
                                       production_mesh)
from repro_torch.launch.hlo_analysis import analyze
out = {}
for kind in ("single", "multi"):
    with production_mesh(kind) as mesh:
        for arch, shape in all_cells():
            cfg, shp, strat, rules = cell(arch, shape, kind, mesh)
            args = materialize(cell_specs(cfg, shp, rules, strat), mesh)
            out[f"{arch} {shape} {kind}"] = analyze(lambda *a: None,
                                                    *args)[1][
                "argument_bytes"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_argument_bytes() -> dict:
    out = subprocess.run([sys.executable, "-c", ARGUMENT_BYTES], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def _ref_shard_bytes(tree) -> int:
    return sum(int(np.prod(r.sharding.shard_shape(r.shape)))
               * np.dtype(r.dtype).itemsize
               for r in jax.tree_util.tree_leaves(tree))


def _ref_stand_ins(arch: str, shape_name: str, multi: bool) -> int:
    """One device's bytes of the reference's stand-ins of a cell, the
    Adam step left out."""
    cfg, shape = RCF.get_config(arch), RCF.SHAPES[shape_name]
    mesh = JaxAbstractMesh((2, 16, 16) if multi else (16, 16),
                           ("pod", "data", "model") if multi
                           else ("data", "model"))
    strat = RST.pick_strategy(cfg, shape, multi_pod=multi)
    rules = RST.make_mesh_rules(mesh, strat)
    if shape.kind == "train":
        pspecs, ospecs = RSP.model_specs(cfg, rules, strat.hparams)
        return _ref_shard_bytes((pspecs, ospecs._replace(step=None),
                                 RSP.batch_specs(cfg, shape, rules)))
    pspecs, _ = RSP.model_specs(cfg, rules)
    if shape.kind == "prefill":
        return _ref_shard_bytes((pspecs, RSP.batch_specs(cfg, shape, rules)))
    return _ref_shard_bytes((pspecs, RSP.decode_specs(cfg, shape, rules)))


@pytest.mark.parametrize("arch,shape,mesh", PAIRS,
                         ids=[" ".join(p) for p in PAIRS])
def test_argument_bytes_equal_the_references_stand_ins(
        port_argument_bytes, arch, shape, mesh):
    want = _ref_stand_ins(arch, shape, mesh == "multi")
    assert port_argument_bytes[f"{arch} {shape} {mesh}"] == want
    assert D.stand_in_bytes(arch, shape, mesh) == want


# the reference's run_cell keys, and what the port renames or drops
REF_KEYS = {"arch", "shape", "mesh", "chips", "strategy", "n_micro",
            "params", "active_params", "lower_s", "compile_s", "analyze_s",
            "memory", "cost", "bytes_by_op", "collectives", "roofline"}
RENAMED = {"lower_s": "place_s", "compile_s": "trace_s"}
DROPPED = {"analyze_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "alias_bytes", "hbm_estimate_bytes"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "model_flops", "model_flops_per_device",
                 "useful_flop_ratio", "roofline_fraction"}


def test_cli_full_width_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    r = json.loads((tmp_path / "qwen2-1.5b_train_4k_single.json").read_text())
    want = {RENAMED.get(k, k) for k in REF_KEYS - DROPPED}
    assert set(r) == want
    assert set(r["memory"]) == MEMORY_KEYS
    assert set(r["cost"]) == {"flops_per_device", "bytes_per_device"}
    assert set(r["roofline"]) == ROOFLINE_KEYS
    assert (r["chips"], r["strategy"], r["n_micro"]) == (256, "fsdp", 1)
    mem, rf = r["memory"], r["roofline"]
    assert mem["argument_bytes"] == D.stand_in_bytes("qwen2-1.5b",
                                                     "train_4k", "single")
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["hbm_estimate_bytes"] == mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mem["alias_bytes"] == 0
    assert 0.5 < rf["useful_flop_ratio"] <= 1.0
    assert rf["dominant"] in ("compute", "memory", "collective")
    coll = r["collectives"]
    assert coll["all-gather"]["count"] > 0 and coll["reduce-scatter"][
        "count"] > 0
    assert coll["total_bytes"] == sum(v["bytes"] for v in coll.values()
                                      if isinstance(v, dict))
    assert 0 < rf["roofline_fraction"] <= 1.0


def _flops(arch: str, kind: str) -> tuple:
    """(the port's FLOPs, the reference's) of a reduced cell's plain step
    at B = 1, S = 1024."""
    rc, tc = RCF.get_reduced(arch), TCF.get_reduced(arch)
    shape = ShapeSpec("reduced", 1024, 1, kind)
    if kind == "train":
        rhp, thp = RS.TrainHParams(loss_chunk=512), \
            TS.TrainHParams(loss_chunk=512)
        rp, ro = RSP.model_specs(rc, None, rhp)
        ref = (RS.make_train_step(rc, None, rhp),
               (rp, ro, RSP.batch_specs(rc, shape, None)))
        pp, po = TSP.model_specs(tc, None, thp)
        port = (TS.make_train_step(tc, None, thp),
                (pp, po._replace(step=0), TSP.batch_specs(tc, shape, None)))
    elif kind == "prefill":
        ref = (RS.make_prefill_step(rc, None),
               (RSP.model_specs(rc, None)[0],
                RSP.batch_specs(rc, shape, None)))
        port = (TS.make_prefill_step(tc),
                (TSP.model_specs(tc, None)[0],
                 TSP.batch_specs(tc, shape, None)))
    else:
        ref = (RS.make_serve_step(rc, None),
               (RSP.model_specs(rc, None)[0],
                *RSP.decode_specs(rc, shape, None)))
        port = (TS.make_serve_step(tc),
                (TSP.model_specs(tc, None)[0],
                 *TSP.decode_specs(tc, shape, None)))
    want = ref_analyze(jax.jit(ref[0]).lower(*ref[1]).compile()
                       .as_text())["flops"]
    got = analyze(port[0], *D.materialize(port[1], None))[1]["flops"]
    return got, want


def _moe_dispatch_flops(arch: str, tokens: int) -> int:
    """The reference's one-hot dispatch and combine einsums (disp, comb:
    2·G·T_g·E·C·k each; buf, yt: 2·G·T_g·E·C·D each), over its MoE
    layers."""
    cfg = RCF.get_reduced(arch)
    mo = cfg.moe
    tg = _pick_group_size(tokens)
    g = tokens // tg
    cap = max(int(mo.capacity_factor * tg * mo.top_k / mo.n_experts), 4)
    per_layer = 4 * g * tg * mo.n_experts * cap * (mo.top_k + cfg.d_model)
    return per_layer * (cfg.n_layers - mo.n_dense_layers)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_reduced_flops_equal_the_reference(arch, kind):
    got, want = _flops(arch, kind)
    assert got == want > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_reduced_moe_flops_less_the_references_dispatch(kind):
    arch = "qwen3-moe-30b-a3b"
    got, want = _flops(arch, kind)
    dispatch = _moe_dispatch_flops(arch, 1024 if kind == "prefill" else 1)
    if kind == "prefill":
        assert got == want - dispatch
    else:
        assert want - dispatch <= got < want


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_reduced_train_flops_within_a_band(arch):
    got, want = _flops(arch, "train")
    assert abs(got / want - 1) <= TRAIN_TOL, (got, want)


def test_all_skips_cached_cells(tmp_path, monkeypatch, capsys):
    cells = TCF.all_cells()
    missing = {f"{a}_{s}_single" for a, s in cells[:2]}
    for a, s in cells:
        if f"{a}_{s}_single" not in missing:
            (tmp_path / f"{a}_{s}_single.json").write_text("{}")
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="done\n",
                                           stderr="")
    monkeypatch.setattr(D.subprocess, "run", fake_run)
    with pytest.raises(SystemExit) as e:
        D.main(["--all", "--meshes", "single", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert len(ran) == 2
    for (a, s), cmd in zip(cells[:2], ran):
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
        assert cmd[3:] == ["--arch", a, "--shape", s, "--mesh", "single",
                           "--out", str(tmp_path)]
    text = capsys.readouterr().out
    assert text.count("[skip]") == len(cells) - 2
    assert f"{len(cells)} ok, 0 failed" in text


EXPERT_FLOPS = """
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import SHAPES, get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import cell_specs, materialize
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train.steps import make_prefill_step


def experts(a, b):            # the experts' products: the run's only baddbmm
    if a.ndim < 3:
        return dot(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.baddbmm(torch.zeros((), dtype=dt, device=a.device),
                         a.to(dt), b.to(dt))


dot, MOE.dot = MOE.dot, experts
cfg = get_reduced("qwen3-moe-30b-a3b")
strat = pick_strategy(cfg, SHAPES["prefill_32k"])
shape = ShapeSpec("reduced", 256, 4, "prefill")
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
rules = make_mesh_rules(mesh, strat)
_, ruled = analyze(make_prefill_step(cfg, rules),
                   *materialize(cell_specs(cfg, shape, rules, strat), mesh))
dist.destroy_process_group()
tokens = torch.empty((4, 256), dtype=torch.int32, device="meta")
_, plain = analyze(make_prefill_step(cfg), M.init_model(cfg, None, "meta"),
                   {"tokens": tokens})
print(json.dumps({"ruled": ruled["flops_by_op"],
                  "plain": plain["flops_by_op"]}))
"""


def test_expert_parallel_prefill_counts_a_quarter_of_the_experts():
    """The reduced qwen3-moe prefill (B = 4, S = 256) under
    ``prefill_32k``'s tp_ep rules, rank 0 of a fake (1, 4) group on
    meta: its experts' products (made the run's only ``baddbmm``) count a
    quarter of the one-rank plain prefill's, which count 3 products of
    2·E·(G·C)·D·F FLOPs per MoE layer (G = 1 group of 1024 tokens, C =
    1024 slots at capacity factor 4)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import _pick_group_size
    out = subprocess.run([sys.executable, "-c", EXPERT_FLOPS], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    cfg = get_reduced("qwen3-moe-30b-a3b")
    mo, t = cfg.moe, 4 * 256
    tg = _pick_group_size(t)
    cap = max(int(mo.capacity_factor * tg * mo.top_k / mo.n_experts), 4)
    want = (cfg.n_layers * 3 * 2 * mo.n_experts * (t // tg) * cap
            * cfg.d_model * mo.d_ff_expert)
    assert got["plain"]["baddbmm"] == want
    assert got["ruled"]["baddbmm"] * 4 == want
    assert sum(got["ruled"].values()) < sum(got["plain"].values())
