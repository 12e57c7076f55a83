"""Multi-pod dry run; port of ``repro/launch/dryrun.py``.

For one (architecture x input shape x mesh) cell on a production mesh
(``launch/mesh.py``: 16 x 16 = 256 cards, or 2 x 16 x 16 = 512), run the
port's own ruled step once on ``meta`` tensors, as rank 0 of that mesh
(:func:`counted_rank`: the first rank of the last sequence segment where
a train step splits its sequences, and where ``--seq-shard`` splits a
train or prefill step's over ``model``: rank 15 of either mesh), and
report what one card holds,
computes and sends: the arguments' bytes and the peak of live bytes,
FLOPs and HBM bytes per device, the collectives' bytes, and the three
roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 6

It needs no card: meta tensors have shapes and no data, and the
process group is torch's fake backend (``"fake"``, registered by
``torch.testing._internal.distributed.fake_pg``), which runs every
collective as a no-op. In place of the reference's 512 XLA host
devices, the process starts a fake group of the mesh's size and takes
the counted rank; the ``DeviceMesh`` has the production shape and axis
names, on device type ``"cpu"``.

* **Inputs** are built on ``meta`` from ``launch/specs.py``'s stand-ins
  (the initializers ``init_model``, ``init_opt_state`` and
  ``init_decode_state``, and the batch shapes of ``batch_specs`` /
  ``decode_specs``): each leaf a DTensor with its stand-in's placements
  whose local tensor is this rank's shard, a storage of its own. Placing
  them sends nothing and happens before the counted run, as the
  reference lowers its step on inputs that are sharded already.
* **The counted run** (:func:`~repro_torch.launch.hlo_analysis.analyze`)
  is the port's ruled step: ``make_train_step(cfg, rules, hp)``,
  ``make_prefill_step(cfg, rules)`` or the eager
  ``make_serve_step(cfg, rules, unroll)`` (a graphed step cannot run on
  meta). The ruled steps gather each layer's leaves where it runs and
  compute attention, MLA, the MLPs, the experts, the vocabulary and the
  Mamba-2 and RWKV-6 heads in shards (``distributed/tensor_parallel.py``)
  where the ``tensor`` axis divides them, and a train step each sequence
  in segments over the ``seq`` axis (``Plan.seq``: the multi-pod
  ``fsdp`` rules' ``pod``); with ``--seq-shard`` (``seq`` on ``model``)
  the train and prefill steps hold each sequence's segments over the
  tensor axis, sequence-parallel around its regions (``Plan.sp``); under ``--profile tp_ep_full`` each card
  owns whole experts and the MoE moves the tokens by an all-to-all over
  ``data`` (``Plan.a2a``; the fake group runs it as a no-op, counted as
  NCCL's would move it); the codebook heads are vocabulary-parallel
  and the codebook embeddings codebook-parallel where the axis divides
  them; layers whose heads do not divide are gathered per layer and
  computed whole on every rank. Each segment's queries attend to the
  keys before them, so the last segment's first rank, which scans every
  key, is the one counted: rank 0's count would leave out half the
  causal attention. The serve step holds a rank's batch shard of the
  decode state, its K/V heads where attention splits them, else its
  capacity rows of every K/V head (the reference's split-capacity
  decode), its capacity rows of MLA's latent cache and RoPE key, and its
  heads of the recurrent states (:func:`compute_state_placements`);
  where the
  stand-ins shard a state leaf over another dim (MLA's latent rank and
  RoPE dim, the recurrent states' inner dims), the counted run first
  brings that leaf to the compute placement, and what that moves is
  counted: from the latent rank to the capacity over the same ``tensor``
  axis, an all-to-all (the fake group runs it as a no-op, counted as
  NCCL's would move it).

The result has the reference's keys, but:

* ``lower_s`` and ``compile_s`` are ``place_s`` (building and placing
  the inputs) and ``trace_s`` (the counted run); ``analyze_s`` is gone
  (the count is taken during the run);
* ``memory.argument_bytes`` is this rank's shards of every input (the
  port's Adam step is a host ``int``, the one stand-in not on the
  device); ``peak_bytes`` and ``hbm_estimate_bytes`` are the tracked
  peak of live bytes, arguments included; ``temp_bytes`` = peak -
  arguments; ``output_bytes`` the result's local tensors; and
  ``alias_bytes`` is 0: the port donates nothing (``ExecutionSpec.donate``
  is not ported);
* ``cost`` has ``flops_per_device`` and ``bytes_per_device`` only: the
  ``xla_*_no_trip`` keys have no counterpart;
* ``counted_rank``, added where the counted rank is not 0 (a cell whose
  train step splits its sequences).

``bytes_by_op``, ``collectives`` and ``roofline`` keep the reference's
fields and its ``model_flops`` formula. The roofline constants are the
H100's (SXM5, 80 GB HBM3, 700 W), from NVIDIA's datasheet: modeled
times, not measurements.

``run_cell`` (through :func:`production_mesh`) refuses to run when a
default process group of another size exists, and destroys the group it
started when it returns: call it in a process of its own (``--all``
runs each cell as a subprocess).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import SHAPES, all_cells, applicable, get_config
from repro_torch.distributed.sharding import (_names, mesh_shape, tree_map,
                                              tree_map_with_path)
from repro_torch.distributed.tensor_parallel import (mesh_plan, on_tensor,
                                                     seq_dim, state_block,
                                                     state_split)
from repro_torch.launch.hlo_analysis import analyze, tensors
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (Spec, batch_specs, decode_specs,
                                      model_specs)
from repro_torch.launch.strategy import make_mesh_rules, pick_strategy
from repro_torch.train.steps import (_place, make_prefill_step,
                                     make_serve_step, make_train_step)

# NVIDIA H100 SXM5 datasheet figures (dense bf16, HBM3), not measurements
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
# one 400 Gb/s InfiniBand NIC per card: what a 256-card mesh's collectives
# cross (NVLink's 450 GB/s a direction reaches only the 8 cards of a node)
LINK_BW = 50e9               # bytes/s per card
CARD_BYTES = 80e9


@contextlib.contextmanager
def production_mesh(mesh_kind: str, rank: int = 0):
    """The production ``DeviceMesh`` of ``mesh_kind`` ("single": (16,
    16) data x model; "multi": (2, 16, 16) pod x data x model) on device
    type "cpu", this process ``rank`` of a fake default group of its
    size. The group is started here and destroyed on exit; one of that
    size that exists already is used and left, one of another size
    raises."""
    prod = make_production_mesh(multi_pod=mesh_kind == "multi")
    sizes = tuple(prod.shape.values())
    world = math.prod(sizes)
    started = False
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the mesh needs {world}")
    else:         # importing fake_pg registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        started = True
    try:
        with _card_alltoall():
            yield init_device_mesh("cpu", sizes,
                                   mesh_dim_names=tuple(prod.shape))
    finally:
        if started:
            dist.destroy_process_group()


@contextlib.contextmanager
def _card_alltoall():
    """DTensor moves a shard to another dim (``Shard(i)`` to ``Shard(j)``)
    with an all-to-all, but on a "cpu" mesh it falls back to an
    all-gather of the whole dim and a chunk, since gloo has none. The dry
    run models the card's NCCL: in this block the all-to-all op runs on
    the "cpu" mesh too (the fake group runs it as a no-op). Without the
    block, the int8 Adam moments' reshard of deepseek-v3-671b's
    ``w_down`` gathered 406 GiB a rank."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # the group by name: funcol has no _resolve_group in torch 2.11
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    before = getattr(placement_types, "shard_dim_alltoall", None)
    if before is None:                 # another torch: left as it is
        yield
        return
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = before


def materialize(specs, mesh):
    """A tree of :class:`~repro_torch.launch.specs.Spec` as meta
    DTensors on ``mesh``: each local tensor this rank's shard, with a
    storage of its own (``distribute_tensor`` would keep a view of the
    global tensor); a Spec without sharding as a plain meta tensor."""
    def one(s):
        if not isinstance(s, Spec):
            return s
        if s.sharding is None:
            return torch.empty(s.shape, dtype=s.dtype, device="meta")
        local = torch.empty(s.shard_shape, dtype=s.dtype, device="meta")
        stride = torch.empty(s.shape, device="meta").stride()
        return DTensor.from_local(local, mesh, s.sharding.placements,
                                  run_check=False, shape=s.shape,
                                  stride=stride)
    return tree_map(one, specs)


def cell_specs(cfg, shape, rules, strat, *, unroll_decode: bool = False
               ) -> tuple:
    """The stand-ins of a cell's step arguments (``launch/specs.py``):
    (params, opt_state, batch) for train, (params, batch) for prefill,
    (params, tokens, state) for decode; the Adam step the host int 0."""
    if shape.kind == "train":
        pspecs, ospecs = model_specs(cfg, rules, strat.hparams)
        return pspecs, ospecs._replace(step=0), batch_specs(cfg, shape, rules)
    pspecs, _ = model_specs(cfg, rules)
    if shape.kind == "prefill":
        return pspecs, batch_specs(cfg, shape, rules)
    return (pspecs, *decode_specs(cfg, shape, rules, unrolled=unroll_decode))


def cell_step(cfg, shape, rules, strat, *, unroll_decode: bool = False):
    """The port's ruled step of a cell, called on :func:`cell_specs`'
    arguments."""
    if shape.kind == "train":
        return make_train_step(cfg, rules, strat.hparams)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, rules)
    return _compute_state(make_serve_step(cfg, rules, unroll_decode), cfg,
                          rules)


def cell(arch: str, shape_name: str, mesh_kind: str, mesh=None, *,
         profile=None, micro=None, seq_shard=None) -> tuple:
    """(cfg, shape, strategy, rules) of a cell on ``mesh`` (default: the
    device-free production mesh)."""
    cfg = get_config(arch)
    if not applicable(cfg, shape_name):
        raise ValueError(f"{arch} x {shape_name} skipped (full attention, "
                         f"DESIGN.md)")
    multi = mesh_kind == "multi"
    shape = SHAPES[shape_name]
    strat = pick_strategy(cfg, shape, multi_pod=multi,
                          override_profile=profile, override_micro=micro)
    if seq_shard:
        strat.logical_rules["seq"] = "model"
    mesh = make_production_mesh(multi_pod=multi) if mesh is None else mesh
    return cfg, shape, strat, make_mesh_rules(mesh, strat)


def counted_rank(cfg, shape, rules) -> int:
    """The rank whose run a cell counts: 0, or where the train or prefill
    step splits each sequence (``tensor_parallel.seq_dim``, on the
    device-free ``rules``), the first rank of the last segment, whose
    queries see every key (the multi-pod ``fsdp`` train cells: rank 256
    of 512; a ``--seq-shard`` train or prefill cell, its sequences over
    ``model``: rank 15 of either mesh)."""
    if shape.kind not in ("train", "prefill"):
        return 0
    tokens = batch_specs(cfg, shape, rules)["tokens"].sharding.spec
    dim = seq_dim(cfg, rules, _names(tokens[0]) if tokens else (),
                  shape.seq_len)
    if dim is None or (shape.kind == "prefill"
                       and not on_tensor(rules, dim)):
        return 0
    rank = 0
    for name, size in mesh_shape(rules.mesh).items():
        rank = rank * size + (size - 1 if name == dim else 0)
    return rank


def stand_in_bytes(arch: str, shape_name: str, mesh_kind: str) -> int:
    """One device's bytes of a cell's stand-ins on the device-free
    production mesh: the sum of prod(shard_shape) x itemsize over
    :func:`cell_specs`' leaves, what :func:`run_cell`'s
    ``argument_bytes`` must be."""
    cfg, shape, strat, rules = cell(arch, shape_name, mesh_kind)
    sizes: list = []
    tree_map(lambda s: sizes.append(math.prod(s.shard_shape)
                                    * s.dtype.itemsize)
             if isinstance(s, Spec) else None,
             cell_specs(cfg, shape, rules, strat))
    return sum(sizes)


def compute_state_placements(cfg, rules, path: tuple, t) -> list:
    """The placements the ruled serve step computes a decode-state leaf
    ``t`` (a DTensor at ``path``) with: its shards over the ``batch``
    axes and, over the ``tensor`` axis, its block on
    :func:`~repro_torch.distributed.tensor_parallel.state_split`'s dim
    where that block is DTensor's even chunk (the K/V heads of a GQA
    cache where attention splits them, else a capacity that the axis
    divides, and so MLA's latent cache; the heads of a Mamba-2 ``ssm``
    or RWKV-6 ``wkv`` state where those layers split them); every other
    axis gathered (a ``conv``
    state, or a capacity the axis does not divide, is then cut to this
    rank's part by :func:`_compute_state`)."""
    from torch.distributed.tensor import Shard
    batch_axes = set(_names(rules.rules.get("batch")))
    plan = mesh_plan(cfg, rules)
    split = state_split(cfg, plan, path, t)
    if split is not None and t.shape[split] % plan.tp.size:
        split = None
    return [p if n in batch_axes else
            Shard(split) if split is not None and n == plan.tp.dim
            else Replicate()
            for n, p in zip(rules.mesh.mesh_dim_names, t.placements)]


def _compute_state(serve_step, cfg, rules):
    """``serve_step`` on a decode state placed as the stand-ins lay it
    out: each leaf first brought to :func:`compute_state_placements`
    (the other axes gathered), and its local shard passed on (where that
    gathered ``tensor``, cut to this rank's part by
    :func:`~repro_torch.distributed.tensor_parallel.state_block`)."""
    from torch.distributed.tensor import Shard
    mesh = rules.mesh
    plan = mesh_plan(cfg, rules)

    def local(path, t):
        pl = compute_state_placements(cfg, rules, path, t)
        out = _place(t, mesh, pl).to_local()
        if plan.tp is None or isinstance(
                pl[mesh.mesh_dim_names.index(plan.tp.dim)], Shard):
            return out
        return state_block(cfg, plan, path, out)

    def step(params, tokens, state):
        return serve_step(params, tokens, tree_map_with_path(local, state))
    return step


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             profile=None, micro=None, seq_shard=None,
             unroll_decode: bool = False,
             verbose: bool = True) -> dict:
    cfg, shape, _, rules = cell(arch, shape_name, mesh_kind, profile=profile,
                                micro=micro, seq_shard=seq_shard)
    rank = counted_rank(cfg, shape, rules)
    with production_mesh(mesh_kind, rank) as mesh:
        chips = mesh.size()
        cfg, shape, strat, rules = cell(
            arch, shape_name, mesh_kind, mesh, profile=profile, micro=micro,
            seq_shard=seq_shard)
        t0 = time.time()
        args = materialize(cell_specs(cfg, shape, rules, strat,
                                      unroll_decode=unroll_decode), mesh)
        step = cell_step(cfg, shape, rules, strat,
                         unroll_decode=unroll_decode)
        t_place = time.time() - t0

        t0 = time.time()
        out, acc = analyze(step, *args)
        t_trace = time.time() - t0
        out_bytes = sum({t.untyped_storage()._cdata: t.untyped_storage()
                         .nbytes() for t in tensors(out)}.values())
        del out, args
    coll = acc["coll"]
    flops_dev = float(acc["flops"])
    bytes_dev = float(acc["bytes"])
    coll_dev = float(coll["total_bytes"])

    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        model_flops = 6 * n_active * b * s
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * b * s
    else:
        model_flops = 2 * n_active * b
    model_flops_dev = model_flops / chips

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    arg_b, peak_b = acc["argument_bytes"], acc["peak_bytes"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": int(chips), "strategy": strat.name,
        "n_micro": strat.hparams.n_micro,
        "params": int(cfg.n_params()), "active_params": int(n_active),
        "place_s": round(t_place, 2), "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_bytes,
            "temp_bytes": peak_b - arg_b,
            "peak_bytes": peak_b,
            "alias_bytes": 0,
            "hbm_estimate_bytes": peak_b,
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "bytes_by_op": dict(sorted(acc["bytes_by_op"].items(),
                                   key=lambda kv: -kv[1])[:20]),
        "collectives": coll,
        "roofline": {
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops": model_flops,
            "model_flops_per_device": model_flops_dev,
            "useful_flop_ratio": (model_flops_dev / flops_dev
                                  if flops_dev else 0.0),
            "roofline_fraction": ((model_flops_dev / PEAK_FLOPS) / bound
                                  if bound else 0.0),
        },
    }
    if rank:
        result["counted_rank"] = rank
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_kind} "
              f"[{strat.name}, {chips} cards, rank {rank} counted] ==")
        print(f"  place {t_place:.1f}s trace {t_trace:.1f}s "
              f"({acc['ops']} ops)")
        print(f"  memory: arguments {arg_b / 2**30:.2f} GiB, peak "
              f"{peak_b / 2**30:.2f} GiB/card (the card holds "
              f"{CARD_BYTES / 1e9:.0f} GB)")
        print(f"  cost: flops/dev={flops_dev:.3e} bytes/dev={bytes_dev:.3e}")
        print("  collectives: " + ", ".join(
            f"{k}:{v['bytes']/2**20:.1f}MiB/{v['count']}"
            for k, v in coll.items() if isinstance(v, dict) and v["count"]))
        r = result["roofline"]
        print(f"  roofline (H100 datasheet, modeled): compute "
              f"{r['t_compute_s']*1e3:.2f}ms | memory "
              f"{r['t_memory_s']*1e3:.2f}ms | collective "
              f"{r['t_collective_s']*1e3:.2f}ms -> {r['dominant']}-bound, "
              f"useful-flop ratio {r['useful_flop_ratio']:.2f}, "
              f"roofline fraction {r['roofline_fraction']:.2f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--profile", default=None,
                    help="override strategy profile (fsdp | tp_ep | "
                         "tp_ep_full | tp_serve)")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--seq-shard", action="store_true",
                    help="bind logical 'seq' axis to 'model' (SP variant)")
    ap.add_argument("--unroll-decode", action="store_true",
                    help="unrolled-layer decode, per-layer cache leaves")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="run the full (arch x shape x mesh) grid as "
                         "subprocesses")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells run at once, each a process")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = all_cells()
        meshes = args.meshes.split(",")
        todo = []
        for mesh_kind in meshes:
            for arch, shape in cells:
                tag = f"{arch}_{shape}_{mesh_kind}"
                if os.path.exists(os.path.join(args.out, tag + ".json")):
                    print(f"[skip] {tag} (cached)")
                    continue
                todo.append((tag, [sys.executable, "-m",
                                   "repro_torch.launch.dryrun", "--arch",
                                   arch, "--shape", shape, "--mesh",
                                   mesh_kind, "--out", args.out]))

        def run(item):
            tag, cmd = item
            print(f"[run ] {tag}", flush=True)
            return tag, subprocess.run(cmd, capture_output=True, text=True)
        failures = []
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            for tag, r in pool.map(run, todo):
                if r.returncode != 0:
                    failures.append(tag)
                    print(f"[FAIL] {tag}\n{r.stdout[-2000:]}"
                          f"\n{r.stderr[-4000:]}", flush=True)
                else:
                    print(r.stdout.rstrip(), flush=True)
        print(f"\n{len(cells) * len(meshes) - len(failures)} ok, "
              f"{len(failures)} failed: {failures}")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    result = run_cell(args.arch, args.shape, args.mesh,
                      profile=args.profile, micro=args.micro,
                      seq_shard=args.seq_shard,
                      unroll_decode=args.unroll_decode)
    tag = f"{args.arch}_{args.shape}_{args.mesh}"
    suffix = ""
    if args.profile or args.micro or args.seq_shard or args.unroll_decode:
        suffix = f"__{args.profile or ''}m{args.micro or ''}" + \
            ("sp" if args.seq_shard else "") + \
            ("ur" if args.unroll_decode else "")
    with open(os.path.join(args.out, tag + suffix + ".json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
