"""Fault-tolerant training launcher for the language models; port of
``repro/launch/train.py``.

Runs real steps (the reduced configs train on the CPU; the full ones on
the card) and wires together the fault-tolerance stack:

  * CheckpointManager  async checkpoints, atomic commit, keep-K
  * StepJournal        skip-and-replay journal for exactly-once resume
  * StragglerMonitor   median+hysteresis step-time watchdog; on a
                       persistent straggler the policy is snapshot ->
                       ``replan_mesh`` over the ranks -> ``reshard_tree``
                       (:func:`remesh`; on one rank it is reported)

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train ... --resume
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --reduced --device cpu ...

It runs on the card unless ``--device cpu`` is given. The checkpoints
are the reference's layout and paths, so ``--resume`` continues a run
either package wrote. Parameters are drawn from ``--seed`` on the run's
device (the bits differ from ``jax.random``'s); the data is the
reference's numpy stream (:func:`synthetic_batch`), the same tokens in
both packages. Labels are the tokens themselves, as in the reference.

The reference makes a device mesh when it sees more than one device;
the port does when it runs as more than one rank (``torchrun``, or a
process group started before :func:`main`): the debug mesh
(``launch.mesh.make_debug_mesh``, nccl on the card, gloo on the CPU)
and its standard rules drive ``make_train_step``'s ruled step. Every
rank computes the same global batch and takes its shard; rank 0 prints,
saves the (gathered) checkpoint and keeps the journal.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.execution import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager, latest_step
from repro_torch.distributed.elastic import (replan_mesh, reshard_tree,
                                             rules_for)
from repro_torch.distributed.sharding import gather_tree, mesh_shape
from repro_torch.distributed.straggler import StepJournal, StragglerMonitor
from repro_torch.launch.mesh import (init_distributed, make_debug_mesh,
                                     make_rules)
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     make_train_step, place_train_state)


def synthetic_batch(cfg, batch: int, seq: int, step: int, offset: int = 0,
                    device: str | torch.device = "cpu") -> dict:
    """Deterministic synthetic LM data, seeded by the global data offset
    so that skip-and-replay reproduces the exact stream: the reference's
    numpy draws, int32 tokens [batch, seq] ([batch, seq, K] over K
    codebooks) on ``device``; labels are the same tensor. For M-RoPE the
    three position streams are arange(seq), [3, batch, seq]."""
    rng = np.random.default_rng(1234 + offset + step)
    shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, seq))
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    t = torch.from_numpy(tokens).to(device)
    out = {"tokens": t, "labels": t}
    if cfg.mrope_sections:
        out["positions"] = torch.arange(seq, dtype=torch.int32,
                                        device=device).expand(3, batch, seq)
    return out


def n_ranks(device: str | None) -> int:
    """Start the process group when this run is one of several ranks
    (``torchrun``'s ``WORLD_SIZE``, or a group already started); the
    number of ranks (1: no group)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_distributed(device)
    return 1


def any_rank(flag: bool, device: torch.device) -> bool:
    """``flag`` or-ed over the ranks: every rank takes the same branch."""
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def remesh(params, opt_state, rules):
    """The straggler policy: snapshot the state (its global tensors),
    plan the mesh over the group's ranks (``replan_mesh``, the model
    axis kept), and place the snapshot on it (``reshard_tree``). Returns
    (params, opt_state, the new mesh's rules)."""
    snap = gather_tree((params, opt_state))
    mesh = replan_mesh(dist.get_world_size(),
                       model_parallel=mesh_shape(rules.mesh)["model"])
    params, opt_state = reshard_tree(snap, mesh)
    return params, opt_state, rules_for(mesh)


def main(argv=None) -> list[float]:
    """Train; returns the loss of every step run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ranks = n_ranks(args.device)
    dev = resolve_device(args.device)
    rules = make_rules(make_debug_mesh()) if ranks > 1 else None
    lead = ranks == 1 or dist.get_rank() == 0
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    hp = TrainHParams(lr=args.lr, n_micro=args.micro,
                      loss_chunk=min(512, args.seq))
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(args.seed),
                          dev)
    opt_state = init_opt_state(params, hp)
    step_fn = make_train_step(cfg, rules, hp)

    start, offset = 0, 0
    ckpt = journal = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        journal = StepJournal(os.path.join(args.ckpt_dir, "journal.jsonl"))
        if args.resume:
            rp = journal.replay_point()
            last = latest_step(args.ckpt_dir)
            if rp is not None and last is not None:
                (params, opt_state), _ = ckpt.restore((params, opt_state),
                                                      step=last)
                start = last + 1
                offset = rp["data_offset"]
                if lead:
                    print(f"[resume] from checkpoint step {last}, "
                          f"data offset {offset}")

    if rules is not None:      # placed before the loop: the plain trees go
        params, opt_state = place_train_state(params, opt_state, rules)
    mon = StragglerMonitor()
    losses = []
    for step in range(start, args.steps):
        mon.start_step()
        batch = synthetic_batch(cfg, args.batch, args.seq, step, offset, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        slow = mon.end_step(step)
        if rules is not None and any_rank(slow, dev):
            params, opt_state, rules = remesh(params, opt_state, rules)
            step_fn = make_train_step(cfg, rules, hp)
            if lead:
                print(f"[straggler] persistent slow step at {step}: "
                      f"snapshot, re-meshed onto "
                      f"{mesh_shape(rules.mesh)}, resharded")
        elif slow:
            print(f"[straggler] persistent slow step at {step}; one rank: "
                  f"nothing to re-mesh")
        if ckpt and (step % args.ckpt_every == 0 or step == args.steps - 1):
            state = gather_tree((params, opt_state))    # every rank
            if lead:
                ckpt.save(step, state, extra={"loss": loss, "step": step})
                journal.record(step, data_offset=offset, seed=args.seed,
                               checkpoint_step=step)
        if lead and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}")
    if ckpt:
        ckpt.wait()
    if ranks > 1:
        dist.barrier()      # the checkpoint is written before any rank ends
    if lead:
        print(f"[done] {args.steps - start} steps, "
              f"final loss {losses[-1]:.4f}, {mon.summary()}")
    return losses


if __name__ == "__main__":
    main()
