"""Fault-tolerant training launcher for the language models; port of
``repro/launch/train.py`` on one device.

Runs real steps (the reduced configs train on the CPU; the full ones on
the card) and wires together the fault-tolerance stack:

  * CheckpointManager  async checkpoints, atomic commit, keep-K
  * StepJournal        skip-and-replay journal for exactly-once resume
  * StragglerMonitor   median+hysteresis step-time watchdog; a
                       persistent straggler is reported (the reference's
                       re-mesh needs ROADMAP Queue A item 9)

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train ... --resume

It runs on the card unless ``--device cpu`` is given. The checkpoints
are the reference's layout and paths, so ``--resume`` continues a run
either package wrote. Parameters are drawn from ``--seed`` on the run's
device (the bits differ from ``jax.random``'s); the data is the
reference's numpy stream (:func:`synthetic_batch`), the same tokens in
both packages. Labels are the tokens themselves, as in the reference.
The reference makes a device mesh when it sees more than one device;
the port trains on one (``rules=None``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.execution import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager, latest_step
from repro_torch.distributed.straggler import StepJournal, StragglerMonitor
from repro_torch.models import model as M
from repro_torch.train.steps import (TrainHParams, init_opt_state,
                                     make_train_step)


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

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    hp = TrainHParams(lr=args.lr, n_micro=args.micro,
                      loss_chunk=min(512, args.seq))
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(args.seed),
                          dev)
    opt_state = init_opt_state(params, hp)
    step_fn = make_train_step(cfg, None, hp)

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
                print(f"[resume] from checkpoint step {last}, "
                      f"data offset {offset}")

    mon = StragglerMonitor()
    losses = []
    for step in range(start, args.steps):
        mon.start_step()
        batch = synthetic_batch(cfg, args.batch, args.seq, step, offset, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if mon.end_step(step):
            print(f"[straggler] persistent slow step at {step}; a cluster "
                  f"would snapshot, re-mesh and reshard (not ported: one "
                  f"device)")
        if ckpt and (step % args.ckpt_every == 0 or step == args.steps - 1):
            ckpt.save(step, (params, opt_state),
                      extra={"loss": loss, "step": step})
            journal.record(step, data_offset=offset, seed=args.seed,
                           checkpoint_step=step)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}")
    if ckpt:
        ckpt.wait()
    print(f"[done] {args.steps - start} steps, "
          f"final loss {losses[-1]:.4f}, {mon.summary()}")
    return losses


if __name__ == "__main__":
    main()
