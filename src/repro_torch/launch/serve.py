"""Batched serving launcher: prefill a prompt batch, then decode tokens
greedily with the recurrent (and K/V) state; port of
``repro/launch/serve.py`` for every arch of ``repro_torch.configs``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

It runs on the card unless ``--device cpu`` is given. Parameters are
drawn from ``--seed`` on the run's device (no checkpoint is read);
prompts are numpy token ids from the same seed ([B, P, K] over K
codebooks; M-RoPE's three position streams all arange(P), as the
reference's CLI gives them). With codebooks each step feeds back every
codebook's own greedy token, [B, 1, K]: the reference's CLI broadcasts
one token id over the codebooks and fails on the [B, K] its serve step
returns (ROADMAP Queue C). On the card the decode
steps replay one CUDA graph of the step, captured after the cache is
grown (:func:`~repro_torch.train.steps.make_graphed_serve_step`, the
counterpart of the reference's jitted, donated serve step); the CPU
runs the step eagerly.

Run as more than one rank (``torchrun``, or a process group started
before :func:`main`), it serves under rules, as the reference does when
it sees more than one device, on the serving mesh (every rank on
``data``) where the reference takes its debug mesh. Each rank prefills
and decodes its shard of the batch with the eager ruled steps, the
tokens are gathered on every rank, and rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.execution import resolve_device
from repro_torch.distributed.sharding import tree_map_with_path
from repro_torch.distributed.tensor_parallel import (capacity_dim, mesh_plan,
                                                     state_block, state_split)
from repro_torch.launch.mesh import make_rules, make_serving_mesh
from repro_torch.launch.train import n_ranks
from repro_torch.models import model as M
from repro_torch.train.steps import (batch_shard, greedy,
                                     make_graphed_serve_step,
                                     make_prefill_step, make_serve_step)


def main(argv=None) -> np.ndarray:
    """Serve one batch; returns the generated tokens, int32 [batch, gen]
    ([batch, gen, K] over K codebooks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ranks = n_ranks(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    rules = make_rules(make_serving_mesh()) if ranks > 1 else None
    lead = ranks == 1 or torch.distributed.get_rank() == 0
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(args.seed),
                          dev)
    rng = np.random.default_rng(args.seed)
    shape = ((args.batch, args.prompt_len, cfg.n_codebooks)
             if cfg.n_codebooks else (args.batch, args.prompt_len))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    batch_in = {"tokens": prompts}
    if cfg.mrope_sections:
        batch_in["positions"] = torch.arange(args.prompt_len, device=dev) \
            .expand(3, args.batch, args.prompt_len)

    # prefill fills a capacity == prompt_len cache; decoding continues in
    # a capacity prompt_len + gen cache (copied once, written in place)
    prefill = make_prefill_step(cfg, rules=rules)
    capacity = args.prompt_len + args.gen
    t0 = time.perf_counter()
    logits, state = prefill(params, batch_in)
    rows = (args.batch if rules is None else
            batch_shard(batch_in, rules)[0]["tokens"].shape[0])
    state = _grow_cache(cfg, state, rows, capacity, dev, rules)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0

    t_capture = None
    if dev.type == "cuda" and rules is None:   # one graph for the cache
        t0 = time.perf_counter()
        serve = make_graphed_serve_step(cfg, params, dev)
        serve.precompile(args.batch, capacity)
        torch.cuda.synchronize(dev)
        t_capture = time.perf_counter() - t0
    else:
        serve = make_serve_step(cfg, rules=rules)

    next_tok = greedy(logits)                          # [B] or [B, K]
    toks_d = torch.empty((args.gen, *next_tok.shape), dtype=torch.int32,
                         device=dev)
    t0 = time.perf_counter()
    for i in range(args.gen):
        next_tok, state = serve(params, next_tok[:, None], state)
        toks_d[i].copy_(next_tok)      # a graphed step reuses next_tok
    toks = toks_d.transpose(0, 1).cpu().numpy()
    t_decode = time.perf_counter() - t0

    if not lead:
        return toks
    print(f"[prefill] {args.batch}x{args.prompt_len} in {t_prefill:.3f}s "
          f"on {dev}")
    if t_capture is not None:
        print(f"[capture] decode step graph (batch {args.batch}, capacity "
              f"{capacity}) in {t_capture:.3f}s")
    print(f"[decode ] {args.gen} steps x batch {args.batch} in "
          f"{t_decode:.3f}s  "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"[sample ] first sequence: {toks[0].ravel()[:16].tolist()}")
    return toks


def _grow_cache(cfg, state: dict, batch: int, capacity: int,
                device: str | torch.device | None = None,
                rules=None) -> dict:
    """Copy a prefill-sized state into a decode state of K/V capacity
    ``capacity`` (zero-padded on the capacity axis; every leaf in
    :func:`~repro_torch.models.model.init_decode_state`'s dtype). A
    transformer state with per-layer cache lists (K/V or MLA's latent
    and RoPE key, in each part) grows into lists. A ruled prefill's
    state keeps its share of the K/V and recurrent heads. A cache split
    on its capacity (a ruled prefill's under ``rules``: MLA's latent
    cache, or a K/V cache whose heads do not split over ``tensor``,
    :func:`~repro_torch.distributed.tensor_parallel.state_split`) keeps
    that layout: its rows are gathered over the group, grown, and this
    rank's rows of the new capacity kept (``capacity_rows``: rounded up
    to a multiple of the group); such a cache without its ``rules``
    raises."""
    unrolled = any(isinstance(c, list) for c in
                   state.get("main", {}).values())
    fresh = M.init_decode_state(cfg, batch, capacity, device, unrolled)
    plan = mesh_plan(cfg, rules) if rules is not None else None
    length = int(state["len"])

    def graft(path, f, s):
        ax = capacity_dim(path, s)
        if ax is None:
            return s.to(f.dtype)          # a recurrent leaf: no capacity
        split = plan is not None and state_split(cfg, plan, path, s) == ax
        if split:
            s = torch.cat(plan.tp.all_gather(s).unbind(0), dim=ax)
        elif s.shape[ax] < length:
            raise ValueError(
                f"state{list(path)}: a cache of capacity {s.shape[ax]} "
                f"holding {length} entries is split on its capacity; grow "
                f"it with the rules it was split under")
        if not split and s.shape == f.shape:
            return s.to(f.dtype)
        shape = list(s.shape)
        shape[ax] = capacity
        out = f.new_zeros(shape)
        n = min(capacity, s.shape[ax])
        out.narrow(ax, 0, n).copy_(s.narrow(ax, 0, n))
        return state_block(cfg, plan, path, out) if split else out

    out = tree_map_with_path(graft, fresh, state)
    out["len"] = state["len"]
    return out


if __name__ == "__main__":
    main()
