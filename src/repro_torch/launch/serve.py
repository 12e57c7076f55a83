"""Batched serving launcher: prefill a prompt batch, then decode tokens
greedily with the recurrent (and K/V) state; port of
``repro/launch/serve.py`` for the ported families (rwkv6-3b, zamba2-7b).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

It runs on the card unless ``--device cpu`` is given. Parameters are
drawn from ``--seed`` on the run's device (no checkpoint is read);
prompts are numpy token ids from the same seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.execution import resolve_device
from repro_torch.models import model as M
from repro_torch.models.model import tree_map
from repro_torch.train.steps import make_prefill_step, make_serve_step


def main(argv=None) -> np.ndarray:
    """Serve one batch; returns the generated tokens, int32 [batch, gen]."""
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

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    params = M.init_model(cfg, torch.Generator(dev).manual_seed(args.seed),
                          dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)

    # prefill fills a capacity == prompt_len cache; decoding continues in
    # a capacity prompt_len + gen cache (copied once, written in place)
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": prompts})
    state = _grow_cache(cfg, state, args.batch, args.prompt_len + args.gen,
                        dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0

    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        next_tok, state = serve(params, next_tok.reshape(args.batch, 1),
                                state)
        out.append(next_tok)
    toks = torch.stack(out, dim=1).cpu().numpy() if out else \
        np.zeros((args.batch, 0), np.int32)
    t_decode = time.perf_counter() - t0

    print(f"[prefill] {args.batch}x{args.prompt_len} in {t_prefill:.3f}s "
          f"on {dev}")
    print(f"[decode ] {args.gen} steps x batch {args.batch} in "
          f"{t_decode:.3f}s  "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"[sample ] first sequence: {toks[0].ravel()[:16].tolist()}")
    return toks


def _grow_cache(cfg, state: dict, batch: int, capacity: int,
                device: str | torch.device | None = None) -> dict:
    """Copy a prefill-sized state into a decode state of K/V capacity
    ``capacity`` (zero-padded on the capacity axis; every leaf in
    :func:`~repro_torch.models.model.init_decode_state`'s dtype)."""
    fresh = M.init_decode_state(cfg, batch, capacity, device)

    def graft(f, s):
        if f.ndim >= 3 and s.ndim == f.ndim and f.shape != s.shape:
            # K/V caches differ on the capacity axis (axis 2)
            f[tuple(slice(0, n) for n in s.shape)] = s
            return f
        return s.to(f.dtype)

    out = tree_map(graft, fresh, state)
    out["len"] = state["len"]
    return out


if __name__ == "__main__":
    main()
