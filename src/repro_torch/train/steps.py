"""prefill_step / serve_step builders; port of ``repro/train/steps.py``.

The reference builds pure functions for ``jit`` and enters its sharding
rules inside them; on one card there are no rules, and the port's steps
are plain functions. ``make_train_step`` (the LM loss, microbatching and
Adam) is not ported yet (ROADMAP Queue A item 8).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ArchConfig, kernels: bool = True):
    """prefill_step(params, batch) -> (last-token logits, decode state).

    ``batch``: {"tokens" [B, S], optional "positions"}. On the card the
    recurrences run through the CUDA kernels unless ``kernels`` is False.
    """
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch["tokens"],
                         positions=batch.get("positions"), kernels=kernels)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, tokens, state) -> (next token ids, new state).

    One decode step for the whole request batch: the greedy next token
    (int32 [B]). A ``hybrid`` state's K/V caches are updated in place, as
    the reference's caller donates the state to its jitted step.
    """
    def serve_step(params, tokens, state):
        logits, new_state = M.decode_step(params, cfg, tokens, state)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok.to(torch.int32), new_state
    return serve_step
