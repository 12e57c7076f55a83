"""prefill_step / serve_step builders; port of ``repro/train/steps.py``.

The reference builds pure functions for ``jit`` and enters its sharding
rules inside them; on one card there are no rules, and the port's steps
are plain functions. ``make_train_step`` (the LM loss, microbatching and
Adam) is not ported yet (ROADMAP Queue A item 8).

The reference jits its serve step with the state donated
(``jax.jit(serve_step, donate_argnums=(2,))``). The port's counterpart
is :class:`GraphedServeStep` (:func:`make_graphed_serve_step`): one
decode step captured as one CUDA graph per ``(batch, cache capacity)``
over static buffers, called like ``make_serve_step``'s function.
:func:`serve_step_into` is the step the graph captures, written back
into its own buffers; :class:`StaticServeStep` runs it eagerly over the
same static buffers and bookkeeping (the CPU tests hold it to the plain
step). The graphed step is the card's: it raises on the CPU, and a
capture that fails raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.execution import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.models.model import tree_map


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


def serve_step_into(cfg: ArchConfig, params, tokens: torch.Tensor,
                    state: dict, next_tok: torch.Tensor) -> torch.Tensor:
    """One decode step written back into its buffers: what a graphed
    step captures.

    Reads ``tokens`` [B, 1] int32 and ``state``; copies the new
    recurrent leaves and ``len`` back into ``state`` (``decode_step``
    returns new tensors for them; a ``hybrid`` state's K/V caches are
    written in place by the step itself) and the greedy token into
    ``next_tok`` [B] int32, which ``tokens`` may view. Returns the
    step's logits [B, 1, V]. Nothing here reads the card from the host.
    """
    logits, new_state = M.decode_step(params, cfg, tokens, state)
    tree_map(lambda dst, src: dst if dst is src else dst.copy_(src),
             state, new_state)
    next_tok.copy_(torch.argmax(logits[:, -1], dim=-1))
    return logits


def warm_serve_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                    state: dict, next_tok: torch.Tensor) -> None:
    """Run :func:`serve_step_into` once on scratch copies of the
    buffers: it loads every kernel and library handle the step uses
    before a capture, and leaves the given buffers untouched (a step
    writes a K/V row and the recurrent state)."""
    serve_step_into(cfg, params, tokens.clone(), tree_map(torch.clone, state),
                    next_tok.clone())


@dataclasses.dataclass
class _StaticShape:
    """One ``(batch, capacity)``'s static buffers: the token input (a
    view of ``next_tok``, so feeding a step's output back costs no
    copy), the state tree, the step's logits, and the cache entries
    filled, tracked on the host."""
    batch: int
    capacity: int
    next_tok: torch.Tensor               # [B] int32
    tokens: torch.Tensor                 # [B, 1] int32, views next_tok
    state: dict
    logits: torch.Tensor | None = None   # [B, 1, V] float32
    length: int = 0
    graph: "torch.cuda.CUDAGraph | None" = None


class StaticServeStep:
    """``make_serve_step``'s function over static buffers, one set per
    ``(batch, capacity)`` (:meth:`precompile`), run eagerly.

    ``step(params, tokens, state) -> (next_tok, state)`` returns the
    static token tensor and state tree: a caller that feeds them back in
    costs no copy, and one that keeps a token must copy it (the next
    step overwrites it). Another state tree is copied in first (and its
    ``len`` read once from the device); it picks the shape of its batch
    and K/V capacity. The step raises when called with another
    ``params`` tree than the one it was built over, and before a step
    that would write past ``capacity`` (the cache length is tracked on
    the host: prompt length plus steps taken; the reference's
    ``dynamic_update_slice`` would clamp the write instead).

    Each state leaf is allocated in the dtype ``decode_step`` returns
    for it under ``params`` (found once, by one step at batch 1 on
    scratch buffers): with the models' bf16 parameters these are
    ``init_decode_state``'s dtypes; with float32 parameters the
    recurrent leaves ``tm_x``/``cm_x`` (rwkv) and ``conv`` (mamba) are
    float32, as the plain step returns them. A state copied in is cast
    to those dtypes (bf16 into float32 is exact).
    """

    def __init__(self, cfg: ArchConfig, params,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self._shapes: dict[tuple[int, int], _StaticShape] = {}
        self._last: _StaticShape | None = None
        self._dtypes: dict | None = None

    @property
    def last_logits(self) -> torch.Tensor | None:
        """The logits of the step last run (a static buffer)."""
        return None if self._last is None else self._last.logits

    def precompile(self, batch: int, capacity: int) -> bool:
        """Allocate the shape's static buffers; False if it exists."""
        key = (int(batch), int(capacity))
        if key in self._shapes:
            return False
        next_tok = torch.zeros(key[0], dtype=torch.int32, device=self.device)
        state = tree_map(lambda a, d: a.to(d),
                         M.init_decode_state(self.cfg, key[0], key[1],
                                             self.device),
                         self._state_dtypes())
        shape = _StaticShape(*key, next_tok, next_tok.view(key[0], 1), state)
        self._prepare(shape)
        self._shapes[key] = shape
        return True

    def _state_dtypes(self) -> dict:
        """The dtype of each state leaf ``decode_step`` returns under
        ``self.params``: one step at batch 1 from a zero state."""
        if self._dtypes is None:
            with _build.on_device(self.device):
                probe = M.init_decode_state(self.cfg, 1, 1, self.device)
                tok = torch.zeros((1, 1), dtype=torch.int32,
                                  device=self.device)
                _, new = M.decode_step(self.params, self.cfg, tok, probe)
            self._dtypes = tree_map(lambda a: a.dtype, new)
        return self._dtypes

    def _prepare(self, shape: _StaticShape) -> None:
        """Make the shape runnable (the graphed step captures here)."""

    def _run(self, shape: _StaticShape) -> None:
        shape.logits = serve_step_into(self.cfg, self.params, shape.tokens,
                                       shape.state, shape.next_tok)

    def _shape_of(self, state: dict) -> _StaticShape:
        for shape in self._shapes.values():
            if shape.state is state:
                return shape
        if self.cfg.family == "hybrid":
            batch, capacity = state["k"].shape[1], state["k"].shape[2]
        else:                    # a recurrent state has no capacity axis
            batch, capacity = state["rwkv"]["tm_x"].shape[1], None
        hits = [s for (b, c), s in self._shapes.items()
                if b == batch and capacity in (None, c)]
        if len(hits) != 1:
            raise ValueError(
                f"{len(hits)} shapes prepared for a state of batch {batch}"
                f"{'' if capacity is None else f', K/V capacity {capacity}'}"
                f" (have {sorted(self._shapes)}); call precompile(batch, "
                f"capacity) once per shape, after the cache is grown")
        return hits[0]

    def __call__(self, params, tokens: torch.Tensor, state: dict):
        if params is not self.params:
            raise ValueError("this step was built over another params tree "
                             "(a graph reads the captured parameters' "
                             "addresses); build a step for these params")
        shape = self._shape_of(state)
        if tuple(tokens.shape) != (shape.batch, 1):
            raise ValueError(f"tokens shape {tuple(tokens.shape)} != "
                             f"({shape.batch}, 1)")
        if state is not shape.state:
            tree_map(lambda dst, src: dst.copy_(src), shape.state, state)
            shape.length = int(state["len"])
        if shape.length + 1 > shape.capacity:
            raise ValueError(
                f"decode past capacity: the cache holds {shape.length} of "
                f"{shape.capacity} entries; grow it and precompile its "
                f"capacity")
        if tokens.data_ptr() != shape.tokens.data_ptr():
            shape.tokens.copy_(tokens)
        self._run(shape)
        shape.length += 1
        self._last = shape
        return shape.next_tok, shape.state


class GraphedServeStep(StaticServeStep):
    """:class:`StaticServeStep` with each shape's step captured as ONE
    CUDA graph (the counterpart of the reference's jitted serve step with
    the state donated): :meth:`precompile` warms the step on scratch
    copies on a side stream, then captures :func:`serve_step_into` over
    the shape's static buffers; a call replays the graph. The graphs of
    one step share a memory pool. The card's only: built for the CPU it
    raises, and a capture that fails raises.
    """

    def __init__(self, cfg: ArchConfig, params,
                 device: str | torch.device | None = None):
        super().__init__(cfg, params, device)
        if self.device.type != "cuda":
            raise RuntimeError("the graphed serve step runs on the card; "
                               "on the CPU use make_serve_step")
        self._pool = torch.cuda.graph_pool_handle()

    def _prepare(self, shape: _StaticShape) -> None:
        dev = self.device
        with _build.on_device(dev):
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                warm_serve_step(self.cfg, self.params, shape.tokens,
                                shape.state, shape.next_tok)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                logits = serve_step_into(self.cfg, self.params, shape.tokens,
                                         shape.state, shape.next_tok)
        shape.graph, shape.logits = graph, logits

    def _run(self, shape: _StaticShape) -> None:
        with _build.on_device(self.device):
            shape.graph.replay()


def make_graphed_serve_step(cfg: ArchConfig, params,
                            device: str | torch.device | None = None
                            ) -> GraphedServeStep:
    """The serve step as one CUDA graph per ``(batch, capacity)``; call
    ``precompile(batch, capacity)`` for each shape (after the cache is
    grown), then use it as ``make_serve_step(cfg)``'s function."""
    return GraphedServeStep(cfg, params, device)
