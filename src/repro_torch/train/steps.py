"""train_step / prefill_step / serve_step builders; port of
``repro/train/steps.py``.

The reference builds pure functions for ``jit`` and enters its sharding
rules inside them; on one card there are no rules, and the port's steps
are plain functions. ``make_train_step`` takes ``rules=None`` only (the
sharding rules are ROADMAP Queue A item 9). Its step:

    for each microbatch (a Python loop when n_micro > 1):
        loss, grads += loss_and_grads(...)      # remat'd forward, autograd
    grads /= n_micro
    params, opt = adam_update(...)

The reference jits its train step with the parameters and optimizer
state donated; the port's step returns new trees (``adam_update`` is
functional), and the caller's rebinding frees the old ones.

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
from repro_torch.optimizer.adam import AdamConfig, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    weight_decay: float = 0.0
    n_micro: int = 1                  # gradient-accumulation microbatches
    accum_dtype: torch.dtype = torch.float32   # grad accumulator dtype
    quantized_opt_state: bool = False  # int8 Adam m/v
    remat: bool = True
    loss_chunk: int = 512             # chunked-xent sequence chunk


def _adam_cfg(hp: TrainHParams) -> AdamConfig:
    return AdamConfig(lr=hp.lr, weight_decay=hp.weight_decay,
                      quantized_state=hp.quantized_opt_state)


def init_opt_state(params, hp: TrainHParams):
    """Adam's state for ``params`` (``AdamState``; its moments mirror the
    parameter tree)."""
    return adam_init(params, _adam_cfg(hp))


def loss_and_grads(params, cfg: ArchConfig, batch: dict,
                   hp: TrainHParams) -> tuple:
    """One forward and backward of ``models.model.loss_fn``: (loss,
    metrics, grads), detached; ``grads`` mirrors ``params``, each leaf
    in its parameter's dtype (zeros for a leaf the loss does not read,
    as ``jax.grad`` gives)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat: list = []
    tree_map(flat.append, leaves)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(leaves, cfg, batch, remat=hp.remat,
                                  loss_chunk=hp.loss_chunk)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                         materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def _split(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B / n_micro, ...]; positions [3, B, S]
    carry the batch on dim 1 (the reference's rule, as it stands)."""
    if x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] % n_micro == 0 \
            and x.shape[0] != x.shape[1]:
        return x.reshape(3, n_micro, -1, *x.shape[2:]).transpose(0, 1)
    return x.reshape(n_micro, -1, *x.shape[1:])


def make_train_step(cfg: ArchConfig, rules, hp: TrainHParams):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), metrics {"loss", "ce", "aux"} (0-d float32 tensors).

    ``batch``: {"tokens", "labels", optional "positions"} with a leading
    batch dim divisible by ``hp.n_micro``. With ``n_micro > 1`` the
    microbatches' gradients are summed in ``hp.accum_dtype`` and divided
    by ``n_micro``; the loss and every metric are their means. ``rules``
    must be None.
    """
    if rules is not None:
        raise NotImplementedError("sharding rules are not ported yet; see "
                                  "ROADMAP Queue A item 9")
    opt_cfg = _adam_cfg(hp)

    def train_step(params, opt_state, batch):
        if hp.n_micro == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, hp)
        else:
            micro = {k: _split(v, hp.n_micro) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=hp.accum_dtype, device=p.device), params)
            losses, seen = [], []
            for i in range(hp.n_micro):
                mb = {k: v[i] for k, v in micro.items()}
                l, metrics, g = loss_and_grads(params, cfg, mb, hp)
                tree_map(lambda a, b: a.add_(b.to(hp.accum_dtype)), grads, g)
                losses.append(l)
                seen.append(metrics)
            tree_map(lambda g: g.div_(hp.n_micro), grads)
            loss = sum(losses) / hp.n_micro          # in order, as a scan
            metrics = {k: torch.stack([m[k] for m in seen]).mean()
                       for k in seen[0]}
        params, opt_state = adam_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, kernels: bool = True):
    """prefill_step(params, batch) -> (last-token logits, decode state).

    ``batch``: {"tokens" [B, S] ([B, S, K] codebook ids), optional
    "positions" ([3, B, S] for M-RoPE)}. On the card the recurrences run
    through the CUDA kernels unless ``kernels`` is False.
    """
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch["tokens"],
                         positions=batch.get("positions"), kernels=kernels)
    return prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy next token of the last position: [B] int32 ([B, K]
    from [B, S, K, V] codebook logits, each codebook's own argmax)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_serve_step(cfg: ArchConfig, unroll: bool = False):
    """serve_step(params, tokens, state) -> (next token ids, new state).

    One decode step for the whole request batch: the greedy next token
    (int32 [B]; [B, K] for K codebooks, fed back as [B, 1, K]). The
    positions are the model's default, which for M-RoPE are the three
    streams at ``state["len"]``, read on the device (the reference's
    serve step builds the same). A ``hybrid`` or transformer state's
    caches are updated in place, as the reference's caller donates the
    state to its jitted step.
    ``unroll``: a transformer state's caches come back as per-layer
    lists (``init_decode_state(unrolled=True)``; the reference's
    unrolled decode).
    """
    def serve_step(params, tokens, state):
        logits, new_state = M.decode_step(params, cfg, tokens, state,
                                          unroll=unroll)
        return greedy(logits), new_state
    return serve_step


def serve_step_into(cfg: ArchConfig, params, tokens: torch.Tensor,
                    state: dict, next_tok: torch.Tensor) -> torch.Tensor:
    """One decode step written back into its buffers: what a graphed
    step captures.

    Reads ``tokens`` [B, 1] int32 ([B, 1, K]) and ``state``; copies the
    new recurrent leaves and ``len`` back into ``state`` (``decode_step``
    returns new tensors for them; a ``hybrid`` or transformer state's
    caches are written in place by the step itself) and the greedy token
    into ``next_tok`` [B] ([B, K]) int32, which ``tokens`` may view.
    Returns the step's logits [B, 1, V] ([B, 1, K, V]). Nothing here
    reads the card from the host. A transformer state keeps its layout,
    stacked or per-layer lists.
    """
    logits, new_state = M.decode_step(params, cfg, tokens, state)
    tree_map(lambda dst, src: dst if dst is src else dst.copy_(src),
             state, new_state)
    next_tok.copy_(greedy(logits))
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
    next_tok: torch.Tensor               # [B] ([B, K]) int32
    tokens: torch.Tensor                 # [B, 1] ([B, 1, K]), views next_tok
    state: dict
    logits: torch.Tensor | None = None   # [B, 1, V] ([B, 1, K, V]) float32
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

    ``unroll``: the step of ``make_serve_step(cfg, unroll=True)``, a
    transformer's static state allocated as per-layer cache lists.
    With K codebooks the tokens are [B, 1, K] and the step's output
    [B, K].
    """

    def __init__(self, cfg: ArchConfig, params,
                 device: str | torch.device | None = None,
                 unroll: bool = False):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.unroll = unroll
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
        tok_shape = self._token_shape(key[0])
        next_tok = torch.zeros((tok_shape[0], *tok_shape[2:]),
                               dtype=torch.int32, device=self.device)
        state = tree_map(lambda a, d: a.to(d),
                         M.init_decode_state(self.cfg, key[0], key[1],
                                             self.device, self.unroll),
                         self._state_dtypes())
        shape = _StaticShape(*key, next_tok, next_tok.view(tok_shape), state)
        self._prepare(shape)
        self._shapes[key] = shape
        return True

    def _state_dtypes(self) -> dict:
        """The dtype of each state leaf ``decode_step`` returns under
        ``self.params``: one step at batch 1 from a zero state."""
        if self._dtypes is None:
            with _build.on_device(self.device):
                probe = M.init_decode_state(self.cfg, 1, 1, self.device,
                                            self.unroll)
                tok = torch.zeros(self._token_shape(1), dtype=torch.int32,
                                  device=self.device)
                _, new = M.decode_step(self.params, self.cfg, tok, probe)
            self._dtypes = tree_map(lambda a: a.dtype, new)
        return self._dtypes

    def _token_shape(self, batch: int) -> tuple:
        """A step's input tokens: [B, 1], or [B, 1, K] for K codebooks."""
        k = self.cfg.n_codebooks
        return (batch, 1, k) if k else (batch, 1)

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
        elif self.cfg.family == "ssm":   # a recurrent state has no capacity
            batch, capacity = state["rwkv"]["tm_x"].shape[1], None
        else:          # {"k", "v"} or MLA's {"latent", "krope"} per part
            c = next(iter(state["main"].values()))   # [L, B, C, ...] or
            batch, capacity = (c[0].shape[:2] if isinstance(c, list)  # L x
                               else c.shape[1:3])                     # [B, C]
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
        if tuple(tokens.shape) != self._token_shape(shape.batch):
            raise ValueError(f"tokens shape {tuple(tokens.shape)} != "
                             f"{self._token_shape(shape.batch)}")
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
                 device: str | torch.device | None = None,
                 unroll: bool = False):
        super().__init__(cfg, params, device, unroll)
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
            with _build.gc_paused(), torch.cuda.graph(graph,
                                                      pool=self._pool):
                logits = serve_step_into(self.cfg, self.params, shape.tokens,
                                         shape.state, shape.next_tok)
        shape.graph, shape.logits = graph, logits

    def _run(self, shape: _StaticShape) -> None:
        with _build.on_device(self.device):
            shape.graph.replay()


def make_graphed_serve_step(cfg: ArchConfig, params,
                            device: str | torch.device | None = None,
                            unroll: bool = False) -> GraphedServeStep:
    """The serve step as one CUDA graph per ``(batch, capacity)``; call
    ``precompile(batch, capacity)`` for each shape (after the cache is
    grown), then use it as ``make_serve_step(cfg, unroll)``'s function."""
    return GraphedServeStep(cfg, params, device, unroll)
