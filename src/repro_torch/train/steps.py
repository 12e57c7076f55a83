"""train_step / prefill_step / serve_step builders; port of
``repro/train/steps.py``.

The reference builds pure functions for ``jit`` and enters its sharding
rules (``mesh_rules``) inside them; the port's steps are plain functions
that enter the same context. Without rules a train step is:

    for each microbatch (a Python loop when n_micro > 1):
        loss, grads += loss_and_grads(...)      # remat'd forward, autograd
    grads /= n_micro
    params, opt = adam_update(...)

With ``rules`` (a :class:`~repro_torch.distributed.sharding.MeshRules`
on a ``DeviceMesh``; :func:`make_train_step`) every parameter and Adam
leaf is a DTensor held with the rules' placements (``param_pspec``; the
moments as ``launch/specs.py``'s ``_opt_shardings`` lays them out), and
the batch is split over the ``batch`` axis (``input_shardings``). The
model gets the placed DTensor tree and computes each rank's batch shard
in shards (``distributed/tensor_parallel.py``): each layer gathers its
own leaves where it runs, over the ``fsdp`` / ``batch`` axes only
(ZeRO-3, gathered again in the backward); GQA and MLA attention, the
MLPs and the Mamba-2 and RWKV-6 layers run tensor-parallel over the
``tensor`` axis on their heads (column- then row-parallel, the partial
sums reduced: the paper's ME tree), the MoE expert-parallel over the
``expert`` axis (each rank its own experts' slots: the MC tree; where
that axis includes a batch axis, ``tp_ep_full``'s, the tokens move to
the experts' owners by all-to-all and no expert is gathered), the
embedding, head and loss over the vocabulary (the codebook heads too,
and the codebook embeddings over their codebooks where the axis divides
them). Where the rules put
``seq`` on an axis of its own (the multi-pod ``fsdp`` profile's
``pod``), each rank also takes its contiguous segment of every sequence
(:func:`batch_shard`) and computes only that: attention over the K/V
gathered from the segments before it, the recurrences' carried states
and token shifts from them (``Plan.seq``). The gathers' backward
reduce-scatters each gradient onto its leaf's placements, summed over
the batch shards and the segments. Where the rules put ``seq`` on the
tensor axis itself (the dry run's ``--seq-shard``), the train and
prefill steps give each rank of the tensor group its segment of every
sequence (``Plan.sp``): sequence parallelism around each tensor-parallel
region, the segment alone elsewhere, and the loss the whole sequences'
on every rank of the group. Adam then updates the local blocks,
and each new block goes to its parameter's placements. Layers whose
heads the axis does not divide are gathered per layer and computed
whole. The ruled prefill and serve steps compute the same way on each
rank's shard of the request batch, MLA's latent cache and a GQA cache
whose K/V heads do not split held on their capacity rows (the
split-capacity decode); the logits and tokens are gathered.

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
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.tensor_parallel import local_block as _local
from repro_torch.distributed.sharding import (AbstractMesh, BatchSplit,
                                              MeshRules, NamedSharding,
                                              _axis_size, _is_dtensor, _names,
                                              batch_split, flat_tree,
                                              gather_tree, input_shardings,
                                              mesh_rules, param_shardings,
                                              tree_map, tree_map_with_path)
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.optimizer.adam import (AdamConfig, AdamState, adam_init,
                                        adam_leaf, adam_update,
                                        bias_corrections, blocked_shape)


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
    leaves = tree_map(lambda t: _with_local(t, _local(t).detach())
                      .requires_grad_(), params)
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


def _with_local(like: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as a DTensor with ``like``'s placements where ``like``
    is one, else ``local``."""
    if not _is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def _accumulate(params, cfg: ArchConfig, batch: dict, hp: TrainHParams,
                local=lambda b: b) -> tuple:
    """(loss, metrics, grads) over ``hp.n_micro`` microbatches of
    ``batch``: the gradients summed in ``hp.accum_dtype`` and divided by
    ``n_micro``, the loss and every metric their means. ``local`` maps
    each (micro)batch to what this rank computes. DTensor leaves are
    summed through their local blocks: DTensor's sharding propagation
    would build a tensor of the global shape per op (a 36 GiB meta
    tensor per expert leaf of qwen3-moe-30b-a3b in the dry run)."""
    if hp.n_micro == 1:
        return loss_and_grads(params, cfg, local(batch), hp)
    micro = {k: _split(v, hp.n_micro) for k, v in batch.items()}
    grads = tree_map(lambda p: _with_local(p, torch.zeros_like(
        _local(p), dtype=hp.accum_dtype)), params)
    losses, seen = [], []
    for i in range(hp.n_micro):
        l, metrics, g = loss_and_grads(
            params, cfg, local({k: v[i] for k, v in micro.items()}), hp)
        tree_map(lambda a, b: _local(a).add_(_local(b).to(hp.accum_dtype)),
                 grads, g)
        losses.append(l)
        seen.append(metrics)
    tree_map(lambda g: _local(g).div_(hp.n_micro), grads)
    loss = sum(losses) / hp.n_micro              # in order, as a scan
    metrics = {k: torch.stack([m[k] for m in seen]).mean()
               for k in seen[0]}
    return loss, metrics, grads


def make_train_step(cfg: ArchConfig, rules, hp: TrainHParams):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), metrics {"loss", "ce", "aux"} (0-d float32 tensors).

    ``batch``: {"tokens", "labels", optional "positions"} with a leading
    batch dim divisible by ``hp.n_micro``. With ``n_micro > 1`` the
    microbatches' gradients are summed in ``hp.accum_dtype`` and divided
    by ``n_micro``; the loss and every metric are their means.

    ``rules``: None, or a ``MeshRules`` on a ``DeviceMesh`` (every rank
    of the mesh calls the step with the same arguments): the step of
    :func:`_ruled_train_step`.
    """
    if rules is not None:
        return _ruled_train_step(cfg, rules, hp)
    opt_cfg = _adam_cfg(hp)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _accumulate(params, cfg, batch, hp)
        params, opt_state = adam_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def opt_state_shardings(opt_shapes: AdamState, param_shapes,
                        rules: MeshRules) -> AdamState:
    """Adam m/v mirror the param shardings. int8-quantized moments are
    [..., F/B, B] (last-axis block split, optimizer/adam.py), so their
    spec = the param's leading-dim spec + (None, None), with the axis of
    the param's last dim re-homed onto the first leading dim that stays
    divisible; float32 fallbacks and same-shape moments reuse the param
    spec; [0]-sentinel scales and the step counter are replicated (the
    reference's ``launch/specs.py::_opt_shardings``)."""
    psh = param_shardings(param_shapes, rules)

    def one(_, leaf, p_leaf, p_sh):
        shape, p_shape = tuple(leaf.shape), tuple(p_leaf.shape)
        if shape == p_shape:                           # f32 moment
            return p_sh
        if len(shape) == len(p_shape) + 1:
            r = len(p_shape)
            spec = list(p_sh.spec) + [None] * (r - len(p_sh.spec))
            dropped = spec[r - 1]                      # axis on the block dim
            spec = spec[:r - 1] + [None, None]
            if dropped is not None:
                # re-home the dropped axis: merge into the first leading
                # dim that stays divisible
                for i in range(len(spec)):
                    cur = spec[i]
                    cand = ((tuple(cur) if isinstance(cur, tuple)
                             else (cur,)) if cur else ()) + \
                        (tuple(dropped) if isinstance(dropped, tuple)
                         else (dropped,))
                    if shape[i] % (_axis_size(rules.mesh, cur)
                                   * _axis_size(rules.mesh, dropped)) == 0:
                        spec[i] = cand if len(cand) > 1 else cand[0]
                        break
            return NamedSharding(rules.mesh, tuple(spec))
        return NamedSharding(rules.mesh, ())           # sentinel / scalar

    def follow(tree):
        return tree_map_with_path(one, tree, param_shapes, psh)

    return AdamState(NamedSharding(rules.mesh, ()),
                     follow(opt_shapes.m), follow(opt_shapes.v),
                     follow(opt_shapes.m_scale), follow(opt_shapes.v_scale))


def _place(x, mesh, pl: list):
    """``x`` as a DTensor with placements ``pl``: a plain tensor (the
    same global value on every rank) keeps this rank's block; a DTensor
    is redistributed (nothing moves when it is placed already)."""
    from torch.distributed.tensor import distribute_tensor
    if _is_dtensor(x):
        return x if list(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def place_params(params, rules: MeshRules):
    """``params`` with every tensor leaf a DTensor with ``param_pspec``'s
    placements on ``rules.mesh`` (see :func:`place_train_state`)."""
    psh = param_shardings(params, rules)
    return tree_map_with_path(
        lambda _, x, sh: _place(x, rules.mesh, sh.placements), params, psh)


def _in_view(x, view: tuple, pl: list) -> torch.Tensor:
    """This rank's block of DTensor ``x`` reshaped to ``view`` (an int8
    moment's block view [..., F / B, B] of a [..., F] leaf, or its own
    shape) under placements ``pl`` of the view; the last dim is gathered
    first where the view splits it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    if tuple(x.shape) != tuple(view):
        whole = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
                 else p for p in x.placements]
        loc = _place(x, mesh, whole).to_local()
        x = DTensor.from_local(loc.reshape(*loc.shape[:-1], *view[-2:]),
                               mesh, whole, run_check=False)
    return _place(x, mesh, pl).to_local()


def place_train_state(params, opt_state: AdamState, rules: MeshRules
                      ) -> tuple:
    """(params, opt_state) with every tensor leaf a DTensor on
    ``rules.mesh``: parameters with ``param_pspec``'s placements, Adam's
    moments with :func:`opt_state_shardings`' (the ruled step's layout).
    A plain leaf (the same global value on every rank) keeps this rank's
    block; a DTensor is redistributed where its placements differ. The
    ruled step does this on every call (a no-op once placed); a caller
    that places first can free its plain trees before the step."""
    mesh = rules.mesh
    osh = opt_state_shardings(opt_state, params, rules)

    def place(_, x, sh):
        return x if isinstance(x, int) else _place(x, mesh, sh.placements)
    return (place_params(params, rules),
            AdamState(opt_state.step, *(tree_map_with_path(place, t, ts)
                                        for t, ts in zip(opt_state[1:],
                                                         osh[1:]))))


def batch_shard(batch: dict, rules: MeshRules, cfg=None,
                prefill: bool = False) -> tuple:
    """(this rank's shard of a global ``batch``, the
    :class:`~repro_torch.distributed.sharding.BatchSplit` that cut it):
    every leaf split over the ``batch`` axis as ``input_shardings`` lays
    it out (``positions`` on dim 1), as the reference's GSPMD program
    splits it; a batch the axis does not divide stays whole on every
    rank (a split of one shard). With a train step's ``cfg``, each
    sequence is cut as well where the rules split it
    (``tensor_parallel.seq_dim``, the ``seq`` axis): this rank's
    contiguous segment of ``tokens`` and ``labels`` (dim 1) and of
    ``positions`` (its last dim: M-RoPE's [3, B, S] on dim 2). With
    ``prefill``, a prefill step's: cut only over the tensor axis
    (``Plan.sp``)."""
    mesh = rules.mesh
    sh = input_shardings(batch, rules, batch_axes={"positions": 1})
    dims = tuple(n for n in mesh.mesh_dim_names
                 if n in _names(sh["tokens"].spec[0]))
    mine = {k: _place(v, mesh, sh[k].placements).to_local()
            for k, v in batch.items()}
    s = batch["tokens"].shape[1]
    seq = None if cfg is None else TP.seq_dim(cfg, rules, dims, s)
    if prefill and seq is not None and not TP.on_tensor(rules, seq):
        seq = None
    if seq is None:
        return mine, BatchSplit(mesh, dims)
    split = BatchSplit(mesh, dims, (seq,), s // _axis_size(mesh, seq))
    return ({k: v.narrow(v.ndim - 1 if k == "positions" else 1,
                         split.offset, split.segment)
             for k, v in mine.items()}, split)


def ruled_loss_and_grads(params, cfg: ArchConfig, batch: dict,
                         hp: TrainHParams, rules: MeshRules) -> tuple:
    """The ruled step's (loss, metrics, grads) before Adam: ``params``
    placed (DTensors), ``batch`` global; the loss and metrics the whole
    batch's means on every rank, each gradient a DTensor on its
    parameter's placements: the whole batch's (see
    :func:`_ruled_train_step`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = rules.mesh
    batch = gather_tree(batch)
    first = batch if hp.n_micro == 1 else \
        {k: _split(v, hp.n_micro)[0] for k, v in batch.items()}
    split = batch_shard(first, rules, cfg)[1]
    with mesh_rules(rules), batch_split(split):
        loss, metrics, grads = _accumulate(
            params, cfg, batch, hp, lambda b: batch_shard(b, rules, cfg)[0])
    # a shard's loss is its own tokens' mean, and the shards (batch rows
    # times sequence segments) are equal; segments over the tensor axis
    # (Plan.sp) each hold the whole sequences' loss, and their gradients'
    # shares sum to the whole sequences' already
    seq = tuple(d for d in split.seq_dims if not TP.on_tensor(rules, d))
    summed = split.dims + seq
    n = split.n * (split.seq_n if seq else 1)
    part = [Partial() if d in summed else Replicate()
            for d in mesh.mesh_dim_names]

    def mean(t):
        return DTensor.from_local(t, mesh, part).full_tensor() / n
    tree_map(lambda g: _local(g).div_(n), grads)
    return mean(loss), {k: mean(v) for k, v in metrics.items()}, grads


def _adam_blocks(p, g, m, v, ms=None, vs=None, bc1=None, bc2=None,
                 opt_cfg: AdamConfig = None) -> list:
    """Adam on one leaf's DTensors (parameter, gradient, moments, and an
    int8 leaf's scales, each on its own placements): the new ones, on the
    same placements. Adam runs on the moments' layout (an int8 moment's
    in its block view, with its block dim whole), elementwise on the
    local blocks (``adam_leaf``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, quantized = p.device_mesh, ms is not None
    view = (blocked_shape(p.shape, opt_cfg.block) if quantized
            else tuple(p.shape))
    pl = [Replicate() if quantized and isinstance(x, Shard)
          and x.dim == len(view) - 1 else x for x in m.placements]
    out = adam_leaf(_in_view(p, view, pl), _in_view(g, view, pl),
                    *(_place(x, mesh, pl).to_local() for x in (m, v)),
                    *(x if x is None else _place(x, mesh, pl).to_local()
                      for x in (ms, vs)),
                    bc1, bc2, opt_cfg, quantized)

    def put(o, like):                # a local block of Adam's layout
        return _place(DTensor.from_local(o, mesh, pl), mesh, like.placements)
    p_new = out[0].reshape(*out[0].shape[:-2], -1) if quantized else out[0]
    return [put(p_new, p), put(out[1], m), put(out[2], m)] + (
        [put(out[3], ms), put(out[4], ms)] if quantized else [])


def _unstack_blocks(x) -> list:
    """A DTensor's per-index DTensors along its unsharded dim 0 (views of
    its local block)."""
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(q.dim - 1) if isinstance(q, Shard) else q
          for q in x.placements]
    return [DTensor.from_local(t, x.device_mesh, pl, run_check=False)
            for t in x.to_local().unbind(0)]


def _stack_blocks(xs) -> torch.Tensor:
    """:func:`_unstack_blocks` undone: one DTensor of the stacked blocks."""
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(q.dim + 1) if isinstance(q, Shard) else q
          for q in xs[0].placements]
    return DTensor.from_local(torch.stack([x.to_local() for x in xs]),
                              xs[0].device_mesh, pl, run_check=False)


def ruled_adam_leaf(p, g, m, v, ms, vs, bc1, bc2, opt_cfg: AdamConfig
                    ) -> list:
    """Adam on one placed leaf of the ruled step (its parameter,
    gradient, moments and int8 scales, DTensors on their placements):
    [p, m, v, m_scale, v_scale], new, on the same placements. A stacked
    int8 leaf is updated one layer at a time: where its moments split
    the expert dim over two axes, DTensor would move a block between the
    layouts by gathering it whole (deepseek-v3's w_down: 406 GiB a rank
    for the stack)."""
    from torch.distributed.tensor import Shard
    quantized = opt_cfg.quantized_state and ms.numel() > 0
    leaf = [p, g, m, v] + ([ms, vs] if quantized else [])
    if quantized and p.ndim >= 3 and not any(
            isinstance(x, Shard) and x.dim == 0
            for t in leaf for x in t.placements):
        new = [_stack_blocks(o) for o in zip(*(
            _adam_blocks(*xs, bc1=bc1, bc2=bc2, opt_cfg=opt_cfg)
            for xs in zip(*map(_unstack_blocks, leaf))))]
    else:
        new = _adam_blocks(*leaf, bc1=bc1, bc2=bc2, opt_cfg=opt_cfg)
    return new if quantized else new + [ms, vs]


def _ruled_train_step(cfg: ArchConfig, rules: MeshRules, hp: TrainHParams):
    """The train step on a mesh. Every rank of ``rules.mesh`` calls it
    with the same global ``batch`` (plain tensors, or DTensors) and the
    same trees; plain parameter and Adam leaves are placed on the first
    call, DTensors of other placements are redistributed. Returns
    (params, opt_state) with DTensor leaves (the step an ``int``) and
    the metrics, the whole batch's means, on every rank.

    Each microbatch is split over the ``batch`` axis, and each sequence
    over the ``seq`` axis where the rules split it (:func:`batch_shard`).
    Each rank runs :func:`loss_and_grads` on its shard with the placed
    parameters, under ``mesh_rules`` and a
    :class:`~repro_torch.distributed.sharding.BatchSplit`: the model
    gathers each layer's leaves where it runs and computes the tensor-
    and expert-parallel layers in shards (``distributed/
    tensor_parallel.py``), and the MoE layer routes the whole batch's
    groups. The loss and metrics are the means over the shards (a
    shard's loss is its own tokens' mean, and the shards, batch rows by
    sequence segments, are equal). The gradients arrive on the
    parameters' placements, summed over the shards (the gathers'
    backward); divided by the shards' number, they
    go to the moments' placements (an int8 moment's in its block view,
    with its block dim whole), where Adam updates the local blocks
    elementwise (``adam_leaf``); each new parameter block then goes to
    its parameter's placements. On a one-rank mesh this is the plain
    step, bit for bit.
    """
    if isinstance(rules.mesh, AbstractMesh):
        raise ValueError("a ruled train step runs on a DeviceMesh; an "
                         "AbstractMesh only lays out specs")
    opt_cfg = _adam_cfg(hp)
    q = opt_cfg.quantized_state

    def train_step(params, opt_state, batch):
        params, opt_state = place_train_state(params, opt_state, rules)
        state = [flat_tree(t) for t in opt_state[1:]]
        loss, metrics, grads = ruled_loss_and_grads(params, cfg, batch, hp,
                                                    rules)
        grads = flat_tree(grads)
        bc1, bc2 = bias_corrections(opt_state.step, opt_cfg)

        def update(k, p):
            m, v, ms, vs = (st.get(k) for st in state)
            # the gradient is freed here
            return ruled_adam_leaf(p, grads.pop(k), m, v, ms, vs, bc1, bc2,
                                   opt_cfg)

        new = {k: update(k, p) for k, p in flat_tree(params).items()}

        def pick(i):
            return tree_map_with_path(lambda k, _: new[k][i], params)

        new_state = AdamState(opt_state.step + 1, pick(1), pick(2),
                              *((pick(3), pick(4)) if q else ()))
        return pick(0), new_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, rules: MeshRules | None = None, *,
                      kernels: bool = True):
    """prefill_step(params, batch) -> (last-token logits, decode state).

    ``batch``: {"tokens" [B, S] ([B, S, K] codebook ids), optional
    "positions" ([3, B, S] for M-RoPE)}. On the card the recurrences run
    through the CUDA kernels unless ``kernels`` is False.

    ``rules``: a ``MeshRules`` on a ``DeviceMesh``; every rank calls the
    step with the same global batch and parameters (plain leaves are
    placed first, keeping this rank's blocks). Each rank prefills its own
    shard of the batch (:func:`batch_shard`) under ``mesh_rules`` and the
    shard's ``batch_split``, computing each layer in shards as the ruled
    train step does (where the rules put ``seq`` on the tensor axis,
    each rank its segment of every prompt, ``tensor_parallel.Plan.sp``),
    and the logits are gathered (the vocabulary, then the rows): the
    whole batch's, on every rank. The decode state is this
    rank's: its batch shard, its K/V heads where attention splits them
    (else its capacity rows of every K/V head), its capacity rows of
    MLA's latent and RoPE key, and its recurrent heads; for
    :func:`make_serve_step` with the same rules.
    """
    def prefill_step(params, batch):
        if rules is None:
            return M.prefill(params, cfg, batch["tokens"],
                             positions=batch.get("positions"),
                             kernels=kernels)
        mine, split = batch_shard(gather_tree(batch), rules, cfg,
                                  prefill=True)
        with mesh_rules(rules), batch_split(split):
            logits, state = M.prefill(place_params(params, rules), cfg,
                                      mine["tokens"],
                                      positions=mine.get("positions"),
                                      kernels=kernels)
            group = _vocab_group(cfg)
            if group is not None:
                logits = TP.vocab_gather(logits, group)
        return _gather_rows(logits, split), state
    return prefill_step


def _vocab_group(cfg: ArchConfig):
    """The group the ruled steps split ``cfg``'s vocabulary over (under
    the active rules and batch split), or None."""
    plan = TP.plan_for(cfg)
    return plan.tp if plan.vocab else None


def _gather_rows(x: torch.Tensor, split: BatchSplit) -> torch.Tensor:
    """The shards' rows of ``x`` concatenated (dim 0), on every rank."""
    return split.gather(x) if split.n > 1 else x


def greedy(logits: torch.Tensor, group=None) -> torch.Tensor:
    """The greedy next token of the last position: [B] int32 ([B, K]
    from [B, S, K, V] codebook logits, each codebook's own argmax).
    ``group``: the logits are this rank's vocabulary shard of a split
    over it ([B, S, V / n] or [B, S, K, V / n]), and the argmax is taken
    across the shards, per codebook (ties to the lowest global index, as
    ``torch.argmax``'s)."""
    if group is not None:
        return TP.vocab_argmax(logits[:, -1], group).to(torch.int32)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_serve_step(cfg: ArchConfig, rules: MeshRules | None = None,
                    unroll: bool = False):
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
    ``rules``: as :func:`make_prefill_step`'s. ``tokens`` is the whole
    batch's and ``state`` this rank's (the ruled prefill's); the rank
    decodes its shard in shards, and the next tokens are gathered.
    """
    def serve_step(params, tokens, state):
        if rules is None:
            logits, new_state = M.decode_step(params, cfg, tokens, state,
                                              unroll=unroll)
            return greedy(logits), new_state
        mine, split = batch_shard({"tokens": gather_tree(tokens)}, rules)
        with mesh_rules(rules), batch_split(split):
            logits, new_state = M.decode_step(place_params(params, rules),
                                              cfg, mine["tokens"], state,
                                              unroll=unroll)
            tok = greedy(logits, _vocab_group(cfg))
        return _gather_rows(tok, split), new_state
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

    ``unroll``: the step of ``make_serve_step(cfg, None, True)``, a
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
    grown), then use it as ``make_serve_step(cfg, None, unroll)``'s
    function."""
    return GraphedServeStep(cfg, params, device, unroll)
