"""Mixture-of-Experts layer; port of ``repro/models/moe.py``.

The reference computes GShard's dense dispatch: one-hot ``dispatch`` and
``combine`` tensors [G, T_g, E, C] per group of T_g tokens, contracted
with einsums, the idiomatic TPU form (no gather, no scatter). Its
combine alone is 2 T_g E C D float32 operations per group: at qwen3-moe's
full width (T_g = 2048, E = 128, C = 160, D = 2048) 1.7e11 per group and
layer, seconds on the card. The port computes the same function as a
gather and a scatter of rows:

* the routes, the capacity and each (token, slot)'s position in its
  expert's buffer are the reference's: top-k of the float32 router
  logits, positions by a cumulative sum over the one-hot [G, T_g * k, E]
  (token-major, then the k slots), entries past the capacity dropped;
* the kept entries' token rows are gathered into the expert buffers
  [E, G * C, D] (each slot holds at most one token, so this equals the
  reference's dispatch einsum bit for bit; empty slots are 0);
* the three expert products are ``torch.bmm`` over E (cuBLAS: a plain
  product, not a Pallas kernel of the reference);
* the combine gathers each kept entry's output row and sums ``w_j *
  out_j`` over the k slots in float32, then rounds once to the input's
  dtype: the reference's sum without its zero terms, in another order.

The gathers are :class:`_RowGather`, whose backward is a gather too: no
atomic adds, so a step gives the same bits every time, and no host
sync, so the decode step can be captured as a CUDA graph.

Expert-parallel (``ep``, the ruled steps' ``expert`` group; see
``distributed/tensor_parallel.py``): the tokens are replicated over the
group, so every rank routes them all (the same routes, capacity and
aux); each holds E / n experts and gathers the rows of its own experts'
slots only (the MC tree), runs their products, weights and sums its own
routes' outputs into a partial float32 ``y``, and ``y`` is summed over
the group before the one rounding (the ME tree). Under ``tp_ep`` no
all-to-all, as in the reference's compiled program under those rules.

Under ``tp_ep_full`` the experts are split over ``("model", "data")``:
each card owns E / (n_data n_model) whole experts, and the tokens move
to them over ``data`` (``a2a``, the exchange group; the reference's
"capacity-bounded all_to_all over the EP axis"). No expert weight is
gathered. The routes, capacity, positions, drops and aux stay the ones
above, in two forms:

* (a) each routing group lies within one data shard (``train_4k``,
  ``prefill_32k``): this rank routes its own groups (replicated over
  ``model``) and fills fixed-size buffers [n_data, E_loc, G * C, D]
  with the slots of the experts its ``model`` column's ranks hold,
  laid out by the owner's ``data`` index (dropped and empty slots are
  zero rows, so every rank's splits are equal: no host sync); an
  all-to-all over ``data``; the three products over this rank's E_loc
  experts on every source's slots; the reverse all-to-all; the combine
  and its float32 sum over the k slots; the sum over ``model``; one
  rounding;
* (b) a routing group spans the data shards (``decode_32k``): the
  tokens are gathered over the batch split (activations, not weights),
  this rank runs its own experts' slots of the whole batch, and the
  float32 partial output is reduce-scattered over ``data`` onto each
  rank's rows (its own pod's, on the multi-pod mesh) and summed over
  ``model``.

Under sequence parallelism over the tensor group (``sp``,
``tensor_parallel.Plan.sp``; ``expert`` and ``tensor`` share the axis)
each rank holds its segment of every sequence: the segments are gathered
before routing (``seq_whole``, the backward a reduce-scatter), so the
routing groups, capacity and aux are the ones above, and the layer's
float32 partial output is reduce-scattered onto the segment
(``scatter_to``) in place of the sum over ``ep``, then rounded once.
The expert buffers' ``copy_to`` is dropped: the gather's backward sums
each rank's share. With experts replicated (no ``ep``) every rank runs
the gathered tokens whole and keeps its segment. The aux loss is then
the whole batch's on every rank (``model.loss_fn`` counts it once).

Under a train step's sequence split over an axis of its own (``seq``,
``tensor_parallel.Plan.seq``: the multi-pod ``fsdp`` rules' ``pod``)
each rank holds its segment of every sequence of its batch rows, and the
routing groups stay the reference's, T_g tokens of the whole batch's
flattened [B * S]:

* (a) each group lies within one segment of one sequence (the segment a
  multiple of T_g; ``train_4k``'s 2,048-token segments): this rank
  routes its own groups, no collective in the layer; each expert's
  share of the routes is counted over every rank's groups, batch shards
  and segments (``BatchSplit.tokens``), and the aux is this rank's term
  of the batch's;
* (b) a group spans segments: the segments are gathered (``seq_whole``,
  the backward a reduce-scatter), every rank runs its batch rows' whole
  groups as above and keeps its segment's rows of the output.

The ruled step averages the loss over batch shards times segments, so
each rank's aux counts as it is: in (a) the ranks' terms average to the
batch's aux, in (b) every segment of a batch shard holds that shard's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import BatchSplit, current_split
from repro_torch.distributed.tensor_parallel import (Group, all_to_all,
                                                     copy_to, expert_coords,
                                                     narrow_seq, reduce_from,
                                                     scatter_sum, scatter_to,
                                                     seq_whole)
from repro_torch.models.layers import Params, _dense_init, dot, mlp


def init_moe(cfg: ArchConfig, gen: Optional[torch.Generator],
             device: torch.device) -> Params:
    mo, d = cfg.moe, cfg.d_model
    p = {
        "router": _dense_init(gen, (d, mo.n_experts), device,
                              dtype=torch.float32),
        # stacked expert weights [E, d, d_ff]
        "w_gate": _dense_init(gen, (mo.n_experts, d, mo.d_ff_expert), device),
        "w_up": _dense_init(gen, (mo.n_experts, d, mo.d_ff_expert), device),
        "w_down": _dense_init(gen, (mo.n_experts, mo.d_ff_expert, d), device),
    }
    if mo.n_shared_experts:
        dff_sh = mo.d_ff_shared * mo.n_shared_experts
        p["shared"] = {"w_gate": _dense_init(gen, (d, dff_sh), device),
                       "w_up": _dense_init(gen, (d, dff_sh), device),
                       "w_down": _dense_init(gen, (dff_sh, d), device)}
    return p


def route_topk(logits: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with normalized probabilities: logits [..., E]
    float32 -> (weights [..., k], indices [..., k]), the softmax over the
    k selected logits. Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return torch.softmax(vals, dim=-1), idx


def _pick_group_size(t: int, target: int = 2048) -> int:
    """Largest divisor of t that is <= target (>= 1)."""
    g = min(target, t)
    while t % g:
        g -= 1
    return g


class _RowGather(torch.autograd.Function):
    """``out[i] = src[idx[i]]``, a row of zeros where ``idx[i]`` is
    ``len(src)``. Its backward is the transposed gather: ``inv`` maps
    each row of ``src`` to the ``fan`` consecutive rows of ``out`` that
    read it (``len(out)`` where none does), and their gradients are
    summed in that order. Each out row reads one src row, so both ways
    are gathers: no atomic adds, the same bits on every run."""

    @staticmethod
    def forward(ctx, src, idx, inv, fan):
        ctx.save_for_backward(inv)
        ctx.fan = fan
        return _gather_rows(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        g = _gather_rows(grad, inv)
        return g.view(-1, ctx.fan, g.shape[-1]).sum(1), None, None, None


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([src, src.new_zeros((1, src.shape[-1]))])
    return pad.index_select(0, idx)


def _plan(p: Params, xt: torch.Tensor, cfg: ArchConfig,
          split: Optional[BatchSplit] = None):
    """The reference's routing of the grouped tokens xt [G, T_g, D]:
    (weights [G, T_g, k] float32, indices [G, T_g, k], positions in the
    expert buffers [G, T_g, k], keep [G, T_g, k] bool, capacity, aux).
    With ``split``, xt is one shard's whole groups: each expert's share
    of the routes is counted over every shard's groups, and the aux is
    this shard's term of the batch's (its mean over the shards is the
    whole batch's aux)."""
    mo = cfg.moe
    g, tg, _ = xt.shape
    e, k = mo.n_experts, mo.top_k
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = route_topk(logits, k)                   # [G, T_g, k]

    # position of each (token, slot) within its expert's capacity, in
    # token-major then slot order: the reference's cumulative sum over
    # the one-hot routes, laid out [G, E, T_g*k] so that the scan runs
    # along the contiguous axis (along the outer axis of [G, T_g*k, E] it
    # took 282 of 968 ms of a qwen3-moe prefill at B = 8 on an H100)
    flat = idx.reshape(g, 1, tg * k)
    onehot = (torch.arange(e, device=xt.device)[:, None] == flat).to(
        torch.int32)                                       # [G, E, T_g*k]
    pos = torch.gather(onehot.cumsum(2, dtype=torch.int32) - 1, 1,
                       flat).reshape(g, tg, k)             # [G, T_g, k]
    capacity = max(int(mo.capacity_factor * tg * k / e), 4)
    keep = pos < capacity

    # load-balancing aux loss (GShard/Switch): E * sum_e f_e * P_e
    counts = onehot.sum((0, 2))
    if split is not None:
        counts, g = split.sum(counts), g * split.n
    f = counts.to(torch.float32) / (g * tg)
    aux = e * torch.sum(f * probs.mean((0, 1))) * mo.router_aux_coef
    return weights, idx, pos, keep, capacity, aux


def moe_mlp(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
            group_size: Optional[int] = None, ep: Optional[Group] = None,
            a2a: Optional[Group] = None, shared_tp: Optional[Group] = None,
            split: Optional[BatchSplit] = None, sp: Optional[Group] = None,
            seq: Optional[Group] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE MLP. x [B, S, D] -> (y [B, S, D], aux loss, float32 scalar),
    in groups of ``group_size`` tokens (the reference's
    :func:`_pick_group_size` by default); capacity per (group, expert).

    Under a :func:`~repro_torch.distributed.sharding.batch_split` of n
    shards, x is this rank's shard of an n-times larger batch, and the
    groups are the whole batch's: a shard of whole groups routes them
    here (the expert shares of the aux counted over all shards); where
    a group spans shards, the batch is gathered and this shard's rows of
    the whole layer's output are returned.

    ``ep``: the experts split over an expert-parallel group (``p``'s
    expert stacks are this rank's block); ``a2a``: split over that batch
    group as well, the tokens exchanged with the experts' owners (forms
    (a) and (b) of the module's docstring; the choice is the shapes', so
    every rank makes the same); ``shared_tp``: the shared experts' d_ff
    split over a tensor-parallel group; ``split``: the batch split (None:
    the active one); ``sp``: ``x`` is this rank's segment of sequences
    split over the tensor group, and so is the output; ``seq``: over a
    group of their own (``Plan.seq``; the module docstring)."""
    split = split if split is not None else current_split()
    if seq is not None:
        return _moe_segments(p, x, cfg, group_size, ep, a2a, shared_tp,
                             split, seq)
    if sp is not None:
        if ep is not None and ep.dim != sp.dim:
            raise ValueError(f"the experts split over {ep.dim!r}, the "
                             f"sequences over {sp.dim!r}")
        x = seq_whole(x, sp)
    if split is None or split.n == 1:
        if a2a is not None:
            raise ValueError("experts split over a batch axis need the "
                             "batch split over it")
        return _moe(p, x, cfg, group_size or _pick_group_size(
            x.shape[0] * x.shape[1]), None, ep, shared_tp, sp=sp)
    tg = group_size or _pick_group_size(x.shape[0] * x.shape[1] * split.n)
    if (x.shape[0] * x.shape[1]) % tg:         # a group spans shards
        if a2a is not None:
            return _moe_spanning(p, x, cfg, tg, split, ep, a2a, shared_tp,
                                 sp)
        y, aux = _moe(p, split.gather(x), cfg, tg, None, ep, shared_tp,
                      sp=sp)
        return split.local(y), aux
    return _moe(p, x, cfg, tg, split, ep, shared_tp, a2a, sp)


def _moe_segments(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  group_size: Optional[int], ep: Optional[Group],
                  a2a: Optional[Group], shared_tp: Optional[Group],
                  split: BatchSplit, seq: Group
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Under ``Plan.seq``, x [B, s, D] this rank's segment of each of its
    sequences: the groups of the whole batch's tokens, form (a) where
    each lies within one segment (s a multiple of T_g), form (b)
    where one spans segments (the module docstring)."""
    b, s, _ = x.shape
    tg = group_size or _pick_group_size(b * s * split.n * seq.size)
    if s % tg == 0:
        return _moe(p, x, cfg, tg, split.tokens(), ep, shared_tp, a2a)
    y, aux = moe_mlp(p, seq_whole(x, seq), cfg, group_size=tg, ep=ep,
                     a2a=a2a, shared_tp=shared_tp, split=split)
    return narrow_seq(y, seq), aux


def _moe(p: Params, x: torch.Tensor, cfg: ArchConfig, tg: int,
         split: Optional[BatchSplit] = None, ep: Optional[Group] = None,
         shared_tp: Optional[Group] = None, a2a: Optional[Group] = None,
         sp: Optional[Group] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer on this rank's tokens x, its routing groups whole here
    (``a2a``: form (a), the slots exchanged with the experts' owners;
    ``sp``: x the gathered sequences, the output this rank's segment)."""
    b, s, d = x.shape
    xt = x.reshape(b * s // tg, tg, d)
    yt, aux = _routed(p, xt, cfg, split, ep, a2a, exchange=True,
                      enter=sp is None)
    if sp is not None:
        return _leave(p, yt.view(b, s, d), x, cfg, ep, shared_tp, sp), aux
    return _with_shared(p, reduce_from(yt, ep).to(x.dtype), xt, cfg,
                        shared_tp).reshape(b, s, d), aux


def _moe_spanning(p: Params, x: torch.Tensor, cfg: ArchConfig, tg: int,
                  split: BatchSplit, ep: Optional[Group], a2a: Group,
                  shared_tp: Optional[Group], sp: Optional[Group] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Form (b): the batch gathered, this rank's experts' slots of all of
    it, the partial output reduce-scattered over ``a2a`` onto this
    rank's rows and summed over ``ep`` (``sp``: reduce-scattered onto
    this rank's segment of them)."""
    b, s, d = x.shape
    whole = split.gather(x)
    xt = whole.reshape(whole.shape[0] * s // tg, tg, d)
    yt, aux = _routed(p, xt, cfg, None, ep, a2a, exchange=False,
                      enter=sp is None)
    if split.dims[-1] != a2a.dim:
        raise ValueError(f"the batch split {split.dims} does not end in "
                         f"the exchange dim {a2a.dim!r}")
    # the shards of this rank's peers along a2a (its pod's) are adjacent
    parts = yt.view(split.n, b * s, d).narrow(
        0, split.index - a2a.index, a2a.size)
    if sp is not None:
        return _leave(p, scatter_sum(parts, a2a).view(b, s, d), x, cfg, ep,
                      shared_tp, sp), aux
    y = reduce_from(scatter_sum(parts, a2a), ep).to(x.dtype)
    return _with_shared(p, y, x.reshape(1, b * s, d), cfg,
                        shared_tp).reshape(b, s, d), aux


def _leave(p: Params, y: torch.Tensor, x: torch.Tensor, cfg: ArchConfig,
           ep: Optional[Group], shared_tp: Optional[Group], sp: Group
           ) -> torch.Tensor:
    """Under ``sp``: the routed float32 output y [B, S, D] of the gathered
    sequences x (partial over ``ep``, or whole) as this rank's segment,
    rounded once, plus the shared experts' segment."""
    y = (scatter_to(y, sp) if ep is not None
         else narrow_seq(y, sp)).to(x.dtype)
    if not cfg.moe.n_shared_experts:
        return y
    return y + mlp(p["shared"], x, "swiglu", shared_tp, sp, gathered=True)


def _with_shared(p: Params, y: torch.Tensor, xt: torch.Tensor,
                 cfg: ArchConfig, shared_tp: Optional[Group]
                 ) -> torch.Tensor:
    """The routed output y [T, D] plus the shared experts' of xt [G, T_g,
    D]."""
    if not cfg.moe.n_shared_experts:
        return y
    return y + mlp(p["shared"], xt, "swiglu", shared_tp).reshape(y.shape)


def _owners(idx: torch.Tensor, keep: torch.Tensor, n_experts: int,
            n_local: int, ep: Optional[Group], a2a: Optional[Group],
            exchange: bool) -> tuple:
    """(n, dest, keep, local) of the routes ``idx`` to experts held in
    blocks of ``n_local`` over ``ep`` and ``a2a``: ``keep`` narrowed to
    the routes this rank runs (its own experts', or with ``exchange``
    its ``ep`` column's), ``dest`` each route's owner along ``a2a`` (n
    of them; 0, n = 1, without an exchange), ``local`` its expert's
    index in the owner's block."""
    n, dest = 1, 0
    if ep is None and a2a is None:
        return n, dest, keep, idx
    coords = expert_coords(n_experts, n_local, (ep, a2a), idx.device)
    for grp in (g for g in (ep, a2a) if g is not None):
        if grp is a2a and exchange:
            n, dest = grp.size, coords[grp.dim][idx]
        else:
            keep = keep & (coords[grp.dim][idx] == grp.index)
    return n, dest, keep, idx % n_local


def _routed(p: Params, xt: torch.Tensor, cfg: ArchConfig,
            split: Optional[BatchSplit], ep: Optional[Group],
            a2a: Optional[Group], exchange: bool, enter: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the float32 output [T, D] of this rank's share of the routes of
    the grouped tokens xt [G, T_g, D], the aux loss): :func:`_plan`'s
    routes (``split``: of one shard's groups), the slots of the experts
    this rank holds, or with ``exchange`` of those its ``ep`` column
    holds over ``a2a``, run there and brought back. ``enter`` False: the
    tokens and weights enter the experts without ``copy_to`` (xt was
    gathered over the sequence, whose backward sums the shares)."""
    into = ep if enter else None
    weights, idx, pos, keep, cap, aux = _plan(p, xt, cfg, split)
    g, tg, d = xt.shape
    t, k = g * tg, cfg.moe.top_k
    e = p["w_gate"].shape[0]                       # the experts held here
    n, dest, keep, idx = _owners(idx, keep, cfg.moe.n_experts, e, ep, a2a,
                                 exchange)

    # slot ids ((dest * E_loc + idx) * G + g) * C + pos: the buffers come
    # out [n, E_loc, G*C, D], by the experts' owner along a2a
    n_slots, n_entries = n * e * g * cap, t * k
    group = torch.arange(g, device=xt.device).view(g, 1, 1)
    slot = (((dest * e + idx) * g + group) * cap + pos).reshape(-1)
    keep = keep.reshape(-1)
    entry = torch.arange(n_entries, device=xt.device)
    slot_of = torch.where(keep, slot, n_slots)             # [T*k]
    # slot -> entry; each dropped entry writes a column of its own past
    # the slots, so no index repeats
    entry_of = torch.full((n_slots + n_entries,), n_entries,
                          dtype=torch.long, device=xt.device)
    entry_of.scatter_(0, torch.where(keep, slot, n_slots + entry), entry)
    entry_of = entry_of[:n_slots]
    token_of = torch.div(entry_of, k, rounding_mode="floor")  # t (or T)

    buf = _RowGather.apply(copy_to(xt.reshape(t, d), into), token_of,
                           slot_of, k)
    if n > 1:             # every source's slots of this rank's experts
        buf = all_to_all(buf.view(n, e * g * cap, d), a2a)
        buf = buf.view(n, e, g * cap, d).transpose(0, 1)
    buf = buf.reshape(e, n * g * cap, d)
    gate = dot(buf, p["w_gate"])                           # bmm over E
    hidden = F.silu(gate.to(torch.float32)) * dot(buf, p["w_up"])
    out = dot(hidden.to(gate.dtype), p["w_down"])          # [E, n*G*C, D]
    if n > 1:                                  # back to the slots' owners
        out = out.view(e, n, g * cap, d).transpose(0, 1)
        out = all_to_all(out.reshape(n, e * g * cap, d), a2a)
    got = _RowGather.apply(out.reshape(n_slots, d), slot_of, entry_of, 1)
    w = torch.where(keep, copy_to(weights, into).reshape(-1), 0.0)
    return (w[:, None] * got.to(torch.float32)).view(t, k, d).sum(1), aux
