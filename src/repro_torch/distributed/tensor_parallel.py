"""How the ruled steps split each layer's compute over the mesh: per-layer
gathers of the ZeRO-3 shards, tensor-parallel attention, MLP and
vocabulary, an expert-parallel MoE, and a train step's sequences in
segments. The port's own module: the reference's GSPMD builds the same
split from its partition specs and its activations' constraints (the
logits' ``"tensor"``, ``repro/models/model.py:163-166``, and the
residual stream's ``("batch", "seq", None)``), its rules binding
``tensor`` to "TP: heads / mlp / vocab (partial-sum merges == the
paper's ME tree)" and ``expert`` to "EP: MoE expert dim (dispatch == MC
tree)" (``repro/distributed/sharding.py:17-19``), and the multi-pod
``fsdp`` profile ``seq`` to ``pod`` ("cross-pod sequence parallelism",
``repro/launch/strategy.py:44-51``).

Under a ``mesh_rules`` context and a ``batch_split`` (the ruled train,
prefill and serve steps of ``train/steps.py``) the model gets the
parameter tree as DTensors placed by ``param_pspec``. :func:`hold` wraps
each leaf in a :class:`Held`, this rank's block and how the layers use
it; a stacked leaf unbinds into per-layer held leaves. Inside each layer
(inside its remat'd function, so that the backward gathers again),
:func:`use` turns held leaves into plain local tensors:

* every mesh axis the leaf is sharded over is gathered (``redistribute``
  to ``Replicate``) except the ``tensor`` / ``expert`` axis of a leaf the
  layer computes in shards: the column-parallel projections (``wq``,
  ``bq``, and ``wk``/``wv``/``bk``/``bv`` where the K/V heads divide;
  ``w_gate``/``w_up``; MLA's ``wq_b``/``wkv_b``; RWKV-6's
  ``wr``/``wk``/``wv``/``wg`` and channel-mix ``wk``), the row-parallel
  ones (``wo``, ``w_down``, Mamba-2's ``out_proj``, RWKV-6's ``wo`` and
  channel-mix ``wv``), the per-head leaves (``u``; ``a_log``,
  ``dt_bias``, ``d_skip``), the experts' stacks, the vocabulary rows
  of the embedding and head, the codebook heads' vocabulary columns and
  the codebook embeddings' codebooks; zamba2's shared block
  (``shared_attn/...``, ``shared_mlp/...``) splits as attention and the
  MLP do;
* the gather's backward is DTensor's: the gradient, ``Partial`` over the
  mesh dims of the batch and of the sequence split (and over ``tensor``
  for a leaf used whole
  inside a tensor-parallel region, or sliced to this rank's heads: the
  q / k norms, the K/V projections where each rank attends with its own
  q heads' groups, Mamba-2's ``in_proj`` / ``conv_w`` / ``conv_b`` /
  ``norm`` (the rules' column blocks of these are not head-aligned, so
  they are gathered and sliced), RWKV-6's decay ``w0`` / ``w1`` / ``w2``
  and ``ln_x``), is reduced onto the leaf's placements (a reduce-scatter
  where the leaf is sharded, an all-reduce where it is not).

The layers compute in shards with Megatron's pair of autograd ops:
:func:`copy_to` (identity forward, all-reduce backward) on the input of
a column-parallel region, :func:`reduce_from` (all-reduce forward,
identity backward) on the partial output of a row-parallel one: the
paper's ME tree, the partial sums merged. The MoE (``models/moe.py``)
routes every token on every rank of the ``expert`` axis (the tokens are
replicated there), runs its own experts' slots only (the MC tree) and
reduces its partial output the same way: under ``tp_ep`` no all-to-all,
as the reference's compiled program has none. Where the ``expert`` rule
also names a batch axis (``tp_ep_full``'s ``("model", "data")``: each
card owns whole experts), that axis is the exchange group
(``Plan.a2a``): the tokens go to the experts' owners and back by
:func:`all_to_all` over it, and no expert leaf is gathered. Which block
of experts a rank holds is DTensor's chunk order, the first mesh dim
outermost (:func:`expert_coords`), checked against each held leaf's own
offset. Experts that the ``expert`` rule's dims do not divide are
replicated, as ``param_pspec`` places them (:func:`expert_dims`), and
each rank runs them all on its own tokens. The vocabulary-parallel loss
(:func:`vocab_nll`) takes the max and the log-sum-exp across the ranks
and the target's logit from the rank that owns it; greedy decoding
(:func:`vocab_argmax`) takes the argmax across them, ties to the lowest
global index.

Where an axis has one rank nothing is split, and the plain code runs:
a one-rank mesh gives the plain step bit for bit. Attention is split
only where the heads divide over the axis and each rank's q heads fall
in whole K/V groups (or share one); MLA, Mamba-2 and RWKV-6 where their
heads divide (:class:`Plan`). A GQA decode cache whose K/V heads do not
divide is split on its capacity instead (``Plan.cap``, the reference's
``_state_sharding``): each rank holds its rows of every K/V head and
the decode merges the ranks' partial softmaxes
(``models/layers.py`` ``_split_decode``). MLA's latent cache and RoPE
key are split on their capacity wherever the axis has more than one
rank (``Plan.cap``): the absorbed
decode scores every head against this rank's rows and merges the
partial softmaxes in the latent space (``_split_mla_decode``); the
reference splits the latent rank instead, which would sum every head's
partial scores over the group, for the same bytes a card. The codebook
heads ``lm_heads`` [K, D, V] compute vocabulary-parallel (``Plan.vocab``:
each rank its [.., K, V / n] logits, :func:`vocab_nll` and
:func:`vocab_argmax` per codebook) and the codebook embeddings
``embed_codebooks`` [K, V, D] codebook-parallel (``Plan.books``: each
rank sums its own codebooks' rows, and the partial sums are reduced),
each where ``param_pspec`` splits it (:func:`codebook_dims`). Layers
whose heads do not divide are gathered per layer and computed whole on
each rank.

A train step's sequences split over the ``seq`` axis (``Plan.seq``,
:func:`seq_dim`: the multi-pod ``fsdp`` rules' ``pod``) give each rank
its contiguous segment of every sequence (``train/steps.py``
``batch_shard``). Each rank computes its segment only: attention
gathers the K/V of every segment (:func:`seq_whole`, an all-gather whose
backward reduce-scatters) and attends up to its last query (MLA gathers
its normed latent and RoPE key, 576 values a token at full width, and
expands them to per-head K/V on each rank); the MoE routes its own
routing groups where each lies within one segment, and otherwise
gathers the segments, routes the whole groups and keeps its segment's
rows (``models/moe.py``); RWKV-6's
token shifts and Mamba-2's causal conv take the previous segment's last
rows (:func:`prev_rows`); the recurrences run each segment from a zero
state on every rank at once, gather each segment's final state and total
decay, fold the state entering each segment (:func:`carry_in`) and add
its contribution. Every rank calls every one of these collectives, in
the same order, forward and in the remat'd recompute. The gradients are
then ``Partial`` over ``seq`` too, and the reduce-scatter onto each
leaf's ``fsdp`` placements (``pod`` among them) sums the segments'
shares. A sequence that does not divide and a segment shorter than
Mamba-2's conv window keep the sequences whole over ``pod``.

Where the ``seq`` rule names the tensor axis (``Plan.sp``: the dry
run's ``--seq-shard``, ``seq -> "model"`` beside ``tensor -> "model"``),
the ruled train and prefill steps give each rank of the tensor group its
contiguous segment of every sequence in the residual stream, MoE and MLA
configs included. Each layer then splits one of two ways. (a) Sequence
parallelism around a tensor-parallel region (the layer's heads, d_ff or
experts split): the region's input is all-gathered along the sequence
(:func:`seq_whole`, in place of :func:`copy_to`; backward a
reduce-scatter) and its float32 partial output reduce-scattered onto the
segment and rounded once (:func:`scatter_to`, in place of
:func:`reduce_from`; backward an all-gather); the token-wise work before
the gather (the norms, MLA's latent projections, RWKV-6's channel-mix
shift and gate) runs on the segment. (b) The segment alone, where the
heads do not split: GQA attention and the recurrences as ``Plan.seq``'s
segments above, over the tensor group, and a token-wise MLP with no
collective; MLA whose heads do not divide (reduced configs only)
gathers the sequence, computes whole and keeps its segment. The MoE
gathers its tokens before routing, so its routing groups are today's.
Every leaf the tensor axis does not split then has a gradient
``Partial`` over it: each rank's share, from its segment or its part of
a region. The loss is computed on the gathered sequence and is the
whole sequence's on every rank of the group (where the head is not
vocabulary-parallel, and for the MoE's aux, each rank's backward counts
1 / n of it, :func:`count_once`). Decode, a sequence the group does not
divide and a one-rank group keep the sequences whole.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (_current, _is_dtensor, _names,
                                              _path_str, current_split,
                                              flat_tree, mesh_axis_names,
                                              mesh_shape, param_pspec,
                                              tree_map, tree_map_with_path)


@dataclasses.dataclass(frozen=True)
class Group:
    """This rank's row along one mesh dim ``dim``: ``size`` ranks, this
    one the ``index``-th (DTensor's chunk order along that dim)."""
    mesh: Any
    dim: str
    size: int
    index: int

    def _name(self) -> str:
        return self.mesh.get_group(self.dim).group_name

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        f = torch.ops._c10d_functional
        return f.wait_tensor(f.all_reduce(t.contiguous(), op, self._name()))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t``, in index order."""
        f = torch.ops._c10d_functional
        out = f.wait_tensor(f.all_gather_into_tensor(
            t.contiguous(), self.size, self._name()))
        return out.view(self.size, *t.shape)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [size, *shape] summed over the ranks; this rank's
        ``[index]`` of the sum."""
        f = torch.ops._c10d_functional
        out = f.wait_tensor(f.reduce_scatter_tensor(
            t.contiguous(), "sum", self.size, self._name()))
        return out.view(t.shape[1:])

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [size, ...]: block i goes to rank i; returns [size,
        ...], block j the one rank j sent here (equal splits)."""
        f = torch.ops._c10d_functional
        ones = [1] * self.size
        out = f.wait_tensor(f.all_to_all_single(
            t.contiguous().view(self.size, -1), ones, ones, self._name()))
        return out.view(t.shape)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a model's layers split on this mesh: the mesh dims of the
    batch, the ``tensor`` and ``expert`` groups (None: one rank, or no
    axis), and whether GQA attention (its heads; ``kv``: its K/V heads
    too), the vocabulary and the family's own heads (``heads``: MLA's,
    Mamba-2's or RWKV-6's, :func:`family_heads`) are split; ``cap``: a
    GQA decode cache whose K/V heads do not split, and MLA's latent
    cache, are split on their capacity (``vocab`` covers the codebook
    heads too); ``books``: the codebook embeddings are split on their
    codebooks; ``seq``: the group a train step's sequences are
    split over (:func:`seq_dim`; None: whole); ``a2a``: the batch dim the
    experts are split over as well, the group the MoE exchanges its
    tokens over (None: the experts' owners hold the tokens already);
    ``sp``: the tensor group when the sequences are split over it too
    (sequence parallelism; apart from ``seq``, whose segments every
    layer computes alone)."""
    batch_dims: tuple
    tp: Optional[Group]
    ep: Optional[Group]
    attn: bool
    kv: bool
    vocab: bool
    heads: bool
    cap: bool
    seq: Optional[Group] = None
    a2a: Optional[Group] = None
    books: bool = False
    sp: Optional[Group] = None


def _one_group(mesh, dims: list) -> Optional[Group]:
    return _group_on(mesh, dims[0]) if len(dims) == 1 else None


def _group(rules, logical: str, batch_dims: tuple) -> Optional[Group]:
    """The group of a logical axis: its mesh dims that are not the
    batch's and have more than one rank; None unless exactly one."""
    sizes = mesh_shape(rules.mesh)
    return _one_group(rules.mesh, [d for d in _names(rules.rules.get(logical))
                                   if d not in batch_dims and sizes[d] > 1])


def expert_dims(cfg, rules) -> tuple:
    """The mesh dims ``param_pspec`` splits ``cfg``'s expert stacks
    over (its own divisibility rule: empty where the product of the
    ``expert`` rule's dims does not divide the experts, which are then
    replicated)."""
    if cfg.moe is None:
        return ()
    mo = cfg.moe
    spec = param_pspec("layers/moe/w_gate",
                       (1, mo.n_experts, cfg.d_model, mo.d_ff_expert), rules)
    return _names(spec[1])


def codebook_dims(cfg, rules) -> tuple:
    """(the mesh dims ``param_pspec`` splits ``embed_codebooks`` [K, V,
    D]'s codebooks over, those it splits ``lm_heads`` [K, D, V]'s
    vocabulary over): its own divisibility rule, so that the compute
    split and the placement cannot disagree; both empty without
    codebooks."""
    if not cfg.n_codebooks:
        return (), ()
    k, v, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    return (_names(param_pspec("embed_codebooks", (k, v, d), rules)[0]),
            _names(param_pspec("lm_heads", (k, d, v), rules)[2]))


def _group_on(mesh, dim: str) -> Group:
    coord = dict(zip(mesh_axis_names(mesh), mesh.get_coordinate()))
    return Group(mesh, dim, mesh_shape(mesh)[dim], coord[dim])


def ssm_heads(cfg) -> int:
    """The recurrent heads of an ``ssm`` (RWKV-6) or ``hybrid`` (Mamba-2)
    layer; 0 for the other families."""
    if cfg.family == "ssm":
        return cfg.d_model // cfg.ssm.head_dim
    if cfg.family == "hybrid":
        return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    return 0


def family_heads(cfg) -> int:
    """The heads ``Plan.heads`` splits: MLA's, else the recurrent
    layers' (:func:`ssm_heads`); 0 for GQA attention (``Plan.attn``)."""
    return cfg.n_heads if cfg.mla else ssm_heads(cfg)


def seq_dim(cfg, rules, batch_dims: tuple, seq_len: int) -> Optional[str]:
    """The mesh dim a ruled step splits ``cfg``'s sequences of
    ``seq_len`` tokens over: the ``seq`` rule's one mesh dim of more than
    one rank that is not the batch's. Either the tensor axis (``Plan.sp``,
    the tensor rule's one dim: train and prefill) or an axis that is
    neither the ``tensor`` nor the ``expert`` axis's (``Plan.seq``, the
    multi-pod ``fsdp`` rules' ``pod``: train). None, the sequences whole,
    where ``seq_len`` does not divide over it and where a segment is
    shorter than Mamba-2's conv window. Works on an ``AbstractMesh``
    too."""
    sizes = mesh_shape(rules.mesh)
    dims = [d for d in _names(rules.rules.get("seq")) if sizes[d] > 1]
    if len(dims) != 1 or dims[0] in batch_dims or seq_len % sizes[dims[0]]:
        return None
    if not on_tensor(rules, dims[0]) and (
            dims[0] in _names(rules.rules.get("tensor"))
            or dims[0] in _names(rules.rules.get("expert"))):
        return None
    if cfg.family == "hybrid" and \
            seq_len // sizes[dims[0]] < cfg.ssm.d_conv - 1:
        return None
    return dims[0]


def on_tensor(rules, dim: str) -> bool:
    """Whether mesh dim ``dim`` is the ``tensor`` rule's one axis (a
    sequence split over it is ``Plan.sp``)."""
    return tuple(_names(rules.rules.get("tensor"))) == (dim,)


def plan_for(cfg, rules=None, batch_dims: Optional[tuple] = None) -> Plan:
    """The split of ``cfg``'s layers under ``rules`` (default: the active
    ``mesh_rules``) with the batch over ``batch_dims`` (default: the
    active ``batch_split``'s dims, and its sequence split)."""
    rules = rules if rules is not None else _current()
    seq = sp = None
    if batch_dims is None:
        split = current_split()
        batch_dims = split.dims if split is not None else ()
        seq, sp = seq_groups()
    tp = _group(rules, "tensor", batch_dims)
    sizes = mesh_shape(rules.mesh)
    experts = [d for d in expert_dims(cfg, rules) if sizes[d] > 1]
    ep = _one_group(rules.mesh, [d for d in experts if d not in batch_dims])
    a2a = _one_group(rules.mesh, [d for d in experts if d in batch_dims])
    attn = kv = heads = cap = False
    if tp is not None:
        if not cfg.mla and cfg.n_heads % tp.size == 0:
            local, rep = cfg.n_heads // tp.size, cfg.n_heads // cfg.n_kv_heads
            attn = local % rep == 0 or rep % local == 0
            kv = attn and cfg.n_kv_heads % tp.size == 0
        n = family_heads(cfg)
        heads = n > 0 and n % tp.size == 0
        cap = cfg.family != "ssm" and not kv
    books_dims, vocab_dims = codebook_dims(cfg, rules)
    if cfg.n_codebooks:
        vocab = tp is not None and tp.dim in vocab_dims
    else:
        vocab = tp is not None and cfg.vocab_size % tp.size == 0
    books = tp is not None and tp.dim in books_dims
    return Plan(tuple(batch_dims), tp, ep, attn, kv, vocab, heads, cap, seq,
                a2a, books, sp)


def mesh_plan(cfg, rules) -> Plan:
    """:func:`plan_for` with the batch over ``rules``' batch axes (the
    split a ruled step's decode state was made under, read outside its
    ``batch_split``)."""
    batch = set(_names(rules.rules.get("batch")))
    return plan_for(cfg, rules, tuple(n for n in mesh_axis_names(rules.mesh)
                                      if n in batch))


class Held:
    """A parameter leaf as this rank holds it (``t``, a DTensor) and as a
    layer uses it: gathered to the placements ``use``, its gradient
    arriving with ``grad`` (``to_local(grad_placements=...)``), computed
    over ``group`` (None: whole). ``use`` None: nothing to gather or
    reduce on any mesh dim of more than one rank, so the layer uses the
    local block as it is (``t`` may then be that plain block). ``a2a``:
    an expert stack's exchange group (``Plan.a2a``), whose shard the
    leaf keeps as well."""
    __slots__ = ("t", "use", "grad", "group", "a2a")

    def __init__(self, t, use: Optional[list], grad: Optional[list],
                 group: Optional[Group], a2a: Optional[Group] = None):
        self.t, self.use, self.grad, self.group = t, use, grad, group
        self.a2a = a2a

    def unbind(self, dim: int = 0) -> list:
        """A stacked leaf's per-layer held leaves (this rank's block
        unbound; the layer axis is never sharded)."""
        from torch.distributed.tensor import DTensor, Shard
        if self.use is None:
            return [Held(x, None, None, self.group, self.a2a)
                    for x in local_block(self.t).unbind(dim)]
        if dim != 0 or any(isinstance(p, Shard) and p.dim == 0
                           for p in self.t.placements):
            raise ValueError(f"a held leaf unbinds its unsharded dim 0, "
                             f"not {dim} of {self.t.placements}")

        def shift(pl):
            return [Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for p in pl]
        mesh = self.t.device_mesh
        pl, use, grad = shift(self.t.placements), shift(self.use), \
            shift(self.grad)
        return [Held(DTensor.from_local(x, mesh, pl, run_check=False), use,
                     grad, self.group, self.a2a)
                for x in self.t.to_local().unbind(0)]

    def value(self) -> torch.Tensor:
        """The local tensor the layer computes with (a collective)."""
        if self.use is None:
            return local_block(self.t)
        return self.t.redistribute(self.t.device_mesh, self.use).to_local(
            grad_placements=self.grad)


def local_block(t) -> torch.Tensor:
    """A DTensor's local block (a view: in-place ops on it are the
    DTensor's), or ``t``."""
    return t.to_local() if _is_dtensor(t) else t


# leaf paths of the split modules (the tree's '/'-joined keys); zamba2's
# shared block is ``shared_attn_block/shared_attn/...``, ``.../shared_mlp/...``
_COLUMN_Q = re.compile(r"(^|/)(shared_)?attn/(wq|bq|wo)$")
_COLUMN_KV = re.compile(r"(^|/)(shared_)?attn/(wk|wv|bk|bv)$")
_QK_NORM = re.compile(r"(^|/)(shared_)?attn/[qk]_norm/scale$")
_MLP = re.compile(r"(^|/)(mlp|moe/shared|shared_mlp)/w_(gate|up|down)$")
_EXPERTS = re.compile(r"(^|/)moe/w_(gate|up|down)$")
_VOCAB = re.compile(r"^(embed|lm_heads?)$")
# ``Plan.heads``' leaves (MLA's, Mamba-2's and RWKV-6's, disjoint by
# path): split over whole heads (columns, rows or the head dim; RWKV-6's
# channel mix over d_ff), and used whole but sliced to this rank's heads
# (a gradient ``Partial`` over tensor)
_RWKV_FFN = re.compile(r"(^|/)channel_mix/(wk|wv)$")
_HEADS = re.compile(r"(^|/)(attn/(wq_b|wkv_b|wo)"
                    r"|mamba/(out_proj|a_log|dt_bias|d_skip)"
                    r"|time_mix/(wr|wk|wv|wg|wo|u)|channel_mix/(wk|wv))$")
_SLICED = re.compile(r"(^|/)(mamba/(in_proj|conv_w|conv_b|norm/scale)"
                     r"|time_mix/(w0|w1|w2|ln_x/(scale|bias)))$")


def _layout(path: str, t, plan: Plan) -> tuple:
    """(use placements, gradient placements, group, exchange group) of
    one leaf. An expert stack split over ``plan.a2a`` as well keeps that
    shard in use and in its gradient: the reverse all-to-all of the
    backward brings every batch shard's share to the owner, so nothing
    is ``Partial`` over it. Under ``plan.sp`` every leaf the tensor axis
    does not split is ``Partial`` over it: each rank's gradient is its
    segment's share, or its share of a region that saw the gathered
    sequence (whose gather's backward reduce-scatters)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    group, partial, a2a = None, False, None
    if plan.attn and _COLUMN_Q.search(path):
        group = plan.tp
    elif plan.attn and _COLUMN_KV.search(path):
        group, partial = (plan.tp, False) if plan.kv else (None, True)
    elif plan.attn and _QK_NORM.search(path):
        partial = True
    elif plan.heads and _HEADS.search(path):
        group = plan.tp
    elif plan.heads and _SLICED.search(path):
        partial = True
    elif _MLP.search(path) or (plan.vocab and _VOCAB.search(path)) or (
            plan.books and path == "embed_codebooks"):
        group = plan.tp
    elif _EXPERTS.search(path):
        group, a2a = plan.ep, plan.a2a
    names = mesh_axis_names(t.device_mesh)
    if group is not None and not isinstance(
            t.placements[names.index(group.dim)], Shard):
        if not (_MLP.search(path) or _RWKV_FFN.search(path)):
            raise ValueError(f"{path}: split over {group.dim!r} but held "
                             f"as {t.placements}")
        group = None              # an MLP whose d_ff does not divide
    if a2a is not None:
        _check_expert_block(path, t, plan)
    kept = {g.dim for g in (group, a2a) if g is not None}
    summed = set(plan.batch_dims) | {g.dim for g in (plan.seq, plan.sp)
                                     if g is not None}
    use, grad = [], []
    for n, p in zip(names, t.placements):
        if n in kept:
            use.append(p)
            grad.append(p)
        else:
            use.append(Replicate())
            grad.append(Partial() if n in summed or (
                partial and plan.tp is not None and n == plan.tp.dim)
                else Replicate())
    sizes = mesh_shape(t.device_mesh)
    if all(sizes[n] == 1 or (u == p and not isinstance(g, Partial))
           for n, p, u, g in zip(names, t.placements, use, grad)):
        return None, None, group, a2a     # the local block as it is
    return use, grad, group, a2a


def expert_coords(n_experts: int, n_local: int, groups: tuple,
                  device=None) -> dict:
    """{mesh dim: [n_experts] coordinate of each expert's owner along
    it} for experts split over ``groups`` (``Plan.ep`` and ``Plan.a2a``;
    None entries are left out) in blocks of ``n_local``: DTensor's chunk
    order, block b on the rank whose coordinates along those dims, the
    first mesh dim outermost, spell b."""
    groups = [g for g in groups if g is not None]
    names = mesh_axis_names(groups[0].mesh)
    block = torch.arange(n_experts, device=device) // n_local
    out = {}
    for g in sorted(groups, key=lambda g: -names.index(g.dim)):
        out[g.dim] = block % g.size
        block = torch.div(block, g.size, rounding_mode="floor")
    return out


def _check_expert_block(path: str, t, plan: Plan) -> None:
    """Raise unless this rank's block of the expert stack ``t`` starts
    where :func:`expert_coords` puts it: the order read from the DTensor
    itself."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    held = dict(zip(mesh_axis_names(t.device_mesh), t.placements))
    if not isinstance(held[plan.a2a.dim], Shard):
        raise ValueError(f"{path}: exchanged over {plan.a2a.dim!r} but "
                         f"held as {t.placements}")
    dim = held[plan.a2a.dim].dim
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    groups = (plan.ep, plan.a2a)
    coords = expert_coords(t.shape[dim], shape[dim], groups)
    first = offset[dim]
    if any(int(coords[g.dim][first]) != g.index for g in groups if g):
        raise ValueError(f"{path}: this rank's experts start at {first}, "
                         f"not where {t.placements} put them")


def hold(params, cfg):
    """``params`` with every DTensor leaf a :class:`Held` (the active
    ``mesh_rules`` and ``batch_split`` decide the split); a tree of plain
    tensors, or one held already, comes back as it is."""
    if not any(_is_dtensor(t) for t in flat_tree(params).values()):
        return params
    plan = plan_for(cfg)

    def one(path, t):
        if not _is_dtensor(t):
            return t
        return Held(t, *_layout(_path_str(path), t, plan))
    return tree_map_with_path(one, params)


def use(tree):
    """The plain tensors of a (held) tree: each held leaf gathered for
    the layer that calls this."""
    return tree_map(lambda t: t.value() if isinstance(t, Held) else t, tree)


def group_of(tree, *keys) -> Optional[Group]:
    """The group the held leaf at ``tree[k0][k1]...`` is computed over
    (None: whole, plain, or absent)."""
    held = _held_at(tree, keys)
    return held.group if held is not None else None


def _held_at(tree, keys):
    for k in keys:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree if isinstance(tree, Held) else None


def exchange_of(tree, *keys) -> Optional[Group]:
    """The exchange group (``Plan.a2a``) of the held expert stack at
    ``tree[k0][k1]...`` (None: not exchanged, plain, or absent)."""
    held = _held_at(tree, keys)
    return held.a2a if held is not None else None


def capacity_group(params, cfg) -> Optional[Group]:
    """The group a decode cache's capacity is split over (``Plan.cap``):
    under the ruled steps (a held tree), the ``tensor`` group for MLA's
    latent cache, and for a GQA cache where the K/V heads do not split
    over it; else None."""
    if not any(isinstance(t, Held) for t in flat_tree(params).values()):
        return None
    plan = plan_for(cfg)
    return plan.tp if plan.cap else None


def capacity_rows(t: torch.Tensor, group: Optional[Group],
                  dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole cache ``t`` split over ``group`` on
    its capacity ``dim``: rows [i c, (i + 1) c), c = ceil(C / n), the
    capacity zero-padded to n c (rows past the cache's length are masked
    in decode); ``t`` itself without a group. The one rule for a
    capacity split, whether or not n divides C."""
    if group is None:
        return t
    c = -(-t.shape[dim] // group.size)
    pad = c * group.size - t.shape[dim]
    if pad:
        t = F.pad(t, (0, 0) * (t.ndim - dim - 1) + (0, pad))
    return t.narrow(dim, group.index * c, c).clone()


# a decode-state leaf by its key (the last name of its path; a per-layer
# list adds an index): the capacity dim, counted from the end, of the K/V
# caches [.., B, C, Hkv, Dh] and MLA's latent [.., B, C, r] and RoPE key
# [.., B, C, dr]; the recurrent leaves have none
_CAPACITY_FROM_END = {"k": 3, "v": 3, "latent": 2, "krope": 2}


def _state_key(path: tuple) -> Optional[str]:
    return next((k for k in reversed(path) if isinstance(k, str)), None)


def capacity_dim(path: tuple, t) -> Optional[int]:
    """The capacity dim of the decode cache ``t`` at ``path`` (None: a
    recurrent leaf, or ``len``)."""
    n = _CAPACITY_FROM_END.get(_state_key(path))
    return None if n is None else t.ndim - n


def state_split(cfg, plan: Plan, path: tuple, t) -> Optional[int]:
    """The dim of the decode-state leaf ``t`` at ``path`` on which this
    rank holds one block over ``plan.tp``, the decode state's placement
    policy: a GQA cache's K/V heads where they split (``plan.kv``), else
    its capacity (``plan.cap``; the reference's ``_state_sharding``);
    the capacity of MLA's ``latent`` [.., B, C, r] and ``krope`` [.., B,
    C, dr] (``plan.cap``: the reference splits r and dr, see the module
    docstring); the heads of a Mamba-2 ``ssm`` [.., B, H, P, N] or
    RWKV-6 ``wkv`` [.., B, H, N, N] state where those layers split them.
    None: whole over ``tensor`` (the token-shift states, no group), or
    not one block: a Mamba-2 ``conv`` state [.., B, K-1, channels] holds
    the x channels of this rank's heads and all of B and C.
    :func:`state_block` cuts this rank's part."""
    if plan.tp is None:
        return None
    key = _state_key(path)
    if key in ("k", "v") and not cfg.mla:
        return t.ndim - 2 if plan.kv else t.ndim - 3 if plan.cap else None
    if key in ("latent", "krope") and cfg.mla and plan.cap:
        return capacity_dim(path, t)
    if plan.heads and key in ("ssm", "wkv"):
        return t.ndim - 3
    return None


def state_block(cfg, plan: Plan, path: tuple, t: torch.Tensor
                ) -> torch.Tensor:
    """This rank's part of the decode-state leaf ``t`` held whole over
    ``plan.tp``: its block on :func:`state_split`'s dim (of a capacity,
    :func:`capacity_rows`), or a ``conv`` state's channels; ``t`` itself
    where the leaf is whole."""
    if plan.tp is None:
        return t
    n, i = plan.tp.size, plan.tp.index
    if plan.heads and _state_key(path) == "conv":
        d_inner = cfg.ssm.expand * cfg.d_model
        di = d_inner // n
        return torch.cat([t[..., i * di:(i + 1) * di], t[..., d_inner:]], -1)
    dim = state_split(cfg, plan, path, t)
    if dim is None:
        return t
    if dim == capacity_dim(path, t):
        return capacity_rows(t, plan.tp, dim)
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k)


# ---------------------------------------------------------------------------
# Megatron's pair of ops
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g), None


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """:meth:`Group.all_to_all` of ``x`` [size, ...]; backward, the
    reverse all-to-all brings each block's gradient back to its
    sender."""
    return _AllToAll.apply(x, group)


def scatter_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` [size, ...] summed over ``group``, this rank's ``[index]``
    of the sum (a reduce-scatter); backward, the ranks' gradients
    gathered (an all-gather)."""
    return _ScatterSum.apply(x, group)


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The input of a column-parallel region: ``x`` forward, its gradient
    summed over ``group`` backward (``x`` itself without a group)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """A row-parallel region's partial output summed over ``group``; the
    gradient passes through (``x`` itself without a group)."""
    return x if group is None else _ReduceFrom.apply(x, group)


# -- sequence parallelism around a region (``Plan.sp``) ----------------------


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def scatter_to(x: torch.Tensor, sp: Group) -> torch.Tensor:
    """A region's partial output ``x`` [B, n s, ...] summed over ``sp``,
    this rank's segment [B, s, ...] of the sum (a reduce-scatter);
    backward, the ranks' gradients gathered (an all-gather: each rank's
    part of the region feeds every segment). In place of
    :func:`reduce_from`."""
    b, n = x.shape[0], sp.size
    parts = x.reshape(b, n, x.shape[1] // n, *x.shape[2:]).transpose(0, 1)
    return scatter_sum(parts, sp)


def narrow_seq(x: torch.Tensor, sp: Group, dim: int = 1) -> torch.Tensor:
    """This rank's segment of ``x`` whole along ``dim`` (a region computed
    whole on the gathered sequence keeps its segment; positions)."""
    s = x.shape[dim] // sp.size
    return x.narrow(dim, sp.index * s, s)


def seq_join(x: torch.Tensor, sp: Group, dim: int = 1) -> torch.Tensor:
    """Every rank's segment of ``x`` joined along ``dim``, no gradient
    (token ids, labels, positions)."""
    with torch.no_grad():
        return torch.cat(sp.all_gather(x).unbind(0), dim=dim)


def count_once(x: torch.Tensor, sp: Optional[Group]) -> torch.Tensor:
    """``x``, a value every rank of ``sp`` computes whole from the
    gathered sequence (the loss through a head that does not split, the
    MoE's aux loss); backward, 1 / n of its gradient on each rank, whose
    shares the segments' reduce-scatters and the ``Partial`` gradients
    then sum once."""
    return x if sp is None else _CountOnce.apply(x, sp.size)


def last_rows(x: torch.Tensor, n: int, sp: Group) -> torch.Tensor:
    """The whole sequence's last ``n`` rows [B, n, ...] of segments ``x``
    [B, s, ...] (the last segment's), on every rank: the states a prefill
    leaves."""
    return seq_gather(x[:, -n:], sp)[-1]


# ---------------------------------------------------------------------------
# The sequence split over the seq axis
# ---------------------------------------------------------------------------


def seq_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[size, *x.shape]: every segment's ``x``, in sequence order;
    backward, each segment's gradient summed over ``group`` back to its
    rank (a reduce-scatter)."""
    return _SeqGather.apply(x, group)


def seq_whole(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The segments' ``x`` [B, s, ...] joined on dim 1: [B, size s, ...]
    (the K/V of the whole sequence; under ``Plan.sp`` the input of a
    tensor-parallel region, in place of :func:`copy_to`); backward, each
    segment's gradient summed over ``group`` onto its rank (a
    reduce-scatter: each rank's share, from its part of a region or its
    queries)."""
    parts = seq_gather(x, group)                  # [size, B, s, ...]
    return parts.transpose(0, 1).flatten(1, 2)


def prev_rows(x: torch.Tensor, n: int, group: Group) -> torch.Tensor:
    """The previous segment's last ``n`` rows of ``x`` [B, s, ...]:
    [B, n, ...], zeros on the first segment (the token shift's and the
    causal conv's state at a segment's start). Every rank takes its rows
    from the gathered whole, so every rank's backward joins the
    reduce-scatter."""
    parts = seq_gather(x[:, -n:], group)          # [size, B, n, ...]
    return torch.cat([torch.zeros_like(parts[:1]), parts[:-1]])[group.index]


def fold_carries(parts: torch.Tensor) -> torch.Tensor:
    """The state entering each segment of a linear recurrence ``S_t =
    exp(a_t) S_{t-1} + u_t`` run from a zero state on every segment:
    ``parts`` [n, 2, ...] holds each segment's final state and its total
    log decay (broadcast to the state's shape). S_in(0) = 0, S_in(p) =
    exp(D_{p-1}) S_in(p-1) + S_loc(p-1); returns [n, ...]."""
    s = torch.zeros_like(parts[0, 0])
    out = [s]
    for q in range(parts.shape[0] - 1):
        s = s * torch.exp(parts[q, 1]) + parts[q, 0]
        out.append(s)
    return torch.stack(out)


def carry_in(state: torch.Tensor, log_decay: torch.Tensor,
             group: Group, whole: bool = False) -> tuple:
    """(entering, leaving): the state entering this rank's segment, and
    the state leaving it. Every segment's final ``state`` (its pass from
    a zero state) and total ``log_decay`` (broadcasting against the
    state) are gathered over ``group`` in one collective and folded
    (:func:`fold_carries`) on every rank at once: no rank waits on the
    previous one's state. ``whole``: the state leaving the whole
    sequence (the last segment's), the same on every rank, in place of
    this segment's."""
    parts = seq_gather(torch.stack([state, log_decay.expand_as(state)]),
                       group)
    s_in = fold_carries(parts)
    own = s_in[group.index]
    if whole:
        return own, s_in[-1] * torch.exp(parts[-1, 1]) + parts[-1, 0]
    return own, state + torch.exp(log_decay) * own


def seq_groups() -> tuple:
    """(``Plan.seq``, ``Plan.sp``): the group the active ``batch_split``
    splits the sequences over, as the first where it is not the active
    rules' tensor axis and as the second where it is; (None, None)
    where the sequences are whole."""
    split = current_split()
    if split is None or not split.seq_dims:
        return None, None
    group = _group_on(split.mesh, split.seq_dims[0])
    rules = _current()
    if rules is not None and on_tensor(rules, group.dim):
        return None, group
    return group, None


# ---------------------------------------------------------------------------
# The vocabulary split over the tensor axis
# ---------------------------------------------------------------------------


def _local_ids(ids: torch.Tensor, v: int, group: Group) -> tuple:
    local = ids.long() - group.index * v
    inside = (local >= 0) & (local < v)
    return torch.where(inside, local, 0), inside


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                group: Group, sp: Optional[Group] = None) -> torch.Tensor:
    """Rows of a vocabulary-split ``table`` [V / n, D]: each rank looks
    up the tokens in its range, zeroes the rest, and the rows are summed
    over ``group`` (exact: one term is not zero). ``sp``: ``tokens`` is
    the gathered sequence [B, S], and the sum is reduce-scattered onto
    this rank's segment."""
    local, inside = _local_ids(tokens, table.shape[0], group)
    rows = F.embedding(local, table)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return reduce_from(rows, group) if sp is None else scatter_to(rows, sp)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor,
              group: Group) -> torch.Tensor:
    """The summed negative log-likelihood of ``labels`` under float32
    logits split on the vocabulary (this rank's [..., V / n]): the max
    and the sum of exponentials taken across ``group``, the target's
    logit from the rank that owns it."""
    m = group.all_reduce(logits.detach().amax(-1), "max")
    se = reduce_from(torch.exp(logits - m[..., None]).sum(-1), group)
    local, inside = _local_ids(labels, logits.shape[-1], group)
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    picked = reduce_from(torch.where(inside, picked, 0.0), group)
    return (torch.log(se) + m - picked).sum()


def vocab_argmax(logits: torch.Tensor, group: Group) -> torch.Tensor:
    """The global argmax over the last dim of vocabulary-split logits
    (int64): each rank's max and its index, gathered; ties go to the
    lowest global index, as ``torch.argmax`` gives them."""
    v = logits.shape[-1]
    idx = torch.argmax(logits, -1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    vals, idxs = group.all_gather(val), group.all_gather(idx + group.index
                                                         * v)
    return torch.gather(idxs, 0, torch.argmax(vals, 0)[None])[0]


def vocab_gather(logits: torch.Tensor, group: Group) -> torch.Tensor:
    """Vocabulary-split logits [..., V / n] -> [..., V] on every rank."""
    parts = group.all_gather(logits)                # [n, ..., V / n]
    return torch.cat(parts.unbind(0), dim=-1)
