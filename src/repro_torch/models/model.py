"""The causal LM of every family of the reference: ``ssm`` (rwkv6-3b),
``hybrid`` (zamba2-7b), ``dense`` (stablelm-12b, glm4-9b, chatglm3-6b,
qwen2-1.5b), ``moe`` (qwen3-moe-30b-a3b; deepseek-v3-671b with MLA, a
shared expert and leading dense layers), ``audio`` (musicgen-medium: K
codebooks summed in, K heads out, sinusoidal positions) and ``vlm``
(qwen2-vl-7b: M-RoPE); port of ``repro/models/model.py``.

One model definition driven by ``ArchConfig``. Parameters keep the
reference's tree: every layer's leaves STACKED on a leading [L] axis
(the ``moe`` family's leading dense layers in a ``dense_layers`` stack
of their own), so :func:`params_from_numpy` carries the reference's
parameters across as they are. Where the reference scans a stack with
``lax.scan``, the port loops over the layers in Python, each leaf
unbound into per-layer views (:func:`_unstack`). Three modes share the
code: ``train`` (the stateless forward, behind :func:`loss_fn` and
:func:`full_logits`), ``prefill`` (emit the decode state for the whole
prompt) and ``decode`` (one token: O(1) recurrent state, plus the shared
attention's K/V cache for ``hybrid``; the K/V cache of every layer for
the transformers, or MLA's latent cache). A prefill on the card runs the
recurrences through the ``wkv6`` / ``ssd`` CUDA kernels, one launch per
layer; on the CPU, and wherever autograd records the forward (the
kernels have no backward), it runs the chunked einsum forms, as the
reference's model always does; decode runs the single-step recurrences
in plain torch, as the reference does. The transformer families have no
kernel: attention, MLA and the experts are the reference's plain
computations (the experts as gathers and ``bmm``, see ``moe.py``), on
the card as on the CPU. The reference's six sharding constraints
(``distributed.sharding.logical_constraint``) stand where it has them:
the embedding's output, the logits, the attention and MLP residuals,
the shared block's output. Outside a ``mesh_rules`` context each is a
no-op, and inside one a plain tensor comes back as it is.

Under the ruled steps (``train/steps.py``) the parameters are DTensors:
each entry point holds them (``distributed.tensor_parallel.hold``), and
each layer gathers its own leaves where it runs, inside its remat'd
function (``use``), keeping the ``tensor`` / ``expert`` shards of the
layers it computes in shards: GQA and MLA attention, the Mamba-2 and
RWKV-6 layers over their heads, the MLPs over d_ff, the MoE over its
experts, the embedding, head and loss over the vocabulary (the codebook
heads too, and the codebook embeddings over their codebooks); the
decode state holds this rank's heads, or its capacity rows of a GQA
cache whose K/V heads do not split and of MLA's latent cache. The logits
then come out this rank's [..., V / n] (``unembed_hidden``). Where the
rules split the sequences over the tensor axis (``Plan.sp``) the
residual stream is this rank's segment: the embedding's partial sums are
reduce-scattered onto it, each layer runs sequence-parallel or on the
segment alone, the loss gathers the sequence before the head, and a
prefill's last position comes from the last segment's rank. The
reference's logits are split on the sequence there instead (ROADMAP
Queue C). Plain tensors run the plain code.

Training (``mode="train"`` under autograd) recomputes each layer in
backward (``remat``, the reference's ``jax.checkpoint`` of its scanned
layer body: here ``torch.utils.checkpoint`` around each layer of the
Python loop), and :func:`chunked_xent_loss` recomputes each chunk's
logits, so that neither the layers' activations nor the [B, S, V]
logits are held at once. The MoE layers' load-balancing loss is summed
over the layers in every mode and added to the loss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.execution import resolve_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (current_split, flat_tree,
                                              logical_constraint, tree_map,
                                              tree_map_with_path)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RW
from repro_torch.models.layers import Params

FAMILIES = ("ssm", "hybrid", "dense", "moe", "audio", "vlm")

# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree: one ``unbind`` per
    leaf (views; a held leaf unbinds its local block). Under autograd
    each leaf's layers then share one backward node that stacks their
    gradients, where indexing each layer would add ``n`` zero-padded
    [L, ...] copies."""
    per_leaf = {k: a.unbind(0) for k, a in flat_tree(tree).items()}
    return [tree_map_with_path(lambda k, _: per_leaf[k][i], tree)
            for i in range(n)]


def _remat(on: bool, fn: Callable, *args):
    """``fn(*args)``; with ``on``, its activations are recomputed in
    backward instead of saved (``torch.utils.checkpoint``)."""
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


def _stack(trees: list):
    """A list of equal trees -> one tree of [len, ...] leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}): want one of "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack_init(fn: Callable[[], Params], n: int) -> Params:
    """Make n layers with ``fn`` and stack every leaf on a leading axis,
    one layer at a time into the stacked leaves; each layer is freed
    once copied, and a stack of one is its layer's views."""
    layer = fn()
    if n == 1:
        return tree_map(lambda a: a[None], layer)
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), layer)
    for i in range(n):
        if i:
            layer = fn()
        tree_map(lambda o, a: o[i].copy_(a), out, layer)
        del layer
    return out


def _init_norm(cfg: ArchConfig, device: torch.device) -> Params:
    return (L.init_layernorm if cfg.norm_style == "layernorm"
            else L.init_rmsnorm)(cfg.d_model, device)


def _init_attn_block(cfg: ArchConfig, gen: Optional[torch.Generator],
                     device: torch.device) -> Params:
    return {"ln1": _init_norm(cfg, device),
            "attn": (L.init_mla if cfg.mla else L.init_attention)(
                cfg, gen, device),
            "ln2": _init_norm(cfg, device)}


def _init_dense_layer(cfg: ArchConfig, gen: Optional[torch.Generator],
                      device: torch.device,
                      d_ff: Optional[int] = None) -> Params:
    p = _init_attn_block(cfg, gen, device)
    p["mlp"] = L.init_mlp(cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_style, gen,
                          device)
    return p


def _init_moe_layer(cfg: ArchConfig, gen: Optional[torch.Generator],
                    device: torch.device) -> Params:
    p = _init_attn_block(cfg, gen, device)
    p["moe"] = MOE.init_moe(cfg, gen, device)
    return p


def _init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                 device: torch.device) -> Params:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {"final_norm": _init_norm(cfg, device)}
    if cfg.n_codebooks:
        params["embed_codebooks"] = L._embed_init(
            gen, (cfg.n_codebooks, v, d), device)
        params["lm_heads"] = L._dense_init(gen, (cfg.n_codebooks, d, v),
                                           device)
    else:
        params["embed"] = L.init_embedding(v, d, gen, device)
        if not cfg.tie_embeddings:
            params["lm_head"] = L._dense_init(gen, (d, v), device)
    if cfg.family == "ssm":                       # rwkv6
        params["layers"] = _stack_init(
            lambda: RW.init_rwkv_block(cfg, gen, device), cfg.n_layers)
    elif cfg.family == "hybrid":                  # zamba2
        params["mamba"] = _stack_init(
            lambda: M2.init_mamba2_block(cfg, gen, device), cfg.n_layers)
        shared = _init_dense_layer(cfg, gen, device)
        # the reference's names for the unstacked shared block
        params["shared_attn_block"] = {
            "ln1": shared["ln1"], "shared_attn": shared["attn"],
            "ln2": shared["ln2"], "shared_mlp": shared["mlp"]}
    elif cfg.moe is not None:                     # deepseek-v3 / qwen3-moe
        nd = cfg.moe.n_dense_layers
        if nd:
            dff = cfg.moe.d_ff_dense or cfg.d_ff
            params["dense_layers"] = _stack_init(
                lambda: _init_dense_layer(cfg, gen, device, dff), nd)
        params["layers"] = _stack_init(
            lambda: _init_moe_layer(cfg, gen, device), cfg.n_layers - nd)
    else:                                         # dense / audio / vlm
        params["layers"] = _stack_init(
            lambda: _init_dense_layer(cfg, gen, device), cfg.n_layers)
    return params


def init_model(cfg: ArchConfig, generator: Optional[torch.Generator],
               device: str | torch.device | None = None) -> Params:
    """Random parameters drawn from ``generator`` directly on ``device``
    (``None``: the card; see
    :func:`~repro_torch.core.execution.resolve_device`), which must be
    the generator's device. The distributions are the reference's
    (truncated-normal fan-in dense weights in bf16, N(0, 0.02^2)
    embeddings); the bits differ from ``jax.random``'s.

    ``device="meta"`` gives the tree's shapes and dtypes alone, with no
    memory and ``generator`` unread (the reference's ``jax.eval_shape``
    of its ``init_model``): a full config's parameter count."""
    if device is not None and torch.device(device).type == "meta":
        return _init_params(cfg, None, torch.device("meta"))
    dev = resolve_device(device)
    if generator.device != dev:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {dev}: make the generator on "
                         f"{dev}")
    return _init_params(cfg, generator, dev)


def params_from_numpy(np_tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None) -> Params:
    """Carry the reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) across: every key and shape checked against
    :func:`init_model`'s tree, float32 and bfloat16 leaves kept in their
    dtype, on ``device`` (``None``: the card)."""
    want = _init_params(cfg, None, torch.device("meta"))

    def carry(w, got, path):
        if isinstance(w, dict):
            if not isinstance(got, dict) or set(got) != set(w):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"params{path} keys {have} != {sorted(w)}")
            return {k: carry(w[k], got[k], f"{path}[{k!r}]") for k in w}
        a = np.asarray(got)
        if a.shape != tuple(w.shape):
            raise ValueError(f"params{path} shape {a.shape} != "
                             f"{tuple(w.shape)}")
        if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
            return torch.from_numpy(np.array(a).view(np.uint16)).view(
                torch.bfloat16)
        if a.dtype != np.float32:
            raise ValueError(f"params{path} dtype {a.dtype}: want float32 "
                             f"or bfloat16")
        return torch.from_numpy(np.array(a))

    out = carry(want, np_tree, "")
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), out)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 sp: Optional[TP.Group] = None) -> torch.Tensor:
    """tokens [B, S] (or [B, S, K] over K codebooks) -> x [B, S, D]. The
    codebooks' rows are summed in float32 and rounded once with the
    sinusoidal positions (``positions`` [S] or [B, S]; arange(S) if
    None) added, as XLA's fusion of the reference's chain computes it.
    A codebook table held split on its codebooks (``Plan.books``) sums
    this rank's codebooks' rows, and the float32 partial sums are
    reduced over the group before that one rounding. ``sp``: ``tokens``
    is this rank's segment of sequences split over the tensor group, and
    so is x; a table split over that group looks up the gathered
    sequence's tokens, and its partial sums are reduce-scattered onto the
    segment (``tensor_parallel.scatter_to``)."""
    if cfg.n_codebooks:
        group = TP.group_of(params, "embed_codebooks")
        tbl = TP.use(params["embed_codebooks"])       # [K (/ n), V, D]
        first = 0 if group is None else group.index * tbl.shape[0]
        if group is not None and sp is not None:
            tokens = TP.seq_join(tokens, sp)
        x = sum(L.embed(tbl[k], tokens[..., first + k]).to(torch.float32)
                for k in range(tbl.shape[0]))
        x = (TP.reduce_from(x, group) if group is None or sp is None
             else TP.scatter_to(x, sp))
        dtype = tbl.dtype
    else:
        group = TP.group_of(params, "embed")
        tbl = TP.use(params["embed"])
        if group is not None and sp is not None:
            tokens = TP.seq_join(tokens, sp)
        x = (L.embed(tbl, tokens) if group is None
             else TP.vocab_embed(tbl, tokens, group, sp))
        dtype = x.dtype
    if cfg.pos_embed == "sinusoidal":
        pos = (positions if positions is not None
               else torch.arange(x.shape[1], device=x.device))
        x = x + _sinusoidal(pos, cfg.d_model).to(dtype)
    return logical_constraint(x.to(dtype), "batch", "seq", None)


def _sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding of integer positions [..., S] -> [..., S, D]
    float32: sin on the even features, cos on the odd."""
    half = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    angle = pos[..., None].to(torch.float32) / torch.pow(10000.0, half / d)
    out = torch.empty((*pos.shape, d), device=pos.device)
    out[..., 0::2] = torch.sin(angle)
    out[..., 1::2] = torch.cos(angle)
    return out


def unembed_hidden(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   gathered: bool = False) -> torch.Tensor:
    """x [B, S, D] -> logits float32 [B, S, V] (or [B, S, K, V], one
    head per codebook); a head held split over the vocabulary gives this
    rank's [B, S, V / n] ([B, S, K, V / n]). ``gathered``: x is the
    sequence gathered from its segments (``tensor_parallel.seq_whole``,
    whose backward sums the ranks' shares), so it enters the head without
    ``copy_to``."""
    if cfg.n_codebooks:
        heads = params["lm_heads"]
        x = TP.copy_to(x, None if gathered else TP.group_of(heads))
        logits = torch.einsum("bsd,kdv->bskv", x.to(torch.float32),
                              TP.use(heads).to(torch.float32))
        return logical_constraint(logits, "batch", "seq", None, "tensor")
    tied = cfg.tie_embeddings
    head = params["embed"] if tied else params["lm_head"]
    logits = L.unembed(TP.use(head), TP.copy_to(
        x, None if gathered else TP.group_of(head)), tied)
    return logical_constraint(logits, "batch", "seq", "tensor")


def _norm(p, x, cfg):
    return L.apply_norm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward — mode "train" | "prefill" | "decode"
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ForwardOut:
    hidden: torch.Tensor            # [B, S, D] final-normed hidden states
    aux: torch.Tensor               # scalar aux loss (MoE balance; else 0)
    state: Optional[dict]           # decode state (prefill/decode modes)


def default_positions(cfg: ArchConfig, batch: int, s: int,
                      device: torch.device,
                      cache_len: Optional[torch.Tensor] = None,
                      start: int = 0) -> torch.Tensor:
    """The reference's positions when none are given: arange(S), after
    ``cache_len`` in decode (a 0-dim tensor, read on the device), from
    ``start`` on a sequence segment; for M-RoPE the same in all three
    streams, [3, B, S]."""
    pos = torch.arange(start, start + s, device=device)
    if cache_len is not None:
        pos = cache_len + pos
    return pos.expand(3, batch, s) if cfg.mrope_sections else pos


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            mode: str = "train",
            state: Optional[dict] = None,
            remat: bool = True,
            kernels: bool = True,
            unroll_decode: bool = False) -> ForwardOut:
    """The model over ``tokens`` [B, S] ([B, S, K] codebook ids for
    ``audio``); ``positions`` [S] or [B, S] ([3, B, S] for M-RoPE),
    :func:`default_positions` if None. ``remat``: in ``train`` mode
    under autograd, each layer is recomputed in backward (the same bits
    as without). ``kernels=False`` runs a prefill on the card through
    the chunked einsum forms instead of the CUDA kernels (the path the
    kernels are held to). ``unroll_decode``: a transformer's decode
    returns its caches as per-layer lists (see
    :func:`_forward_transformer`).

    Under a ruled train step that splits the sequences
    (``tensor_parallel.Plan.seq``), ``tokens`` is this rank's segment:
    its positions start at the segment's offset, attention gathers the
    K/V of the segments before it (MLA its normed latent and RoPE key),
    the MoE routes the whole batch's routing groups, and the recurrences
    take their carries from them (:func:`~repro_torch.models.layers.
    attention`, :func:`~repro_torch.models.layers.mla_attention`,
    ``moe.moe_mlp``, ``rwkv.rwkv_block``, ``mamba2.mamba2_block``).

    Under a ruled train or prefill step that splits them over the tensor
    group (``Plan.sp``), ``tokens`` (and ``positions``) are this rank's
    segment and so is the residual stream, the hidden states returned
    included: each layer runs sequence-parallel around its
    tensor-parallel region, or on its segment alone (``tensor_parallel``'s
    module docstring); the layers get the whole sequence's positions."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: want train, prefill or decode")
    _check_family(cfg)
    params = TP.hold(params, cfg)
    b, s = tokens.shape[:2]
    cache_len = state["len"] if (mode == "decode" and state is not None
                                 and "len" in state) else None
    seq, sp = TP.seq_groups() if mode != "decode" else (None, None)
    if seq is not None and mode != "train":
        raise ValueError(f"a {mode} splits its sequences over the tensor "
                         f"axis only, not {seq.dim!r}")
    whole = None          # under sp, the positions the layers see
    if sp is not None:
        whole = (default_positions(cfg, b, s * sp.size, tokens.device)
                 if positions is None else TP.seq_join(positions, sp, -1))
        if positions is None:
            positions = TP.narrow_seq(whole, sp, -1)
    elif positions is None:
        positions = default_positions(cfg, b, s, tokens.device, cache_len,
                                      0 if seq is None else seq.index * s)
    emb_pos = positions
    if mode == "decode" and cfg.pos_embed == "sinusoidal":
        emb_pos = cache_len + torch.arange(s, device=tokens.device)
    if sp is not None:
        positions = whole

    x = embed_tokens(params, cfg, tokens, emb_pos, sp)
    ck = remat and mode == "train" and torch.is_grad_enabled()
    cap = None if mode == "train" else TP.capacity_group(params, cfg)
    if cfg.family == "ssm":
        x, aux, new_state = _forward_rwkv(params, cfg, x, mode, state,
                                          kernels, ck, seq, sp)
    elif cfg.family == "hybrid":
        x, aux, new_state = _forward_hybrid(params, cfg, x, positions, mode,
                                            state, kernels, ck, cap, seq, sp)
    else:
        x, aux, new_state = _forward_transformer(params, cfg, x, positions,
                                                 mode, state, unroll_decode,
                                                 ck, cap, seq, sp)
    x = _norm(TP.use(params["final_norm"]), x, cfg)
    if new_state is not None and cache_len is not None:
        new_state["len"] = cache_len + s
    return ForwardOut(x, aux, new_state)


# -- transformers: dense, moe, audio, vlm ---------------------------------


def _attn_mlp_block(lp: Params, x, cfg, *, positions, kv=None,
                    cache_len=None, moe_layer=False, return_kv=False,
                    cap=None, seq=None, split=None, sp=None):
    """Pre-norm attention (MLA where ``cfg.mla``) + MLP or MoE. Returns
    (x, aux, new_kv); aux is the MoE layer's balance loss, else None.
    Held leaves are gathered here, and the attention, MLP and experts run
    in shards over the groups their leaves are held split over; ``cap``:
    the K/V (or MLA's latent) cache's capacity is split over that group;
    ``seq``: ``x`` is this rank's segment of sequences split over that
    group; ``split``: the MoE's batch split (None: the active one; a
    remat'd layer gets the forward's, since its recompute may run on
    autograd's device thread, which sees no active split); ``sp``: ``x``
    is this rank's segment of sequences split over the tensor group,
    ``positions`` the whole sequence's (each sub-layer sequence-parallel
    around its region, or on the segment alone)."""
    tp_attn = TP.group_of(lp, "attn", "wq" if not cfg.mla else "wq_b")
    tp_mlp = TP.group_of(lp, "mlp", "w_down")
    ep = TP.group_of(lp, "moe", "w_gate")
    a2a = TP.exchange_of(lp, "moe", "w_gate")
    tp_shared = TP.group_of(lp, "moe", "shared", "w_down")
    lp = TP.use(lp)
    if cfg.mla:
        h, new_kv = L.mla_attention(
            lp["attn"], _norm(lp["ln1"], x, cfg), cfg, positions=positions,
            kv_cache=kv, cache_len=cache_len, return_kv=return_kv,
            tp=tp_attn, cap=cap, seq=seq, sp=sp)
    else:
        h, new_kv = L.attention(
            lp["attn"], _norm(lp["ln1"], x, cfg), cfg, positions=positions,
            kv_cache=kv, cache_len=cache_len, return_kv=return_kv,
            tp=tp_attn, cap=cap, seq=seq, sp=sp)
    x = logical_constraint(x + h, "batch", "seq", None)
    if moe_layer:
        y, aux = MOE.moe_mlp(lp["moe"], _norm(lp["ln2"], x, cfg), cfg,
                             ep=ep, a2a=a2a, shared_tp=tp_shared,
                             split=split, sp=sp, seq=seq)
    else:
        y = L.mlp(lp["mlp"], _norm(lp["ln2"], x, cfg), cfg.mlp_style,
                  tp_mlp, sp)
        aux = None
    return logical_constraint(x + y, "batch", "seq", None), aux, new_kv


def _train_layer(lp: Params, x, cfg, positions, moe_layer, seq=None,
                 split=None, sp=None):
    return _attn_mlp_block(lp, x, cfg, positions=positions,
                           moe_layer=moe_layer, seq=seq, split=split,
                           sp=sp)[:2]


def _cache_keys(cfg: ArchConfig) -> tuple[str, str]:
    return ("latent", "krope") if cfg.mla else ("k", "v")


def _transformer_parts(cfg: ArchConfig) -> list[tuple[str, str, int, bool]]:
    """(state part, params stack, layers, MoE layers?) in order: the
    ``moe`` family's leading dense layers, then the main stack."""
    nd = cfg.moe.n_dense_layers if cfg.moe else 0
    parts = [("dense", "dense_layers", nd, False)] if nd else []
    return parts + [("main", "layers", cfg.n_layers - nd, cfg.moe is not None)]


def _forward_transformer(params, cfg, x, positions, mode, state, unroll, ck,
                         cap=None, seq=None, sp=None):
    """Each stack's layers in a Python loop: the leading dense layers
    (``"dense"``, the ``moe`` family's), then the main stack (``"main"``).
    Prefill returns each part's cache as ``state[part]`` = {"k", "v"}
    ([L, B, S, Hkv, Dh] bf16), or MLA's {"latent", "krope"} ([L, B, S,
    r] and [L, B, S, rope_d] bf16). Decode reads layer i's cache as
    ``state[part]["k"][i]``, which is a view of a stacked [L, ...] cache
    or element i of a per-layer list (the reference's
    ``_decode_transformer_unrolled`` layout,
    ``init_decode_state(unrolled=True)``), and writes the new entries in
    place either way; the returned state holds the given caches, as
    per-layer lists when ``unroll``. The reference unrolls its decode so
    that XLA stops copying the stacked cache per layer; here the stacked
    cache is already written in place, so both layouts run the same ops
    and give the same bits. The aux losses are summed over the layers in
    every mode (the reference's unrolled decode keeps only its last
    layer's, ROADMAP Queue C). ``ck``: each training layer is recomputed
    in backward. ``cap``: the K/V (or latent) caches hold this rank's
    capacity rows over that group (:func:`~repro_torch.models.layers.
    attention`, :func:`~repro_torch.models.layers.mla_attention`);
    ``seq``: a training ``x`` is this rank's segment over that group;
    ``sp``: a training or prefill ``x`` is its segment over the tensor
    group (:func:`_attn_mlp_block`)."""
    decode = mode == "decode"
    cache_len = state["len"] if decode else None
    keys = _cache_keys(cfg)
    aux = torch.zeros((), device=x.device)
    new_state = {}
    split = current_split()
    for part, stack, n, moe_layer in _transformer_parts(cfg):
        layers = _unstack(params[stack], n)
        if mode == "train":
            for lp in layers:
                x, a = _remat(ck, _train_layer, lp, x, cfg, positions,
                              moe_layer, seq, split, sp)
                aux = aux + a if moe_layer else aux
            continue
        cache = state[part] if decode else None
        caches = ([], [])
        for i, lp in enumerate(layers):
            x, a, kv = _attn_mlp_block(
                lp, x, cfg, positions=positions,
                kv=tuple(cache[k][i] for k in keys) if decode else None,
                cache_len=cache_len, moe_layer=moe_layer,
                return_kv=mode == "prefill", cap=cap, sp=sp)
            aux = aux + a if moe_layer else aux
            if mode == "prefill":
                for c, t in zip(caches, kv):
                    c.append(t)
        if decode:
            new_state[part] = {k: list(cache[k]) if unroll else cache[k]
                               for k in keys}
        else:
            new_state[part] = {k: torch.stack(c) for k, c in zip(keys, caches)}
    return x, aux, (None if mode == "train" else new_state)


# -- rwkv ---------------------------------------------------------------------


def _rwkv_groups(lp: Params) -> tuple:
    """(time mix heads, channel mix d_ff) groups of a held layer."""
    return (TP.group_of(lp, "time_mix", "wr"),
            TP.group_of(lp, "channel_mix", "wv"))


def _rwkv_train_layer(lp: Params, x, cfg, kernels, seq=None, sp=None):
    tp, ffn = _rwkv_groups(lp)
    st = RW.init_rwkv_state(cfg, x.shape[0], device=x.device, tp=tp)
    return RW.rwkv_block(TP.use(lp), x, cfg, st, kernels=kernels, tp=tp,
                         ffn_tp=ffn, seq=seq, sp=sp)[0]


def _forward_rwkv(params, cfg, x, mode, state, kernels, ck, seq=None,
                  sp=None):
    """The RWKV-6 layers; each layer's time mix over its heads' group and
    channel mix over its d_ff's (held leaves), the ``wkv`` state this
    rank's heads; ``seq``: a training ``x`` is this rank's segment;
    ``sp``: a training or prefill ``x`` is its segment over the tensor
    group (``rwkv.rwkv_block``)."""
    b = x.shape[0]
    layers = _unstack(params["layers"], cfg.n_layers)
    aux = torch.zeros((), device=x.device)
    if mode == "train":
        for lp in layers:
            x = _remat(ck, _rwkv_train_layer, lp, x, cfg, kernels, seq, sp)
        return x, aux, None
    sts = []
    for i, lp in enumerate(layers):
        tp, ffn = _rwkv_groups(lp)
        lp = TP.use(lp)
        if mode == "decode":
            x, st = RW.rwkv_block(lp, x, cfg, _layer(state["rwkv"], i),
                                  single_step=True, tp=tp, ffn_tp=ffn)
        else:
            x, st = RW.rwkv_block(lp, x, cfg,
                                  RW.init_rwkv_state(cfg, b, device=x.device,
                                                     tp=tp),
                                  kernels=kernels, tp=tp, ffn_tp=ffn, sp=sp)
        sts.append(st)
    return x, aux, {"rwkv": _stack(sts)}


# -- zamba2 hybrid -------------------------------------------------------------


def _hybrid_layout(cfg: ArchConfig):
    period = cfg.attn_layer_period or 6
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return period, n_groups, tail


def _shared_block(sh: Params, x, cfg, positions, kv=None, cache_len=None,
                  return_kv=False, cap=None, seq=None, sp=None):
    """The ONE shared attention + MLP block, in shards over the groups
    its held leaves are split over (``cap``: the K/V cache's capacity
    split over that group; ``seq``: ``x`` this rank's segment; ``sp``:
    its segment over the tensor group, as in :func:`_attn_mlp_block`).
    Returns (x, new_kv)."""
    tp_attn = TP.group_of(sh, "shared_attn", "wq")
    tp_mlp = TP.group_of(sh, "shared_mlp", "w_down")
    sh = TP.use(sh)
    h, new_kv = L.attention(sh["shared_attn"], _norm(sh["ln1"], x, cfg), cfg,
                            positions=positions, kv_cache=kv,
                            cache_len=cache_len, return_kv=return_kv,
                            tp=tp_attn, cap=cap, seq=seq, sp=sp)
    x = x + h
    x = x + L.mlp(sh["shared_mlp"], _norm(sh["ln2"], x, cfg), cfg.mlp_style,
                  tp_mlp, sp)
    return logical_constraint(x, "batch", "seq", None), new_kv


def _mamba_train_layer(lp: Params, x, cfg, kernels, seq=None, sp=None):
    tp = TP.group_of(lp, "out_proj")
    st = M2.init_mamba2_state(cfg, x.shape[0], x.device, tp)
    return M2.mamba2_block(TP.use(lp), x, cfg, st, kernels=kernels,
                           tp=tp, seq=seq, sp=sp)[0]


def _shared_train(sh: Params, x, cfg, positions, seq=None, sp=None):
    return _shared_block(sh, x, cfg, positions, seq=seq, sp=sp)[0]


def _forward_hybrid(params, cfg, x, positions, mode, state, kernels, ck,
                    cap=None, seq=None, sp=None):
    """Groups of ``period`` Mamba-2 layers, each followed by the ONE
    shared attention + MLP block, then the tail layers. Decode writes the
    shared block's K/V caches of ``state`` in place (see
    :func:`repro_torch.models.layers.attention`). ``ck``: each training
    Mamba-2 layer and each call of the shared block is recomputed in
    backward. Held leaves compute each Mamba-2 layer over its heads'
    group (its state this rank's heads) and the shared block as
    :func:`_attn_mlp_block` does; ``cap``, ``seq``, ``sp``: as there."""
    b = x.shape[0]
    period, n_groups, tail = _hybrid_layout(cfg)
    sh = params["shared_attn_block"]
    decode = mode == "decode"
    cache_len = state["len"] if decode else None
    layers = _unstack(params["mamba"], cfg.n_layers)
    aux = torch.zeros((), device=x.device)
    if mode == "train":
        for g in range(n_groups):
            for lp in layers[g * period:(g + 1) * period]:
                x = _remat(ck, _mamba_train_layer, lp, x, cfg, kernels, seq,
                           sp)
            x = _remat(ck, _shared_train, sh, x, cfg, positions, seq, sp)
        for lp in layers[n_groups * period:]:
            x = _remat(ck, _mamba_train_layer, lp, x, cfg, kernels, seq, sp)
        return x, aux, None

    def mamba_layer(x, i):
        tp = TP.group_of(layers[i], "out_proj")
        st = (_layer(state["mamba"], i) if decode
              else M2.init_mamba2_state(cfg, b, x.device, tp))
        return M2.mamba2_block(TP.use(layers[i]), x, cfg, st,
                               single_step=decode, kernels=kernels, tp=tp,
                               sp=sp)

    g_states, kvs = [], []
    for g in range(n_groups):
        grp = []
        for j in range(period):
            x, st = mamba_layer(x, g * period + j)
            grp.append(st)
        g_states.append(grp)
        x, kv = _shared_block(
            sh, x, cfg, positions,
            kv=(state["k"][g], state["v"][g]) if decode else None,
            cache_len=cache_len, return_kv=mode == "prefill", cap=cap, sp=sp)
        kvs.append(kv)
    t_states = []
    for j in range(tail):
        x, st = mamba_layer(x, n_groups * period + j)
        t_states.append(st)
    if decode:
        k, v = state["k"], state["v"]
    else:
        k = torch.stack([kv[0] for kv in kvs])
        v = torch.stack([kv[1] for kv in kvs])
    return x, aux, {"mamba": _cat_group_tail(g_states, t_states or None),
                    "k": k, "v": v}


def _cat_group_tail(g_states: list, t_states: Optional[list]) -> dict:
    """Per-layer states of the groups ([NG][P]) and of the tail -> one
    tree of [L, ...] leaves, in layer order."""
    flat = [st for grp in g_states for st in grp]
    return _stack(flat + (t_states or []))


# ---------------------------------------------------------------------------
# Decode-state allocation
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, capacity: int,
                      device: str | torch.device | None = None,
                      unrolled: bool = False) -> dict:
    """Zero-initialized decode state with K/V capacity ``capacity``: the
    reference's keys, leaf shapes and dtypes, on ``device`` (``None``:
    the card). A transformer's state holds a cache per part (``"dense"``
    for the ``moe`` family's leading dense layers, then ``"main"``):
    {"k", "v"} of [L, B, C, Hkv, Dh], or MLA's {"latent", "krope"} of
    [L, B, C, r] and [L, B, C, rope_d], all bf16. ``unrolled``: those
    caches as per-layer LISTS of [B, C, ...] tensors, each its own
    buffer (the recurrent families have no per-layer cache and ignore
    it, as the reference does). ``device="meta"`` gives the shapes and
    dtypes alone (the reference's ``jax.eval_shape`` of it)."""
    _check_family(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    if cfg.family not in ("ssm", "hybrid"):
        if cfg.mla:
            shapes = {"latent": (batch, capacity, cfg.mla.kv_lora_rank),
                      "krope": (batch, capacity, cfg.mla.qk_rope_head_dim)}
        else:
            kv = (batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
            shapes = {"k": kv, "v": kv}
        st = {"len": length}
        for part, _, n, _ in _transformer_parts(cfg):
            st[part] = {k: ([torch.zeros(sh, **bf16) for _ in range(n)]
                            if unrolled else torch.zeros((n, *sh), **bf16))
                        for k, sh in shapes.items()}
        return st
    if cfg.family == "ssm":
        hd = cfg.ssm.head_dim
        h = cfg.d_model // hd
        lz = cfg.n_layers
        return {"rwkv": {
            "tm_x": torch.zeros((lz, batch, cfg.d_model), **bf16),
            "cm_x": torch.zeros((lz, batch, cfg.d_model), **bf16),
            "wkv": torch.zeros((lz, batch, h, hd, hd), device=dev)},
            "len": length}
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    _, n_groups, _ = _hybrid_layout(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"mamba": {
        "ssm": torch.zeros((cfg.n_layers, batch, h, s.head_dim, s.d_state),
                           device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, s.d_conv - 1,
                             d_inner + 2 * s.d_state), **bf16)},
        "k": torch.zeros((n_groups, batch, capacity, hkv, dh), **bf16),
        "v": torch.zeros((n_groups, batch, capacity, hkv, dh), **bf16),
        "len": length}


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy) and public entry points
# ---------------------------------------------------------------------------


def _head_group(params: Params, cfg: ArchConfig):
    """The group the (held) head is split over on the vocabulary, or
    None."""
    return TP.group_of(params, "lm_heads" if cfg.n_codebooks else
                       "embed" if cfg.tie_embeddings else "lm_head")


def _xent_chunk(params: Params, cfg: ArchConfig, h: torch.Tensor,
                labels: torch.Tensor, gathered: bool = False
                ) -> torch.Tensor:
    """Summed NLL of one chunk: h [B, C, D], labels [B, C] (or [B, C, K]);
    over a head held split on the vocabulary, :func:`~repro_torch.
    distributed.tensor_parallel.vocab_nll` of this rank's logits (of
    every codebook at once). ``gathered``: as :func:`unembed_hidden`'s."""
    logits = unembed_hidden(params, cfg, h, gathered)
    group = _head_group(params, cfg)
    if group is not None:
        return TP.vocab_nll(logits, labels, group)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long()).sum()


def chunked_xent_loss(params: Params, cfg: ArchConfig, hidden: torch.Tensor,
                      labels: torch.Tensor, chunk: int = 512,
                      sp: Optional[TP.Group] = None) -> torch.Tensor:
    """Next-token CE over the sequence in chunks of ``chunk`` tokens (the
    largest that divides S, at most ``chunk``: the reference's choice).

    hidden [B, S, D]; labels [B, S] integer (or [B, S, K] over K
    codebooks, one head each). Under autograd each chunk
    is recomputed in backward: only the hidden chunk is saved, and the
    float32 [B, C, V] logits exist for one chunk at a time. Returns the
    summed NLL over ``labels.numel()``, float32.

    ``sp``: ``hidden`` and ``labels`` are this rank's segment of
    sequences split over the tensor group. The segments are gathered
    (``tensor_parallel.seq_whole``: the backward reduce-scatters) and
    every rank computes the whole sequence's loss, through its
    vocabulary shard of a split head; a head that does not split counts
    it once (``count_once``).
    """
    if sp is not None:
        hidden, labels = TP.seq_whole(hidden, sp), TP.seq_join(labels, sp)
    s = hidden.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    params = TP.hold(params, cfg)
    ck = torch.is_grad_enabled()
    total = torch.zeros((), device=hidden.device)
    for lo in range(0, s, chunk):
        total = total + _remat(ck, _xent_chunk, params, cfg,
                               hidden[:, lo:lo + chunk],
                               labels[:, lo:lo + chunk], sp is not None)
    if sp is not None and _head_group(params, cfg) is None:
        total = TP.count_once(total, sp)
    return total / labels.numel()


def loss_fn(params: Params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, loss_chunk: int = 512) -> tuple:
    """batch: {"tokens", "labels", optional "positions"} -> (loss,
    {"ce", "aux"}): the training forward and :func:`chunked_xent_loss`.
    Under a split over the tensor group (``tensor_parallel.Plan.sp``) the
    loss is the whole sequences' on every rank of it: the MoE's aux,
    computed on the gathered tokens, counts once (``count_once``)."""
    params = TP.hold(params, cfg)
    out = forward(params, cfg, batch["tokens"],
                  positions=batch.get("positions"), mode="train",
                  remat=remat)
    sp = TP.seq_groups()[1]
    ce = chunked_xent_loss(params, cfg, out.hidden, batch["labels"],
                           chunk=loss_chunk, sp=sp)
    aux = TP.count_once(out.aux, sp)
    return ce + aux, {"ce": ce, "aux": aux}


def full_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                remat: bool = False, kernels: bool = True) -> tuple:
    """Small-scale helper (tests): full [B, S, V] (or [B, S, K, V])
    logits and the aux loss. ``remat``: under autograd each layer is
    recomputed in backward (the reference's keyword; the same bits)."""
    params = TP.hold(params, cfg)
    out = forward(params, cfg, tokens, positions=positions, mode="train",
                  remat=remat, kernels=kernels)
    sp = TP.seq_groups()[1]
    if sp is None:
        return unembed_hidden(params, cfg, out.hidden), out.aux
    return unembed_hidden(params, cfg, TP.seq_whole(out.hidden, sp),
                          True), out.aux


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: dict, *, positions: Optional[torch.Tensor] = None,
                unroll: bool = False) -> tuple:
    """One decode step. tokens [B, 1] ([B, 1, K]) -> (logits [B, 1, V]
    ([B, 1, K, V]), state). The recurrent leaves of the returned state
    are new tensors; a ``hybrid`` or transformer state's caches are the
    given ones, written in place. ``unroll``: a transformer's state comes
    back with per-layer cache lists (the reference's unrolled decode)."""
    params = TP.hold(params, cfg)
    out = forward(params, cfg, tokens, positions=positions, mode="decode",
                  state=state, unroll_decode=unroll)
    return unembed_hidden(params, cfg, out.hidden), out.state


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            kernels: bool = True) -> tuple:
    """Prompt pass: (last-position logits [B, 1, V], decode state with
    K/V capacity == prompt length). Under a split over the tensor group
    (``tensor_parallel.Plan.sp``) ``tokens`` is this rank's segment: the
    last position's hidden state is the last segment's rank's, gathered
    to every rank before the head, and the state is the whole prompt's
    in the placement the ruled decode reads."""
    params = TP.hold(params, cfg)
    out = forward(params, cfg, tokens, positions=positions, mode="prefill",
                  kernels=kernels)
    sp = TP.seq_groups()[1]
    last = (out.hidden[:, -1:] if sp is None
            else TP.last_rows(out.hidden, 1, sp))
    logits = unembed_hidden(params, cfg, last)
    st = out.state
    st["len"] = torch.tensor(tokens.shape[1] * (1 if sp is None
                                                else sp.size),
                             dtype=torch.int32, device=tokens.device)
    return logits, st
