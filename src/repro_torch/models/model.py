"""The causal LM of the ``ssm`` (rwkv6-3b) and ``hybrid`` (zamba2-7b)
families; port of ``repro/models/model.py``.

One model definition driven by ``ArchConfig``. Parameters keep the
reference's tree: every layer's leaves STACKED on a leading [L] axis, so
:func:`params_from_numpy` carries the reference's parameters across as
they are. Where the reference scans the stack with ``lax.scan``, the
port loops over the layers in Python and indexes each leaf (a view, no
copy). Three modes share the code: ``train`` (the stateless forward,
behind :func:`full_logits`), ``prefill`` (emit the decode state for the
whole prompt) and ``decode`` (one token, O(1) recurrent state, plus the
shared attention's K/V cache for ``hybrid``). A prefill on the card
runs the recurrences through the ``wkv6`` / ``ssd`` CUDA kernels, one
launch per layer; on the CPU it runs the chunked einsum forms, as the
reference's model does; decode runs the single-step recurrences in
plain torch, as the reference does. The sharding constraints of the
reference fall away on one card.

Other families (dense, MoE/MLA, audio, VLM) and the loss are not ported
yet (ROADMAP Queue A item 8); they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.execution import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv as RW
from repro_torch.models.layers import NOT_PORTED, Params

FAMILIES = ("ssm", "hybrid")

# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of a nested dict (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    return tree_map(lambda a: a[i], tree)


def _stack(trees: list):
    """A list of equal trees -> one tree of [len, ...] leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is "
                                  f"{NOT_PORTED}")
    if cfg.n_codebooks or cfg.mrope_sections or cfg.moe or cfg.mla \
            or cfg.pos_embed != "rope" or cfg.norm_style != "rmsnorm":
        raise NotImplementedError(f"{cfg.name}: codebooks, M-RoPE, MoE, "
                                  f"MLA, sinusoidal positions and layernorm "
                                  f"are {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack_init(fn: Callable[[], Params], n: int) -> Params:
    """Make n layers with ``fn`` and stack every leaf on a leading axis,
    one layer at a time into the stacked leaves."""
    first = fn()
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else fn()
        tree_map(lambda o, a: o[i].copy_(a), out, layer)
    return out


def _init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                 device: torch.device) -> Params:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {"final_norm": L.init_rmsnorm(d, device),
                      "embed": L.init_embedding(v, d, gen, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (d, v), device)
    if cfg.family == "ssm":                       # rwkv6
        params["layers"] = _stack_init(
            lambda: RW.init_rwkv_block(cfg, gen, device), cfg.n_layers)
    else:                                         # zamba2
        params["mamba"] = _stack_init(
            lambda: M2.init_mamba2_block(cfg, gen, device), cfg.n_layers)
        params["shared_attn_block"] = {
            "ln1": L.init_rmsnorm(d, device),
            "shared_attn": L.init_attention(cfg, gen, device),
            "ln2": L.init_rmsnorm(d, device),
            "shared_mlp": L.init_mlp(d, cfg.d_ff, cfg.mlp_style, gen,
                                     device)}
    return params


def init_model(cfg: ArchConfig, generator: torch.Generator,
               device: str | torch.device | None = None) -> Params:
    """Random parameters drawn from ``generator`` directly on ``device``
    (``None``: the card; see
    :func:`~repro_torch.core.execution.resolve_device`), which must be
    the generator's device. The distributions are the reference's
    (truncated-normal fan-in dense weights in bf16, N(0, 0.02^2)
    embeddings); the bits differ from ``jax.random``'s."""
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


def embed_tokens(params: Params, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens [B, S] -> x [B, S, D]."""
    return L.embed(params["embed"], tokens)


def unembed_hidden(params: Params, cfg: ArchConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """x [B, S, D] -> logits float32 [B, S, V]."""
    tied = cfg.tie_embeddings
    return L.unembed(params["embed"] if tied else params["lm_head"], x, tied)


def _norm(p, x, cfg):
    return L.apply_norm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward — mode "train" | "prefill" | "decode"
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ForwardOut:
    hidden: torch.Tensor            # [B, S, D] final-normed hidden states
    aux: torch.Tensor               # scalar aux loss (0: no MoE here)
    state: Optional[dict]           # decode state (prefill/decode modes)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            mode: str = "train",
            state: Optional[dict] = None,
            kernels: bool = True) -> ForwardOut:
    """The model over ``tokens`` [B, S]. ``kernels=False`` runs a prefill
    on the card through the chunked einsum forms instead of the CUDA
    kernels (the path the kernels are held to)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: want train, prefill or decode")
    _check_family(cfg)
    s = tokens.shape[1]
    cache_len = state["len"] if (mode == "decode" and state is not None
                                 and "len" in state) else None
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
        if mode == "decode":
            positions = cache_len + positions

    x = embed_tokens(params, cfg, tokens)
    if cfg.family == "ssm":
        x, aux, new_state = _forward_rwkv(params, cfg, x, mode, state,
                                          kernels)
    else:
        x, aux, new_state = _forward_hybrid(params, cfg, x, positions, mode,
                                            state, kernels)
    x = _norm(params["final_norm"], x, cfg)
    if new_state is not None and cache_len is not None:
        new_state["len"] = cache_len + s
    return ForwardOut(x, aux, new_state)


# -- rwkv ---------------------------------------------------------------------


def _forward_rwkv(params, cfg, x, mode, state, kernels):
    b = x.shape[0]
    sts = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if mode == "decode":
            x, st = RW.rwkv_block(lp, x, cfg, _layer(state["rwkv"], i),
                                  single_step=True)
        else:
            x, st = RW.rwkv_block(lp, x, cfg,
                                  RW.init_rwkv_state(cfg, b, device=x.device),
                                  kernels=kernels)
        sts.append(st)
    aux = torch.zeros((), device=x.device)
    return x, aux, (None if mode == "train" else {"rwkv": _stack(sts)})


# -- zamba2 hybrid -------------------------------------------------------------


def _hybrid_layout(cfg: ArchConfig):
    period = cfg.attn_layer_period or 6
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return period, n_groups, tail


def _forward_hybrid(params, cfg, x, positions, mode, state, kernels):
    """Groups of ``period`` Mamba-2 layers, each followed by the ONE
    shared attention + MLP block, then the tail layers. Decode writes the
    shared block's K/V caches of ``state`` in place (see
    :func:`repro_torch.models.layers.attention`)."""
    b = x.shape[0]
    period, n_groups, tail = _hybrid_layout(cfg)
    sh = params["shared_attn_block"]
    decode = mode == "decode"
    cache_len = state["len"] if decode else None

    def mamba_layer(x, i):
        st = (_layer(state["mamba"], i) if decode
              else M2.init_mamba2_state(cfg, b, x.device))
        return M2.mamba2_block(_layer(params["mamba"], i), x, cfg, st,
                               single_step=decode, kernels=kernels)

    g_states, kvs = [], []
    for g in range(n_groups):
        grp = []
        for j in range(period):
            x, st = mamba_layer(x, g * period + j)
            grp.append(st)
        g_states.append(grp)
        h, kv = L.attention(sh["shared_attn"], _norm(sh["ln1"], x, cfg), cfg,
                            positions=positions,
                            kv_cache=((state["k"][g], state["v"][g])
                                      if decode else None),
                            cache_len=cache_len,
                            return_kv=mode == "prefill")
        x = x + h
        x = x + L.mlp(sh["shared_mlp"], _norm(sh["ln2"], x, cfg),
                      cfg.mlp_style)
        kvs.append(kv)
    t_states = []
    for j in range(tail):
        x, st = mamba_layer(x, n_groups * period + j)
        t_states.append(st)
    aux = torch.zeros((), device=x.device)
    if mode == "train":
        return x, aux, None
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
                      device: str | torch.device | None = None) -> dict:
    """Zero-initialized decode state with K/V capacity ``capacity``: the
    reference's keys, leaf shapes and dtypes, on ``device`` (``None``:
    the card)."""
    _check_family(cfg)
    dev = resolve_device(device)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
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
# Public entry points
# ---------------------------------------------------------------------------


def full_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                kernels: bool = True) -> tuple:
    """Small-scale helper (tests): full [B, S, V] logits and the aux loss."""
    out = forward(params, cfg, tokens, positions=positions, mode="train",
                  kernels=kernels)
    return unembed_hidden(params, cfg, out.hidden), out.aux


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: dict, *, positions: Optional[torch.Tensor] = None
                ) -> tuple:
    """One decode step. tokens [B, 1] -> (logits [B, 1, V], state). The
    recurrent leaves of the returned state are new tensors; a ``hybrid``
    state's K/V caches are the given ones, written in place."""
    out = forward(params, cfg, tokens, positions=positions, mode="decode",
                  state=state)
    return unembed_hidden(params, cfg, out.hidden), out.state


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            kernels: bool = True) -> tuple:
    """Prompt pass: (last-position logits [B, 1, V], decode state with
    K/V capacity == prompt length)."""
    out = forward(params, cfg, tokens, positions=positions, mode="prefill",
                  kernels=kernels)
    logits = unembed_hidden(params, cfg, out.hidden[:, -1:])
    st = out.state
    st["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return logits, st
