"""Per-(arch x shape) sharding strategy; port of
``repro/launch/strategy.py`` (the same profiles, rules and
hyperparameters, with torch dtypes).

SupraSNN's partitioner maps synapses to SPUs maximizing balance subject
to the Unified-Memory constraint Eq. (9). Here the "synapses" are
parameter tiles, the "SPUs" are cards, and the constraint is device
memory. The most-balanced feasible mapping is picked per workload:

  fsdp   batch + params sharded over EVERY card (ZeRO-3), no tensor
         parallelism: the regime for <= 13B dense models at 1M-token
         batches.
  tp_ep  2D: batch over 'data', tensor + expert over 'model': the regime
         for MoE and for inference.

Shape kind selects the train or inference strategy; family selects fsdp
or tp_ep for training. The port's ruled steps hold parameters and
optimizer state with these rules' placements and compute as they imply
(``distributed/tensor_parallel.py``): each layer's leaves gathered where
it runs over the ``fsdp`` / ``batch`` axes; under tp_ep, GQA and MLA
attention, the MLPs, the Mamba-2 and RWKV-6 heads and the vocabulary
tensor-parallel over ``model`` and the MoE expert-parallel over it,
without an all-to-all; under tp_ep_full each card owns whole experts
(``("model", "data")``) and the MoE moves the tokens to them and back
by an all-to-all over ``data``, gathering no expert; under the
multi-pod fsdp rules each rank trains its segment of every sequence
(``seq`` on ``pod``), the K/V (MLA's latent and RoPE key) and the
recurrent states gathered from the segments before it, the MoE's routing
groups routed where each lies within a segment or gathered whole: every
family, qwen3-moe and deepseek-v3 under ``--profile fsdp`` (their
default ``tp_ep`` rules keep ``seq`` None). Under tp_ep the codebook
heads are vocabulary-parallel over ``model`` and the codebook embeddings
codebook-parallel where ``model`` divides them, and MLA's latent cache
is held on its capacity rows over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import MeshRules
from repro_torch.train.steps import TrainHParams


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    logical_rules: dict
    hparams: TrainHParams


def _rules(profile: str, multi_pod: bool) -> dict:
    if profile == "fsdp":
        if multi_pod:
            # global batch (256) < devices (512): shard the batch over one
            # pod's cards and the SEQUENCE over the pod axis
            return {"batch": ("data", "model"),
                    "fsdp": ("pod", "data", "model"), "tensor": None,
                    "expert": None, "seq": "pod", "kv_heads": None}
        all_axes = ("data", "model")
        return {"batch": all_axes, "fsdp": all_axes, "tensor": None,
                "expert": None, "seq": None, "kv_heads": None}
    if profile == "tp_ep":
        batch = ("pod", "data") if multi_pod else "data"
        fsdp = ("pod", "data") if multi_pod else "data"
        return {"batch": batch, "fsdp": fsdp, "tensor": "model",
                "expert": "model", "seq": None, "kv_heads": "model"}
    if profile == "tp_ep_full":
        # experts sharded over EVERY card (model x data = whole-expert
        # ownership): expert weights are never fsdp-gathered
        batch = ("pod", "data") if multi_pod else "data"
        return {"batch": batch, "fsdp": ("pod", "data") if multi_pod
                else "data", "tensor": "model",
                "expert": ("model", "data"), "seq": None,
                "kv_heads": "model"}
    if profile == "tp_serve":
        # inference wants stationary weights: tensor-sharded over 'model',
        # replicated over 'data'
        batch = ("pod", "data") if multi_pod else "data"
        return {"batch": batch, "fsdp": None, "tensor": "model",
                "expert": "model", "seq": None, "kv_heads": "model"}
    raise ValueError(profile)


def pick_strategy(cfg: ArchConfig, shape: ShapeSpec, *,
                  multi_pod: bool = False,
                  override_profile: Optional[str] = None,
                  override_micro: Optional[int] = None) -> Strategy:
    """Default = the feasible, balance-max choice per cell."""
    is_moe = cfg.moe is not None
    if shape.kind == "train":
        profile = override_profile or ("tp_ep" if is_moe else "fsdp")
        # microbatches: sized so that the remat'd layer-boundary
        # activations fit
        if override_micro is not None:
            n_micro = override_micro
        elif cfg.name.startswith("deepseek"):
            n_micro = 8
        elif is_moe:
            n_micro = 4
        else:
            n_micro = 1
        hp = TrainHParams(
            n_micro=n_micro,
            accum_dtype=(torch.bfloat16 if cfg.name.startswith("deepseek")
                         else torch.float32),
            quantized_opt_state=cfg.name.startswith("deepseek"),
            loss_chunk=512)
    else:
        profile = override_profile or "tp_ep"
        hp = TrainHParams()
    return Strategy(profile, _rules(profile, multi_pod), hp)


def make_mesh_rules(mesh, strategy: Strategy) -> MeshRules:
    return MeshRules(mesh, strategy.logical_rules)
