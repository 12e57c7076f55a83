"""Config registry for the language models; port of
``repro/configs/__init__.py``.

``get_config(name)`` / ``get_reduced(name)`` know the reference's ten
archs, in its order: the ``dense`` GQA transformers (``stablelm-12b``,
``glm4-9b``, ``chatglm3-6b``, ``qwen2-1.5b``), ``musicgen-medium``
(``audio``: codebooks, sinusoidal positions), ``rwkv6-3b`` (``ssm``),
``zamba2-7b`` (``hybrid``), the ``moe`` pair ``deepseek-v3-671b`` (MLA,
a shared expert, leading dense layers) and ``qwen3-moe-30b-a3b``, and
``qwen2-vl-7b`` (``vlm``: M-RoPE). Any other name raises a ``KeyError``,
as in the reference. ``all_cells()`` is the reference's grid of every
applicable (arch, shape) pair.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, smoke_shape

_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def all_cells() -> list[tuple[str, str]]:
    """All applicable (arch, shape) pairs: the dry-run grid, 32 cells
    (the reference's docstring says 40)."""
    return [(a, s) for a in ARCH_NAMES for s in SHAPES
            if applicable(get_config(a), s)]


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "SHAPES",
           "ShapeSpec", "applicable", "smoke_shape", "ARCH_NAMES",
           "get_config", "get_reduced", "all_cells"]
