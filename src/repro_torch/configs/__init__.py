"""Config registry for the language models; port of
``repro/configs/__init__.py``.

``get_config(name)`` / ``get_reduced(name)`` know the ported archs,
``rwkv6-3b`` (family ``ssm``) and ``zamba2-7b`` (family ``hybrid``). The
reference's other eight names raise a ``KeyError`` saying the family is
not ported yet (ROADMAP Queue A item 8); any other name raises as in the
reference.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, smoke_shape

_MODULES = {
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}
# the reference's other archs and their families, none ported yet
_NOT_PORTED = {
    "stablelm-12b": "dense", "glm4-9b": "dense", "chatglm3-6b": "dense",
    "qwen2-1.5b": "dense", "musicgen-medium": "audio",
    "deepseek-v3-671b": "moe", "qwen3-moe-30b-a3b": "moe",
    "qwen2-vl-7b": "vlm",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name in _NOT_PORTED:
        raise KeyError(f"arch {name!r} (family {_NOT_PORTED[name]!r}) is not "
                       f"ported yet; see ROADMAP Queue A item 8")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "SHAPES",
           "ShapeSpec", "applicable", "smoke_shape", "ARCH_NAMES",
           "get_config", "get_reduced"]
