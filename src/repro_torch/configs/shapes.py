"""Input shapes shared by the LM archs; port of ``repro/configs/shapes.py``.

`train_4k` / `prefill_32k` are prefill-shaped; `decode_32k` /
`long_500k` are single new tokens against a cache of ``seq_len``.
`long_500k` needs sub-quadratic attention: only archs with
``sub_quadratic=True`` (rwkv6-3b, zamba2-7b) run it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(arch_cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return bool(arch_cfg.sub_quadratic)
    return True


def smoke_shape(kind: str = "train") -> ShapeSpec:
    """Tiny variant for CPU smoke tests."""
    if kind == "train":
        return ShapeSpec("smoke_train", 32, 2, "train")
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", 32, 2, "prefill")
    return ShapeSpec("smoke_decode", 64, 2, "decode")
