"""``shd_ridges``: a copy of the port's synthetic Spiking Heidelberg
Digits generator (``repro_torch/data/shd.py``): per class three
formant-like ridges sweep over the channels, each sample jittered, over
a background rate."""
from __future__ import annotations

import numpy as np


def _shd_class_proto(cls: int, n_channels: int, timesteps: int):
    """The class's fixed ridge parameters (seeded by the class alone)."""
    r = np.random.default_rng(1234 + cls)
    n_ridges = 3
    starts = r.uniform(0.1, 0.9, n_ridges) * n_channels
    slopes = r.uniform(-2.0, 2.0, n_ridges) * n_channels / timesteps
    widths = r.uniform(15, 45, n_ridges)
    gains = r.uniform(0.25, 0.5, n_ridges)
    return starts, slopes, widths, gains


def generate(rng: np.random.Generator, n: int, timesteps: int,
               n_inputs: int, n_classes: int = 20, background: float = 0.01,
               jitter: float = 6.0) -> tuple[np.ndarray, np.ndarray]:
    ys = rng.integers(0, n_classes, n).astype(np.int32)
    t = np.arange(timesteps, dtype=np.float32)[:, None]
    ch = np.arange(n_inputs, dtype=np.float32)[None, :]
    out = np.zeros((n, timesteps, n_inputs), np.uint8)
    for i, y in enumerate(ys):
        starts, slopes, widths, gains = _shd_class_proto(int(y), n_inputs,
                                                         timesteps)
        rate = np.zeros((timesteps, n_inputs), np.float32)
        for s0, sl, w, g in zip(starts, slopes, widths, gains):
            center = s0 + sl * t + rng.normal(0, jitter)
            rate += g * np.exp(-0.5 * ((ch - center) / w) ** 2)
        rate += background
        out[i] = rng.random((timesteps, n_inputs)) < rate
    return out, ys
