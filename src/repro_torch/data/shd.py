"""Synthetic SHD-like dataset: 700 input channels (cochlear model bins),
spike trains over T timesteps, 20 classes (digits 0-9, English + German);
port of ``repro/data/shd.py`` (numpy only, the same arrays for the same
seed).

Each class is a characteristic spatio-temporal activity pattern: a set of
formant-like ridges sweeping across channels over time, with per-sample
jitter — structurally similar to the real Spiking Heidelberg Digits.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

N_CHANNELS = 700
N_CLASSES = 20


def _class_proto(cls: int, rng: np.random.Generator, timesteps: int):
    """Deterministic per-class ridge parameters."""
    r = np.random.default_rng(1234 + cls)
    n_ridges = 3
    starts = r.uniform(0.1, 0.9, n_ridges) * N_CHANNELS
    slopes = r.uniform(-2.0, 2.0, n_ridges) * N_CHANNELS / timesteps
    widths = r.uniform(15, 45, n_ridges)
    gains = r.uniform(0.25, 0.5, n_ridges)
    return starts, slopes, widths, gains


def synthetic_shd(n_train: int = 512, n_test: int = 256, timesteps: int = 100,
                  seed: int = 0):
    """Returns (spk_train [N,T,700] uint8, y_train, spk_test, y_test)."""

    def make(n, salt):
        rng = np.random.default_rng(seed + salt)
        ys = rng.integers(0, N_CLASSES, n).astype(np.int32)
        t = np.arange(timesteps, dtype=np.float32)[:, None]        # [T,1]
        ch = np.arange(N_CHANNELS, dtype=np.float32)[None, :]      # [1,C]
        out = np.zeros((n, timesteps, N_CHANNELS), np.uint8)
        for i, y in enumerate(ys):
            starts, slopes, widths, gains = _class_proto(int(y), rng, timesteps)
            rate = np.zeros((timesteps, N_CHANNELS), np.float32)
            for s0, sl, w, g in zip(starts, slopes, widths, gains):
                center = s0 + sl * t + rng.normal(0, 6.0)          # jittered
                rate += g * np.exp(-0.5 * ((ch - center) / w) ** 2)
            rate += 0.01  # background activity
            out[i] = (rng.random((timesteps, N_CHANNELS)) < rate).astype(np.uint8)
        return out, ys

    xtr, ytr = make(n_train, 1)
    xte, yte = make(n_test, 2)
    return xtr, ytr, xte, yte


def shd_batches(xs: np.ndarray, ys: np.ndarray, batch: int, seed: int = 0
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields ([T, B, 700] float32 spikes, [B] labels) — time-major."""
    rng = np.random.default_rng(seed)
    n = len(xs)
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            j = idx[i:i + batch]
            yield (xs[j].transpose(1, 0, 2).astype(np.float32), ys[j])
