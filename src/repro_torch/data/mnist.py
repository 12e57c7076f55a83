"""MNIST pipeline; port of ``repro/data/mnist.py`` (numpy only, the same
arrays for the same seed).

Nothing is fetched: by default a *synthetic* MNIST-like dataset is
generated, 28x28 grayscale digits rendered procedurally (strokes per
digit class + random affine jitter + noise). ``load_mnist`` picks up the
real IDX files if they exist under ``data_dir`` (default: ``data/mnist``
at the root of the repository).
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# Procedural digit rendering: each digit is a polyline set on a 28x28 canvas.
# ---------------------------------------------------------------------------

# Stroke control points in a [0,1]^2 box (x right, y down).
_DIGIT_STROKES: dict[int, list[list[tuple[float, float]]]] = {
    0: [[(0.5, 0.1), (0.8, 0.3), (0.8, 0.7), (0.5, 0.9), (0.2, 0.7),
         (0.2, 0.3), (0.5, 0.1)]],
    1: [[(0.35, 0.25), (0.55, 0.1), (0.55, 0.9)]],
    2: [[(0.2, 0.3), (0.4, 0.1), (0.7, 0.15), (0.75, 0.4), (0.3, 0.7),
         (0.2, 0.9), (0.8, 0.9)]],
    3: [[(0.25, 0.15), (0.7, 0.15), (0.45, 0.45), (0.75, 0.65), (0.6, 0.9),
         (0.25, 0.85)]],
    4: [[(0.65, 0.9), (0.65, 0.1), (0.2, 0.6), (0.85, 0.6)]],
    5: [[(0.75, 0.1), (0.3, 0.1), (0.25, 0.45), (0.65, 0.45), (0.75, 0.7),
         (0.55, 0.9), (0.25, 0.85)]],
    6: [[(0.7, 0.1), (0.35, 0.35), (0.25, 0.7), (0.5, 0.9), (0.75, 0.7),
         (0.55, 0.5), (0.3, 0.6)]],
    7: [[(0.2, 0.12), (0.8, 0.12), (0.45, 0.9)]],
    8: [[(0.5, 0.1), (0.75, 0.25), (0.5, 0.48), (0.25, 0.25), (0.5, 0.1)],
        [(0.5, 0.48), (0.8, 0.7), (0.5, 0.92), (0.2, 0.7), (0.5, 0.48)]],
    9: [[(0.7, 0.35), (0.45, 0.45), (0.3, 0.25), (0.5, 0.1), (0.7, 0.25),
         (0.7, 0.55), (0.55, 0.9)]],
}


def _render(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    img = np.zeros((size, size), np.float32)
    # random affine jitter
    ang = rng.uniform(-0.25, 0.25)
    sc = rng.uniform(0.8, 1.1)
    dx, dy = rng.uniform(-2.0, 2.0, size=2)
    ca, sa = np.cos(ang), np.sin(ang)
    thick = rng.uniform(0.9, 1.5)
    for stroke in _DIGIT_STROKES[digit]:
        pts = np.array(stroke, np.float32)
        # jitter control points slightly
        pts = pts + rng.normal(0, 0.015, pts.shape).astype(np.float32)
        # to pixel coords with affine
        xy = (pts - 0.5) * sc
        xr = xy[:, 0] * ca - xy[:, 1] * sa
        yr = xy[:, 0] * sa + xy[:, 1] * ca
        px = (xr + 0.5) * (size - 8) + 4 + dx
        py = (yr + 0.5) * (size - 8) + 4 + dy
        # draw line segments with supersampling
        for i in range(len(px) - 1):
            n = max(int(np.hypot(px[i + 1] - px[i], py[i + 1] - py[i]) * 3), 2)
            ts = np.linspace(0, 1, n)
            xs = px[i] + ts * (px[i + 1] - px[i])
            ys = py[i] + ts * (py[i + 1] - py[i])
            for x, y in zip(xs, ys):
                x0, y0 = int(np.floor(x)), int(np.floor(y))
                for oy in (0, 1):
                    for ox in (0, 1):
                        xi, yi = x0 + ox, y0 + oy
                        if 0 <= xi < size and 0 <= yi < size:
                            w = max(0.0, thick - np.hypot(x - xi, y - yi))
                            img[yi, xi] = max(img[yi, xi], min(1.0, w))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def synthetic_mnist(n_train: int = 2048, n_test: int = 512, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train [N,784], y_train, x_test, y_test) with x in [0,1]."""
    def make(n, salt):
        r = np.random.default_rng(seed + salt)
        ys = r.integers(0, 10, n)
        xs = np.stack([_render(int(y), r).reshape(-1) for y in ys])
        return xs.astype(np.float32), ys.astype(np.int32)

    xtr, ytr = make(n_train, 1)
    xte, yte = make(n_test, 2)
    return xtr, ytr, xte, yte


DEFAULT_DIR = Path(__file__).resolve().parents[3] / "data" / "mnist"


def load_mnist(data_dir: str | os.PathLike = DEFAULT_DIR, **synth_kw):
    """Real MNIST if IDX files are present, else the synthetic generator."""
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]

    def read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), np.uint8).reshape(dims)

    paths = []
    for n in names:
        for cand in (os.path.join(data_dir, n), os.path.join(data_dir, n + ".gz")):
            if os.path.exists(cand):
                paths.append(cand)
                break
    if len(paths) == 4:
        xtr = read_idx(paths[0]).reshape(-1, 784).astype(np.float32) / 255.0
        ytr = read_idx(paths[1]).astype(np.int32)
        xte = read_idx(paths[2]).reshape(-1, 784).astype(np.float32) / 255.0
        yte = read_idx(paths[3]).astype(np.int32)
        return xtr, ytr, xte, yte
    return synthetic_mnist(**synth_kw)


def mnist_batches(xs: np.ndarray, ys: np.ndarray, batch: int, seed: int = 0
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(xs)
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            j = idx[i:i + batch]
            yield xs[j], ys[j]
