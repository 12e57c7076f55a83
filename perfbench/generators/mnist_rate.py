"""``mnist_rate``: digits rendered as the port's synthetic MNIST does
(``repro_torch/data/mnist.py``: per-class strokes, an affine jitter,
pixel noise), written again with NumPy arrays in place of the per-pixel
loops, and rate-coded as ``repro_torch/snn/train.py``'s ``rate_encode``
does (one Bernoulli draw per pixel and step)."""
from __future__ import annotations

import numpy as np


# stroke control points in a [0, 1]^2 box (x right, y down), per digit
DIGIT_STROKES: dict[int, list[list[tuple[float, float]]]] = {
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


def render_digit(digit: int, rng: np.random.Generator, size: int = 28
                 ) -> np.ndarray:
    """One [size, size] digit in [0, 1]: each stroke's segments sampled
    three points a pixel, each point lighting its four neighbours by
    ``thick`` less the distance, the brightest point kept."""
    img = np.zeros((size, size), np.float32)
    ang = rng.uniform(-0.25, 0.25)
    sc = rng.uniform(0.8, 1.1)
    dx, dy = rng.uniform(-2.0, 2.0, size=2)
    ca, sa = np.cos(ang), np.sin(ang)
    thick = rng.uniform(0.9, 1.5)
    for stroke in DIGIT_STROKES[digit]:
        pts = np.array(stroke, np.float32)
        pts = pts + rng.normal(0, 0.015, pts.shape).astype(np.float32)
        xy = (pts - 0.5) * sc
        xr = xy[:, 0] * ca - xy[:, 1] * sa
        yr = xy[:, 0] * sa + xy[:, 1] * ca
        px = (xr + 0.5) * (size - 8) + 4 + dx
        py = (yr + 0.5) * (size - 8) + 4 + dy
        xs, ys = [], []
        for i in range(len(px) - 1):
            n = max(int(np.hypot(px[i + 1] - px[i], py[i + 1] - py[i]) * 3),
                    2)
            ts = np.linspace(0, 1, n)
            xs.append(px[i] + ts * (px[i + 1] - px[i]))
            ys.append(py[i] + ts * (py[i + 1] - py[i]))
        x, y = np.concatenate(xs), np.concatenate(ys)
        for ox in (0, 1):
            for oy in (0, 1):
                xi = np.floor(x).astype(np.int64) + ox
                yi = np.floor(y).astype(np.int64) + oy
                ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
                w = np.clip(thick - np.hypot(x - xi, y - yi), 0.0, 1.0)
                np.maximum.at(img, (yi[ok], xi[ok]), w[ok].astype(np.float32))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def generate(rng: np.random.Generator, n: int, timesteps: int,
               n_inputs: int, n_classes: int = 10
               ) -> tuple[np.ndarray, np.ndarray]:
    size = int(round(np.sqrt(n_inputs)))
    if size * size != n_inputs:
        raise ValueError(f"mnist_rate needs a square image, got {n_inputs}")
    ys = rng.integers(0, n_classes, n).astype(np.int32)
    imgs = np.stack([render_digit(int(y), rng, size).reshape(-1)
                     for y in ys])
    trains = rng.random((n, timesteps, n_inputs), np.float32) < imgs[:, None]
    return trains.astype(np.uint8), ys
