"""Input spike trains made from the seed by the generator a
configuration names under ``inputs.generator``, found by name in
``generators/<generator>.py`` (a function ``generate(rng, n, timesteps,
n_inputs, **params) -> (trains uint8 [n, T, n_inputs], labels)``). The
copies keep the benchmark's inputs fixed whatever the program's own data
modules become."""
from __future__ import annotations

import numpy as np

from pathlib import Path

from perfbench import spec


def make_pool(root: Path, cfg: dict, rng: np.random.Generator,
              n: int) -> np.ndarray:
    """``n`` input trains of configuration ``cfg`` as int32 [n, T,
    n_inputs], the form the port's launch drivers pass."""
    params = dict(cfg["inputs"])
    gen = spec.generator(root, params.pop("generator"))
    trains, _ = gen.generate(rng, n, cfg["timesteps"], cfg["layer_sizes"][0],
                             **params)
    return trains.astype(np.int32)
