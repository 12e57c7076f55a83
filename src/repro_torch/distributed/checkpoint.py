"""Sharded, atomic checkpoints of trees of tensors; port of
``repro/distributed/checkpoint.py``, in the same layout, so that either
package restores the other's checkpoint:

    <dir>/step_000123/
        manifest.json       leaf paths, shapes, dtypes, shard map, hashes
        shard_00000.npz     flat leaves of shard 0 (``leaf_<i>``)
        shard_00001.npz     ...
        COMMITTED           written LAST; the directory is renamed into
                            place whole, so a step directory without it
                            is garbage from a mid-save crash

* a leaf's path joins its dict keys (sorted) and list or tuple indices
  with "/"; ``None`` is no leaf (the reference's ``_tree_paths``), so an
  ``AdamState`` without scales has the reference's paths;
* bfloat16 tensors are stored as uint16 under the manifest dtype
  ``"bfloat16"`` (npz has no bf16), and a Python ``int`` leaf (the port's
  Adam ``step``) as an int32 0-d array, as the reference's step is;
* SHA-256 per shard detects bitrot and truncation;
* :class:`CheckpointManager` copies the tree to the host, then writes on
  a background thread and keeps the newest K checkpoints.

One process here: "host-group" = one shard, as in the reference.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

_EXOTIC = {torch.bfloat16: ("bfloat16", np.uint16)}   # torch dtype -> npz
_FROM_SAVED = {name: dt for dt, (name, _) in _EXOTIC.items()}


def _items(tree, path: tuple = ()) -> list:
    """(path, leaf) for every leaf, in the reference's order: dict keys
    sorted, list and tuple indices, ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in _items(tree[k],
                                                          path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _items(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _rebuild(like, leaves: dict, path: tuple = ()):
    """``like``'s structure with each leaf taken from ``leaves`` by path."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        kids = [_rebuild(v, leaves, path + (str(i),))
                for i, v in enumerate(like)]
        if isinstance(like, list):
            return kids
        return type(like)(*kids) if hasattr(like, "_fields") \
            else type(like)(kids)
    return leaves["/".join(path)]


def _host(leaf, copy: bool = False):
    """A leaf as what is saved: a CPU tensor (with ``copy``, always a
    copy, so that a later in-place update cannot reach it) or a numpy
    array (an ``int`` as int32)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(_host(leaf).dtype)


def _to_savable(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _EXOTIC:
            return leaf.view(torch.int16).numpy().view(_EXOTIC[leaf.dtype][1])
        return leaf.numpy()
    return np.asarray(leaf)


def _from_saved(arr: np.ndarray, dtype_name: str, like):
    """The stored array as a leaf of ``like``'s kind: a tensor on
    ``like``'s device (in the stored dtype), or an ``int``."""
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    if dtype_name in _FROM_SAVED and str(arr.dtype) != dtype_name:
        t = torch.from_numpy(arr.view(np.int16)).view(_FROM_SAVED[dtype_name])
    else:
        t = torch.from_numpy(arr)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(directory: str, step: int, tree, *,
                    n_shards: int = 1, extra: Optional[dict] = None) -> str:
    """Write one checkpoint. Returns the committed step directory."""
    items = _items(tree)
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        manifest = {"step": step, "n_shards": n_shards,
                    "extra": extra or {}, "leaves": [], "shard_hash": {}}
        assign = [i % n_shards for i in range(len(items))]
        for i, (p, leaf) in enumerate(items):
            manifest["leaves"].append(
                {"path": p, "shape": list(leaf.shape) if hasattr(
                    leaf, "shape") else list(np.shape(leaf)),
                 "dtype": _dtype_name(leaf), "shard": assign[i]})
        for s in range(n_shards):
            payload = {f"leaf_{i}": _to_savable(_host(leaf))
                       for i, (_, leaf) in enumerate(items)
                       if assign[i] == s}
            fn = os.path.join(tmp, f"shard_{s:05d}.npz")
            np.savez(fn, **payload)
            manifest["shard_hash"][str(s)] = _sha256(fn)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp, step_dir)        # atomic commit
        return step_dir
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    """Newest COMMITTED step in the directory (crash-partial dirs skipped)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, "COMMITTED")):
            s = int(name.split("_")[1])
            best = s if best is None else max(best, s)
    return best


def load_checkpoint(directory: str, step: Optional[int], like_tree, *,
                    verify: bool = True) -> tuple[Any, dict]:
    """Restore into the structure of ``like_tree``. Returns (tree, extra).

    The stored leaves are matched BY PATH; a shape that differs from the
    target leaf's raises. Each tensor comes back in its stored dtype on
    the device of the target leaf; an ``int`` leaf comes back an int.
    ``step=None``: the newest committed step.
    """
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no committed checkpoint under {directory}"
    step_dir = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    shards = {}
    for s in range(manifest["n_shards"]):
        fn = os.path.join(step_dir, f"shard_{s:05d}.npz")
        if verify:
            assert _sha256(fn) == manifest["shard_hash"][str(s)], \
                f"shard {s} hash mismatch (corrupt checkpoint)"
        shards[s] = np.load(fn)

    stored = {meta["path"]: (i, meta)
              for i, meta in enumerate(manifest["leaves"])}
    out = {}
    for p, like in _items(like_tree):
        assert p in stored, f"checkpoint missing leaf {p}"
        i, meta = stored[p]
        arr = shards[meta["shard"]][f"leaf_{i}"]
        want = tuple(like.shape) if hasattr(like, "shape") \
            else np.shape(like)
        assert tuple(arr.shape) == want, f"{p}: ckpt {arr.shape} != " \
                                         f"target {want}"
        out[p] = _from_saved(arr, meta["dtype"], like)
    for z in shards.values():
        z.close()
    return _rebuild(like_tree, out), manifest["extra"]


class CheckpointManager:
    """Async save + retention. ``save`` copies the tree to the host, then
    returns; the write happens on a daemon thread (training does not
    wait for the disk). A failed write raises on the next ``save`` or
    ``wait``."""

    def __init__(self, directory: str, *, keep: int = 3, n_shards: int = 1):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             blocking: bool = False):
        self.wait()
        snapshot = _rebuild(tree, {p: _host(leaf, copy=True)
                                   for p, leaf in _items(tree)})

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot,
                                n_shards=self.n_shards, extra=extra)
                self._gc()
            except BaseException as e:   # surfaced on next save/wait
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def restore(self, like_tree, step: Optional[int] = None):
        return load_checkpoint(self.directory, step, like_tree)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and
            os.path.exists(os.path.join(self.directory, n, "COMMITTED")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
