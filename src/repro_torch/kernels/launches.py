"""The kernel wrappers' launch counters, safe across threads.

Each wrapper keeps its count in its own ``launches`` attribute
(``fused_step.launches``, ...) and adds to it through
:func:`count_launch`, under one lock: the sharded runner launches from
one thread per card, and a plain ``+= 1`` from two threads can lose a
count. Reading a count, or setting it to 0 between runs, is a plain
attribute access. A CUDA graph capture launches nothing: inside
:func:`recording` the current thread's counts go into a dict (the
launches the graph recorded, which each replay adds back) instead.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

_LOCK = threading.Lock()
# thread ident -> that thread's recording; empty, the launch path's one
# extra test is this dict's truth value
_RECORDING: dict[int, dict] = {}


def count_launch(kernel, n: int = 1) -> None:
    """Add ``n`` launches to ``kernel.launches`` (to the current
    thread's recording instead, inside :func:`recording`)."""
    if _RECORDING:
        rec = _RECORDING.get(threading.get_ident())
        if rec is not None:
            rec[kernel] = rec.get(kernel, 0) + n
            return
    with _LOCK:
        kernel.launches += n


@contextlib.contextmanager
def recording() -> Iterator[dict]:
    """Collect the current thread's launches into the yielded dict
    (kernel wrapper -> count) instead of the wrappers' counters."""
    ident = threading.get_ident()
    prev = _RECORDING.get(ident)
    _RECORDING[ident] = rec = {}
    try:
        yield rec
    finally:
        if prev is None:
            del _RECORDING[ident]
        else:
            _RECORDING[ident] = prev
