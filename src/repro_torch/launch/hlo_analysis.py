"""Per-device cost of one run of a function: FLOPs, HBM bytes, collective
bytes and the peak of live bytes; port of ``repro/launch/hlo_analysis.py``.

The file keeps the reference's name and its public :func:`analyze` so
that the port mirrors the JAX package file for file, though there is no
HLO here. The reference parses the post-SPMD HLO text of a compiled
program and walks its call graph with while-loop trip multipliers,
because XLA's ``cost_analysis`` counts a scan body once. The port has no
compiled program and no scan: its layers and chunks are Python loops, so
every iteration dispatches its ops, and counting each op as it runs
needs no multiplier. :func:`analyze` runs the function once under a
``TorchDispatchMode`` of its own and counts, per device (each rank's
local tensors; a DTensor op is counted through the local ops it runs):

* **FLOPs** of the dot-like aten ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the convolutions and attention kernels), by
  ``torch.utils.flop_counter``'s formulas; the reference counts dot FLOPs
  only. ``flops_by_op`` splits them by the aten op's name;
* **HBM bytes**: each op's operands and result. The port runs eager and
  unfused, so every op is a kernel and the reference's fused-operand
  rule has no counterpart. Views and metadata ops move nothing (the
  reference's ``_NO_TRAFFIC``), nor do allocations; ``index_select``,
  ``gather``, ``embedding`` and ``index`` count twice the window they
  read, ``index_copy(_)`` and ``index_put(_)`` twice the window they
  write, and ``copy_`` its source and destination (twice the window
  when the dtypes agree): the reference's dynamic-slice and
  dynamic-update-slice rules. ``bytes_by_op`` is keyed by the aten op's
  name;
* **collectives**: result bytes per kind, over the reference's
  ``COLLECTIVE_OPS`` names, for the functional collectives DTensor and
  the ruled steps run (``_c10d_functional``, its ``all_to_all_single``
  the MoE's token exchange; ``_dtensor.shard_dim_alltoall``, DTensor's
  all-to-all) and the ``c10d`` ops of ``torch.distributed``'s own calls;
* **live bytes**: torch has no ``memory_analysis()``. The mode tracks
  the distinct storages alive (a view shares its base's storage and
  counts once; the trees passed in are the arguments, a DTensor by its
  local shard) through a weak reference to each storage, and reports
  the arguments' bytes and the peak over the run.

The CUDA kernels launch through ctypes (``kernels/_build.py``), below
any dispatch mode: an analysis of a run that launched one would miss its
work. :func:`analyze` reads the kernel wrappers' launch counters before
and after the run and raises ``RuntimeError`` naming any that moved.

A DTensor op's sharding propagation runs the op once more on fake
tensors of the global shape; ops on fake tensors are not counted.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# views, metadata and allocations: no HBM traffic
_NO_TRAFFIC = {
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice",
    "select", "as_strided", "unsqueeze", "squeeze", "detach", "alias",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense",
}
_READ_WINDOW = {"index_select", "gather", "embedding", "index"}
_WRITE_WINDOW = {"index_copy": 3, "index_copy_": 3, "index_put": 2,
                 "index_put_": 2}       # op -> the argument written
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
_NO_COLLECTIVE = {"wait_tensor", "barrier", "monitored_barrier_",
                  "_wrap_tensor_autograd"}
_COLLECTIVE_KIND = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                    ("send", "collective-permute"),
                    ("recv", "collective-permute"))


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _is_fake(t) -> bool:
    return type(t).__name__ == "FakeTensor"


def tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, lists and tuples (named
    tuples included), each DTensor as its local shard. (A loop, not a
    recursive closure: a closure's cycle would keep the tensors alive
    until the garbage collector ran.)"""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x.to_local() if _is_dtensor(x) else x)
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
    return out


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum_bytes(tree) -> int:
    return sum(nbytes(t) for t in tensors(tree))


def collective_kind(name: str) -> str | None:
    """The reference's name for a collective aten op (None: the op moves
    nothing between devices); raises on a collective it cannot name, so
    that none goes uncounted."""
    if name in _NO_COLLECTIVE:
        return None
    for part, kind in _COLLECTIVE_KIND:
        if part in name:
            return kind
    raise NotImplementedError(f"collective op {name!r} has no kind in "
                              f"{COLLECTIVE_OPS}")


class LiveBytes:
    """The bytes of distinct storages alive, and their peak. A storage
    is added when a tensor on it is first seen, and leaves when torch
    frees it (a weak reference to the storage's Python object, which
    torch keeps as long as the storage lives)."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._live: dict[int, int] = {}

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        old = self._live.get(key)
        if old is None:
            weakref.finalize(st, self._free, key).atexit = False
            old = 0
        self._live[key] = n
        self.now += n - old
        self.peak = max(self.peak, self.now)

    def _free(self, key: int) -> None:
        self.now -= self._live.pop(key, 0)


def _zero() -> dict:
    return {"flops": 0.0, "bytes": 0.0, "bytes_by_op": {},
            "flops_by_op": {}, "coll": {op: {"count": 0, "bytes": 0.0}
                     for op in COLLECTIVE_OPS}}


class CostMode(TorchDispatchMode):
    """Counts every op that runs under it into ``self.acc`` (the
    reference's keys) and the live storages into ``self.live``."""

    def __init__(self):
        super().__init__()
        self.acc = _zero()
        self.live = LiveBytes()
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented      # DTensor runs local ops, counted
        out = func(*args, **kwargs)
        ins = tensors((args, {k: v for k, v in kwargs.items()
                              if k != "out"}))
        if any(_is_fake(t) for t in ins):
            return out                 # DTensor's sharding propagation
        outs = tensors(out)
        for t in ins + outs:
            self.live.add(t)
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        self.n_ops += 1
        acc = self.acc
        name = func._schema.name.split("::")[-1]
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            f = float(flops(*args, **kwargs, out_val=out))
            acc["flops"] += f
            acc["flops_by_op"][name] = acc["flops_by_op"].get(name, 0.0) + f
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = collective_kind(name)
            if kind is None:
                return
            acc["coll"][kind]["count"] += 1
            acc["coll"][kind]["bytes"] += float(_sum_bytes(out))
        elif func.is_view or name in _NO_TRAFFIC:
            return
        if name in _READ_WINDOW:
            tb = 2 * _sum_bytes(out)
        elif name in _WRITE_WINDOW:
            tb = 2 * nbytes(args[_WRITE_WINDOW[name]])
        elif name == "copy_":
            tb = nbytes(args[0]) + nbytes(args[1])
        else:
            tb = sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        acc["bytes"] += tb
        acc["bytes_by_op"][name] = acc["bytes_by_op"].get(name, 0.0) + tb


def _kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by name."""
    from repro_torch.kernels.fused_step import fused_run, fused_step
    from repro_torch.kernels.lif_update import (lif_update, lif_update_bwd,
                                                lif_update_int)
    from repro_torch.kernels.spike_accum import spike_accum
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    fns = (fused_run, fused_step, lif_update, lif_update_bwd,
           lif_update_int, spike_accum, ssd, wkv6)
    return {f.__name__: f for f in fns}


def analyze(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once and count it: ``(result,
    counts)``. ``counts`` has the reference's keys (``flops``,
    ``bytes``, ``bytes_by_op``, ``coll`` with ``{kind: {"count",
    "bytes"}}`` and ``total_bytes``), all per device, ``flops_by_op``,
    and
    ``argument_bytes`` (the distinct storages of the arguments),
    ``peak_bytes`` (the most bytes of distinct storages alive at once,
    the arguments included) and ``ops`` (the ops counted). Raises
    ``RuntimeError`` if a CUDA kernel launched during the run: its work
    is invisible to the count."""
    counters = _kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    mode = CostMode()
    for t in tensors((args, kwargs)):
        mode.live.add(t)
    argument_bytes = mode.live.now
    with mode:
        result = fn(*args, **kwargs)
    moved = [k for k, f in counters.items() if f.launches != before[k]]
    if moved:
        raise RuntimeError(f"kernels {moved} launched during the analysed "
                           f"run: a dispatch mode does not see ctypes "
                           f"launches, so their work would be uncounted")
    acc = mode.acc
    acc["coll"]["total_bytes"] = sum(
        v["bytes"] for k, v in acc["coll"].items() if isinstance(v, dict))
    acc.update(argument_bytes=argument_bytes, peak_bytes=mode.live.peak,
               ops=mode.n_ops)
    return result, acc
