"""Data-parallel execution of a compiled ``Program`` over several
devices; port of ``repro/serve/sharded.py``.

The batched engine (:class:`~repro_torch.core.engine_torch
.TorchMappedEngine`) is embarrassingly parallel over the batch axis —
every sample runs the same lowered program on its own spike train, all
in exact int32 arithmetic. :class:`ShardedRunner` exploits that: it
cuts the batch into ``n_shards`` contiguous slices, one per entry of
the spec's mesh (a tuple of device strings), and runs each slice on
that device's engine — the program's own single-device engine for it
(``program.engine``), one per device however often the device repeats.

Why the result is bit-exact vs the single-device engine:

* each shard runs the same step loop on its rows — there is no
  cross-sample communication, reduction, or reordering;
* all arithmetic is int32 (deterministic-commit property, paper §4.2),
  so shard boundaries cannot perturb any value;
* ragged batches are handled by **pad-and-mask**: the batch is padded
  with all-zero samples up to the next multiple of the shard count,
  and the pad rows are sliced away (masked) from spikes, potentials,
  and packet counts before stats are computed — zero-input pad samples
  never touch the real rows.

Tiny batches don't shard well: below ``n_shards * min_shard`` real
samples, :meth:`ShardedRunner.run` routes the batch through the
program's single-device engine (on the mesh's first device) —
bit-exact by the argument above, just cheaper. ``min_shard=0``
disables the fallback (conformance tests use it to force the true
shard path at every size).

The port has no counterpart of ``shard_map``. Shards on the same device
run one after another; shards on distinct devices run concurrently, one
thread per device, each thread first making its device current (the
kernels' ctypes launches take the CUDA runtime's current device and
torch's current stream). A card's shard never moves to the CPU. On the
CPU, ``mesh=("cpu",) * k`` gives ``k`` sequential shards — the tests'
stand-in for the reference's forced host devices.

The kernel wrappers' launch counters are plain process-wide integers:
shards that run concurrently on distinct cards may lose an increment
(only a multi-card host runs them so); shards on one device count
exactly.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.engine_torch import (finalize_outputs,
                                           normalize_ext_spikes)
from repro_torch.core.execution import (AUTO_MESH, ExecutionSpec,
                                        spec_from_legacy_kwargs)
from repro_torch.kernels import _build


class ShardedRunner:
    """A ``Program`` run data-parallel over the devices of a mesh.

    :meth:`run` serves any batch — including ragged ones that do not
    divide the shard count — with outputs bit-exact vs
    ``program.run(ext)`` on one device. ``spec`` is an
    :class:`~repro_torch.core.execution.ExecutionSpec` (``mesh=None``
    means ``"auto"`` here); ``mesh`` is the bare-mesh form (``"auto"``
    or a tuple of device strings). The ``nu_kernel=``/``interpret=``
    kwargs are the deprecated pre-spec surface.
    """

    def __init__(self, program, mesh=None, *,
                 spec: ExecutionSpec | None = None,
                 nu_kernel: bool | None = None,
                 interpret: bool | None = None, min_shard: int = 1):
        if nu_kernel is not None or interpret is not None:
            if spec is not None:
                raise TypeError("pass spec= OR the deprecated nu_kernel=/"
                                "interpret= kwargs, not both")
            spec = spec_from_legacy_kwargs(
                sharded=True, mesh=mesh, nu_kernel=nu_kernel,
                interpret=interpret, where="ShardedRunner", stacklevel=3)
        elif spec is None:
            spec = ExecutionSpec(mesh=mesh if mesh is not None else AUTO_MESH)
        elif mesh is not None:
            raise TypeError("pass the mesh inside spec=, not alongside it")
        if spec.mesh is None:
            spec = dataclasses.replace(spec, mesh=AUTO_MESH)
        spec = spec.resolve()
        self.spec = spec
        self.mesh = spec.mesh
        self.n_shards = len(self.mesh)
        self.min_shard = int(min_shard)
        base = spec.single_device()
        # the fallback IS the program's owned engine on the first device;
        # shard i runs on the owned engine of mesh[i] (the same object
        # wherever a device repeats)
        self._engine = program.engine(base)
        self._shard_engines = [
            program.engine(dataclasses.replace(base, device=d))
            for d in self.mesh]
        # each distinct device's engine and its shards' indices, in order
        self._groups: dict[str, tuple] = {}
        for i, (d, eng) in enumerate(zip(self.mesh, self._shard_engines)):
            self._groups.setdefault(d, (eng, []))[1].append(i)
        self._n_inputs = self._engine.lowered.n_inputs
        self._warm: set[tuple[int, int]] = set()

    def padded_size(self, b: int) -> int:
        """Next multiple of the shard count (the pad-and-mask bucket)."""
        d = self.n_shards
        return ((b + d - 1) // d) * d

    def _use_fallback(self, b: int) -> bool:
        """True when ``b`` real samples go single-device (see module
        docstring): fewer than ``min_shard`` samples per shard."""
        return b < self.n_shards * self.min_shard

    # -- warm-up ------------------------------------------------------------

    def precompile(self, batch_sizes, timesteps: int
                   ) -> list[tuple[int, int]]:
        """Prepare every serving shape, mirroring :meth:`run`'s routing:
        fallback-sized buckets prepare the single-device engine, the
        rest prepare each device's engine at the PER-SHARD size of their
        padded batch (so two buckets padding to the same multiple are
        prepared once). On the card that captures one CUDA graph per
        device and shape (``TorchMappedEngine.precompile``). Returns the
        ``(padded batch, T)`` shapes prepared by this call.
        """
        done = []
        for b in batch_sizes:
            b = int(b)
            if self._use_fallback(b):
                done.extend(self._engine.precompile([b], timesteps))
                continue
            key = (self.padded_size(b), int(timesteps))
            if key in self._warm:
                continue
            per = key[0] // self.n_shards
            for eng, _ in self._groups.values():
                eng.precompile([per], timesteps)
            self._warm.add(key)
            done.append(key)
        return done

    # -- public API ---------------------------------------------------------

    def run(self, ext_spikes: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Execute the program on ``ext_spikes`` across the mesh.

        ext_spikes: binary ``[T, n_inputs]`` or ``[B, T, n_inputs]``;
        returns ``(spikes, v_final, stats)`` shaped exactly like the
        single-device engine (pad rows are sliced away before stats).
        """
        ext, squeeze = normalize_ext_spikes(ext_spikes, self._n_inputs)
        b, t = ext.shape[0], ext.shape[1]
        if self._use_fallback(b):
            return self._engine.run(ext_spikes)
        full = self.padded_size(b)
        if full != b:                      # pad: all-zero samples
            pad = np.zeros((full - b, t, self._n_inputs), ext.dtype)
            ext = np.concatenate([ext, pad])
        per = full // self.n_shards
        shards = [ext[i * per:(i + 1) * per] for i in range(self.n_shards)]
        groups = list(self._groups.values())
        if len(groups) == 1:
            outs = _run_on_device(groups[0][0], shards)
        else:
            outs = [None] * self.n_shards
            with ThreadPoolExecutor(max_workers=len(groups)) as pool:
                futures = [(idx, pool.submit(_run_on_device, eng,
                                             [shards[i] for i in idx]))
                           for eng, idx in groups]
                for idx, fut in futures:
                    for i, out in zip(idx, fut.result()):
                        outs[i] = out
        spikes = np.concatenate([o[0] for o in outs])
        v = np.concatenate([o[1] for o in outs])
        pkts = np.concatenate([o[2]["packet_counts"] for o in outs])
        # mask: drop the pad rows before any stats are derived
        return finalize_outputs(spikes[:b], v[:b], pkts[:b], squeeze)


def _run_on_device(engine, shards: list) -> list:
    """Run ``shards`` one after another on ``engine``, its device made
    current first (the thread of a distinct device starts on device 0)."""
    with _build.on_device(engine.device):
        return [engine.run(s) for s in shards]


def sharded_runner(program, mesh=None, *, spec: ExecutionSpec | None = None,
                   nu_kernel: bool | None = None,
                   interpret: bool | None = None,
                   min_shard: int = 1) -> ShardedRunner:
    """Build a :class:`ShardedRunner` for ``program`` (default mesh:
    every visible device)."""
    return ShardedRunner(program, mesh, spec=spec, nu_kernel=nu_kernel,
                         interpret=interpret, min_shard=min_shard)
