"""SupraSNN on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``src/repro/`` file for file; each module's
docstring names the reference module it ports. It imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``.

Two paths are ported. The deployed main path: ``core.program.compile``
maps an SNN graph onto the SPUs on the host (the partitioners and the
scheduler, numpy) into a ``core.program.Program``, or ``Program.load``
reads a compiled npz v1 artifact of either package;
``core.engine_torch.TorchMappedEngine`` runs the Program through the
hand-written CUDA kernels of ``kernels/`` (the ``"fused"`` and ``"lif"``
tiers) or plain torch (``"reference"``), and ``serve/`` micro-batches
requests onto it. The training side:
``snn.train`` trains the paper's SNNs by BPTT (``snn.models``,
``optimizer``) on the datasets of ``data/``, every forward timestep
through the ``spike_accum`` and float ``lif_update`` kernels, and
``snn.quantize`` makes the integer network. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
