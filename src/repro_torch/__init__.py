"""SupraSNN on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``src/repro/`` file for file; each module's
docstring names the reference module it ports. It imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``.

This slice carries the deployed main path: ``core.program.Program``
loads a compiled npz v1 artifact, ``core.engine_torch.TorchMappedEngine``
runs it through the hand-written CUDA kernels of ``kernels/`` (the
``"fused"`` and ``"lif"`` tiers) or plain torch (``"reference"``), and
``serve/`` micro-batches requests onto it. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
