"""Port of :mod:`repro.kernels`: hand-written CUDA kernels for Hopper.

* ``fused_step``  — one whole timestep (``csrc/fused_step.cu``);
* ``lif_update``  — the int32 Neuron Unit (``csrc/lif_update.cu``);
* ``_build``      — nvcc build at first use, ctypes binding.

Each wrapper launches its kernel for CUDA tensors and runs its plain
torch version (``*_ref``, same module) for CPU tensors; nothing builds
at import.
"""
