"""Port of :mod:`repro.kernels`: hand-written CUDA kernels for Hopper.

* ``fused_step``   — one whole timestep (``csrc/fused_step.cu``);
* ``lif_update``   — the LIF Neuron Unit, float32 (``lif_update``) and
  int32 (``lif_update_int``) (``csrc/lif_update.cu``);
* ``spike_accum``  — ``I = S @ W`` with the spike-tile skip
  (``csrc/spike_accum.cu``);
* ``wkv6``         — the RWKV-6 WKV recurrence (``csrc/wkv6.cu``);
* ``ssd``          — the Mamba-2 SSD recurrence (``csrc/ssd.cu``);
* ``ref``          — the plain token-by-token versions of those two;
* ``contract``     — the host side of ``csrc/contract_sm90.cuh``, the
  cluster design ``fused_step`` and ``spike_accum`` share;
* ``ssm_chunks``   — the host side of ``csrc/ssm_sm90.cuh``, the chunked
  tensor-core design ``wkv6`` and ``ssd`` share (their emulations);
* ``_build``       — nvcc build at first use, ctypes binding;
* ``launches``     — the wrappers' launch counters, safe across threads.

Each wrapper launches its kernel for CUDA tensors and runs its plain
torch version (``*_ref``, in the same module or in ``ref``) for CPU
tensors; nothing builds at import. As in :mod:`repro.kernels`, the
package attributes ``lif_update``, ``spike_accum``, ``wkv6`` and ``ssd``
are the functions; import the modules as
``from repro_torch.kernels.spike_accum import ...``.
"""
from repro_torch.kernels.lif_update import (lif_update, lif_update_int,
                                            lif_update_int_ref,
                                            lif_update_ref)
from repro_torch.kernels.ref import ssd_ref, wkv6_ref
from repro_torch.kernels.spike_accum import spike_accum, spike_accum_ref
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["lif_update", "lif_update_int", "lif_update_int_ref",
           "lif_update_ref", "spike_accum", "spike_accum_ref", "ssd",
           "ssd_ref", "wkv6", "wkv6_ref"]
