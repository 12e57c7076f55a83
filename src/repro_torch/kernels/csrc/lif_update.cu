// The int32 Neuron Unit of the "lif" tier, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lif_update.py::lif_update_int
// (body `_kernel_int`, launched through `_pad_call`'s pallas_call):
//   v' = v - (v >> leak_shift) + current; spike = v' >= v_threshold;
//   v_out = spike ? v_reset : v'; s_out = spike
// elementwise over [B, N] int32 ([N] is the same pass with B = 1).
//
// What bounds it on the H100: it moves 16 B per element (v and current
// read, v_out and s_out written) and does a handful of integer operations
// on them, so it is bound by bytes. At the SHD serving shape (B = 8,
// N = 320) that is 41 KB, a few nanoseconds of HBM time, far below what a
// launch costs: at these shapes it is launch-bound.
//
// What the design does about that: one grid-stride pass, neighbouring
// threads on neighbouring elements (coalesced), no shared memory and no
// padding: the tail is masked by the loop bound. v_out may alias v (the
// engine updates v in place), which is safe because each thread reads its
// element before it writes it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;    // a few waves over the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
lif_update_int_kernel(const int32_t* v, const int32_t* current,
                      int32_t* v_out, int32_t* s_out, long long n,
                      int leak_shift, int v_threshold, int v_reset) {
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const int32_t vi = v[i];
    const int32_t upd = static_cast<int32_t>(
        static_cast<uint32_t>(vi) - static_cast<uint32_t>(vi >> leak_shift)
        + static_cast<uint32_t>(current[i]));
    const bool spike = upd >= v_threshold;
    v_out[i] = spike ? v_reset : upd;
    s_out[i] = spike ? 1 : 0;
  }
}

}  // namespace

// v, current, v_out and s_out are contiguous int32 arrays of n elements;
// v_out may be v. Returns the launch's cudaError_t.
extern "C" int suprasnn_lif_update_int(const void* v, const void* current,
                                       void* v_out, void* s_out, long long n,
                                       int leak_shift, int v_threshold,
                                       int v_reset, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lif_update_int_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(current),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), n,
      leak_shift < 31 ? leak_shift : 31, v_threshold, v_reset);
  return cudaGetLastError();
}
