// The LIF Neuron Unit, for Hopper (sm_90a), in two variants.
//
// lif_update_int_kernel replaces the TPU kernel
// src/repro/kernels/lif_update.py::lif_update_int (body `_kernel_int`,
// launched through `_pad_call`'s pallas_call), the "lif" tier's step:
//   v' = v - (v >> leak_shift) + current; spike = v' >= v_threshold;
//   v_out = spike ? v_reset : v'; s_out = spike          (int32)
// lif_update_kernel replaces src/repro/kernels/lif_update.py::lif_update
// (body `_kernel`), the training side's float step:
//   u = (1 - alpha) * v + current; spike = u >= v_th;
//   v_out = spike ? v_reset : u; s_out = spike ? 1 : 0   (float32)
// Both are elementwise over [B, N] ([N] is the same pass with B = 1).
//
// What bounds them on the H100: each moves 16 B per element (v and current
// read, v_out and s_out written) and does a handful of operations on them,
// so it is bound by bytes. At the SHD shapes (B = 8 serving, B = 32
// training; N = 300 or 320) that is 41-154 KB, some tens of nanoseconds of
// HBM time, far below what a launch costs: at these shapes they are
// launch-bound.
//
// What the design does about that: one grid-stride pass, neighbouring
// threads on neighbouring elements (coalesced), no shared memory and no
// padding: the tail is masked by the loop bound. v_out may alias v (the
// engine updates v in place), which is safe because each thread reads its
// element before it writes it. The float update is written with __fmul_rn
// and __fadd_rn: nvcc would otherwise contract it into one FMA, whose
// single rounding differs in the last bit from torch's separate multiply
// and add, and a neuron sitting on its threshold would then spike in one
// and not in the other. So written, the kernel is bit-exact with
// lif_update_ref.

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

__global__ void __launch_bounds__(kThreads)
lif_update_kernel(const float* v, const float* current, float* v_out,
                  float* s_out, long long n, float decay, float v_th,
                  float v_reset) {
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const float u = __fadd_rn(__fmul_rn(decay, v[i]), current[i]);
    const bool spike = u >= v_th;
    v_out[i] = spike ? v_reset : u;
    s_out[i] = spike ? 1.0f : 0.0f;
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// v, current, v_out and s_out are contiguous int32 arrays of n elements;
// v_out may be v. Returns the launch's cudaError_t.
extern "C" int suprasnn_lif_update_int(const void* v, const void* current,
                                       void* v_out, void* s_out, long long n,
                                       int leak_shift, int v_threshold,
                                       int v_reset, void* stream) {
  lif_update_int_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(current),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), n,
      leak_shift < 31 ? leak_shift : 31, v_threshold, v_reset);
  return cudaGetLastError();
}

// v, current, v_out and s_out are contiguous float32 arrays of n elements;
// v_out may be v. decay is 1 - alpha, rounded to float32 by the caller.
// Returns the launch's cudaError_t.
extern "C" int suprasnn_lif_update(const void* v, const void* current,
                                   void* v_out, void* s_out, long long n,
                                   float decay, float v_th, float v_reset,
                                   void* stream) {
  lif_update_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(current),
      static_cast<float*>(v_out), static_cast<float*>(s_out), n, decay, v_th,
      v_reset);
  return cudaGetLastError();
}
