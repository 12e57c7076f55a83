// The LIF Neuron Unit, for Hopper (sm_90a): an int32 and a float32 step,
// and the float step's gradient.
//
// lif_update_int_kernel replaces the TPU kernel
// src/repro/kernels/lif_update.py::lif_update_int (body `_kernel_int`,
// launched through `_pad_call`'s pallas_call), the "lif" tier's step:
//   v' = v - (v >> leak_shift) + current; spike = v' >= v_threshold;
//   v_out = spike ? v_reset : v'; s_out = spike          (int32)
// With `drain` set it also zeroes `current` as it reads it: the Neuron
// Unit drains the Merge Tree's accumulator (paper Fig. 7), so the engine
// keeps one current plane for a whole run and never clears it itself.
// lif_update_kernel replaces src/repro/kernels/lif_update.py::lif_update
// (body `_kernel`), the training side's float step, with the recurrent
// layer's second current plane folded in (current_rec may be null):
//   u = (1 - alpha) * v + (current + current_rec); spike = u >= v_th;
//   v_out = spike ? v_reset : u; s_out = spike ? 1 : 0   (float32)
// lif_update_bwd_kernel is that step's gradient, which the JAX package
// leaves to autodiff of its lif_step (no TPU kernel): u recomputed, then
//   g_u = (u >= v_th ? 0 : g_vnext) + g_s * surrogate(u - v_th)
//   g_v = (1 - alpha) * g_u; g_current = g_u
// with a null g_vnext or g_s read as zero.
// All three are elementwise over [B, N] ([N] is the same pass, B = 1).
//
// What bounds them on the H100: each moves 16-28 B per element and does a
// handful of operations on them, so it is bound by bytes. At the SHD
// shapes (B = 8 serving, B = 32 training; N = 300 or 320) that is 41-270
// KB, some tens of nanoseconds of HBM time, far below what a launch and
// one round of loads cost: at these shapes they are launch-bound, and the
// host's time to launch them matters more than the card's (the Python
// callers launch them through unchecked launchers for that reason).
//
// What the design does about that: one pass, in one wave where the shape
// allows (at [32, 300] float32, 9,600 elements are 38 blocks of 256), one
// element per thread and grid-stride beyond that; neighbouring threads on
// neighbouring elements (coalesced); no shared memory and no padding: the
// tail is masked by the loop bound. 16-byte (float4 / int4) lanes were
// tried on the card and bought no device time at these shapes.
// v_out may alias v (the engine updates v in place), which is safe because
// each thread reads its element before it writes it. The float arithmetic is
// written with __fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise
// contract it into FMAs, whose single rounding differs in the last bit
// from torch's separate operations, and a neuron sitting on its threshold
// would then spike in one and not in the other. So written, the forward
// is bit-exact with lif_update_ref(v, current + current_rec) and the
// backward rounds as lif_update_bwd_ref does, up to the surrogate's
// exponential.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;    // a few waves over the H100's 132 SMs

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// ---- int32 -----------------------------------------------------------------

__device__ __forceinline__ void step_int(int32_t v, int32_t cur,
                                         int leak_shift, int v_threshold,
                                         int v_reset, int& v_out,
                                         int& s_out) {
  // wrapping int32 arithmetic, as the reference's
  const int32_t upd = static_cast<int32_t>(
      static_cast<uint32_t>(v) - static_cast<uint32_t>(v >> leak_shift)
      + static_cast<uint32_t>(cur));
  const bool spike = upd >= v_threshold;
  v_out = spike ? v_reset : upd;
  s_out = spike ? 1 : 0;
}

template <bool kDrain>
__global__ void __launch_bounds__(kThreads)
lif_update_int_kernel(const int32_t* v, int32_t* current, int32_t* v_out,
                      int32_t* s_out, long long n, int leak_shift,
                      int v_threshold, int v_reset) {
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const int32_t vi = v[i], ci = current[i];
    if (kDrain) current[i] = 0;
    int vo, so;
    step_int(vi, ci, leak_shift, v_threshold, v_reset, vo, so);
    v_out[i] = vo;
    s_out[i] = so;
  }
}

// ---- float32 forward -------------------------------------------------------

__device__ __forceinline__ void step_f32(float v, float cur, float decay,
                                         float v_th, float v_reset,
                                         float& v_out, float& s_out) {
  const float u = __fadd_rn(__fmul_rn(decay, v), cur);
  const bool spike = u >= v_th;
  v_out = spike ? v_reset : u;
  s_out = spike ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
lif_update_kernel(const float* v, const float* cur, const float* cur_rec,
                  float* v_out, float* s_out, long long n, float decay,
                  float v_th, float v_reset) {
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const float ci = cur_rec != nullptr ? __fadd_rn(cur[i], cur_rec[i])
                                        : cur[i];
    float vo, so;
    step_f32(v[i], ci, decay, v_th, v_reset, vo, so);
    v_out[i] = vo;
    s_out[i] = so;
  }
}

// ---- float32 backward ------------------------------------------------------

// The surrogates of snn/lif.py::surrogate_grad, in its order of roundings:
// 0 relu (the triangle), 1 sigmoid (k = 4), 2 fast_sigmoid (k = 10).
template <int kSurrogate>
__device__ __forceinline__ float surrogate(float x) {
  if constexpr (kSurrogate == 0) {
    return fmaxf(__fsub_rn(1.0f, fabsf(x)), 0.0f);
  } else if constexpr (kSurrogate == 1) {
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f,
                                              expf(-__fmul_rn(4.0f, x))));
    return __fmul_rn(__fmul_rn(4.0f, s), __fsub_rn(1.0f, s));
  } else {
    const float d = __fadd_rn(1.0f, __fmul_rn(10.0f, fabsf(x)));
    return __fdiv_rn(1.0f, __fmul_rn(d, d));
  }
}

// one element: g_u from its u and incoming gradients (gv_in / gs_in are read
// only where their pointers are not null: `has_gv` / `has_gs`)
template <int kSurrogate>
__device__ __forceinline__ float grad_u(float v, float cur, float gv_in,
                                        float gs_in, bool has_gv,
                                        bool has_gs, float decay,
                                        float v_th) {
  const float u = __fadd_rn(__fmul_rn(decay, v), cur);
  float g = has_gv && !(u >= v_th) ? gv_in : 0.0f;
  if (has_gs)
    g = __fadd_rn(g, __fmul_rn(gs_in, surrogate<kSurrogate>(
                                          __fsub_rn(u, v_th))));
  return g;
}

template <int kSurrogate>
__global__ void __launch_bounds__(kThreads)
lif_update_bwd_kernel(const float* v, const float* cur, const float* cur_rec,
                      const float* g_vnext, const float* g_s, float* g_v,
                      float* g_cur, long long n, float decay, float v_th) {
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  const bool has_gv = g_vnext != nullptr, has_gs = g_s != nullptr;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const float ci = cur_rec != nullptr ? __fadd_rn(cur[i], cur_rec[i])
                                        : cur[i];
    const float gu = grad_u<kSurrogate>(
        v[i], ci, has_gv ? g_vnext[i] : 0.0f, has_gs ? g_s[i] : 0.0f,
        has_gv, has_gs, decay, v_th);
    g_cur[i] = gu;
    g_v[i] = __fmul_rn(decay, gu);
  }
}

}  // namespace

// v, current, v_out and s_out are contiguous int32 arrays of n elements;
// v_out may be v. A non-zero `drain` zeroes current as it is read.
// Returns the launch's cudaError_t (0 and no launch for n <= 0).
extern "C" int suprasnn_lif_update_int(const void* v, void* current,
                                       void* v_out, void* s_out, long long n,
                                       int leak_shift, int v_threshold,
                                       int v_reset, int drain, void* stream) {
  if (n <= 0) return cudaSuccess;
  const unsigned grid = grid_for(n);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* vp = static_cast<const int32_t*>(v);
  auto* cp = static_cast<int32_t*>(current);
  auto* vo = static_cast<int32_t*>(v_out);
  auto* so = static_cast<int32_t*>(s_out);
  const int ls = leak_shift < 31 ? leak_shift : 31;
  if (drain)
    lif_update_int_kernel<true><<<grid, kThreads, 0, st>>>(
        vp, cp, vo, so, n, ls, v_threshold, v_reset);
  else
    lif_update_int_kernel<false><<<grid, kThreads, 0, st>>>(
        vp, cp, vo, so, n, ls, v_threshold, v_reset);
  return cudaGetLastError();
}

// v, current, current_rec (or null), v_out and s_out are contiguous
// float32 arrays of n elements; v_out may be v. decay is 1 - alpha,
// rounded to float32 by the caller. Returns the launch's cudaError_t (0
// and no launch for n <= 0).
extern "C" int suprasnn_lif_update(const void* v, const void* current,
                                   const void* current_rec, void* v_out,
                                   void* s_out, long long n, float decay,
                                   float v_th, float v_reset, void* stream) {
  if (n <= 0) return cudaSuccess;
  lif_update_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(current),
      static_cast<const float*>(current_rec), static_cast<float*>(v_out),
      static_cast<float*>(s_out), n, decay, v_th, v_reset);
  return cudaGetLastError();
}

// The float step's gradient. v, current, current_rec (or null), g_vnext
// (or null), g_s (or null), g_v and g_current are contiguous float32
// arrays of n elements; surrogate is 0 relu, 1 sigmoid, 2 fast_sigmoid.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an unknown
// surrogate; 0 and no launch for n <= 0).
extern "C" int suprasnn_lif_update_bwd(const void* v, const void* current,
                                       const void* current_rec,
                                       const void* g_vnext, const void* g_s,
                                       void* g_v, void* g_current,
                                       long long n, float decay, float v_th,
                                       int surrogate_kind, void* stream) {
  if (n <= 0) return cudaSuccess;
  const unsigned grid = grid_for(n);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* vp = static_cast<const float*>(v);
  const auto* cp = static_cast<const float*>(current);
  const auto* rp = static_cast<const float*>(current_rec);
  const auto* gvn = static_cast<const float*>(g_vnext);
  const auto* gs = static_cast<const float*>(g_s);
  auto* gv = static_cast<float*>(g_v);
  auto* gc = static_cast<float*>(g_current);
  switch (surrogate_kind) {
    case 0:
      lif_update_bwd_kernel<0><<<grid, kThreads, 0, st>>>(
          vp, cp, rp, gvn, gs, gv, gc, n, decay, v_th);
      break;
    case 1:
      lif_update_bwd_kernel<1><<<grid, kThreads, 0, st>>>(
          vp, cp, rp, gvn, gs, gv, gc, n, decay, v_th);
      break;
    case 2:
      lif_update_bwd_kernel<2><<<grid, kThreads, 0, st>>>(
          vp, cp, rp, gvn, gs, gv, gc, n, decay, v_th);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
