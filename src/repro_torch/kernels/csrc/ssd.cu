// Mamba-2 SSD recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_pallas (body
// `_kernel`, launched by its pallas_call). Per (batch b, head h), over
// the tokens t in order, with the state S [P, N] (f32):
//   S_t = exp(-exp(a_log_h) dt_t) S_{t-1} + dt_t x_t b_t^T
//   y_t = S_t c_t
// (y is read from the state AFTER the update; the D-skip and the gate
// stay outside, as in the model). x [B, S, H, P] and b/c [B, S, N]
// (float32 or bf16, one type; b and c are shared by the H heads of a
// batch row), dt [B, S, H] and a_log [H] float32, state0 [B, H, P, N]
// float32; y in x's type, the final state in float32. Every sum is
// float32.
//
// What bounds it on the H100: at the zamba2-7b prefill (B = 4, S =
// 1024, H = 112, P = N = 64) it must move x and y in bf16, dt, b and c,
// and the state in and out, about 0.135 GB (40 us at 3.35 TB/s), and do
// about 5 P N float32 operations per token and head, about 9.4 GFLOP
// (140 us at 67 TFLOP/s outside the tensor cores): bound by float32
// operations and by the sequential chain over the tokens.
//
// What the design does about that: the TPU kernel carries S in VMEM
// across a sequential chunk grid; here one block owns one (b, h) for the
// whole sequence and loops over the tokens, which takes the place of the
// chunk axis. Thread p owns row p of S in N registers. Tokens are staged
// kChunk at a time in shared memory as float32: x, b, c, dt and the
// decay exp(-exp(a_log) dt) (expf, once per token). For each token every
// thread updates its row and sums y_t[p] over the state index with four
// partial sums in a fixed order (index mod 4, met as (a0 + a1) + (a2 +
// a3)), so a result repeats from run to run. A ragged tail tile stages
// only the tokens that exist: no padding. The H blocks of a batch row
// each read that row's b and c; the L2 cache serves all but the first.
// Making it fast (the chunked tensor-core form, TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 32;             // tokens staged per tile
constexpr int kMaxP = 128;             // head dim P: one thread per row

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kMaxP)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ state0,
           T* __restrict__ y, float* __restrict__ state_out, int seq,
           int heads, int p_dim) {
  __shared__ float s_x[kChunk][kMaxP];
  __shared__ __align__(16) float s_b[kChunk][N];
  __shared__ __align__(16) float s_c[kChunk][N];
  __shared__ float s_dt[kChunk];
  __shared__ float s_decay[kChunk];

  const int p = threadIdx.x;           // this thread's state row
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const float neg_a = expf(a_log[h]);  // -A > 0

  float st[N];                         // row p of S
  const float* s0 = state0 + (static_cast<size_t>(bh) * p_dim + p) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = s0[i];

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    const size_t row0 = static_cast<size_t>(b) * seq + t0;  // token t0 of b
    for (int tt = 0; tt < len; ++tt)
      s_x[tt][p] = load_f(x + ((row0 + tt) * heads + h) * p_dim + p);
    for (int i = p; i < len * N; i += p_dim) {
      s_b[i / N][i % N] = load_f(bm + row0 * N + i);
      s_c[i / N][i % N] = load_f(cm + row0 * N + i);
    }
    for (int tt = p; tt < len; tt += p_dim) {
      const float d = dt[(row0 + tt) * heads + h];
      s_dt[tt] = d;
      s_decay[tt] = expf(-neg_a * d);
    }
    __syncthreads();

    for (int tt = 0; tt < len; ++tt) {
      const float dtx = s_dt[tt] * s_x[tt][p];
      const float decay = s_decay[tt];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(&s_b[tt][i]);
        const float4 cv = *reinterpret_cast<const float4*>(&s_c[tt][i]);
        st[i] = fmaf(decay, st[i], dtx * bv.x);
        st[i + 1] = fmaf(decay, st[i + 1], dtx * bv.y);
        st[i + 2] = fmaf(decay, st[i + 2], dtx * bv.z);
        st[i + 3] = fmaf(decay, st[i + 3], dtx * bv.w);
        a0 = fmaf(st[i], cv.x, a0);
        a1 = fmaf(st[i + 1], cv.y, a1);
        a2 = fmaf(st[i + 2], cv.z, a2);
        a3 = fmaf(st[i + 3], cv.w, a3);
      }
      store_f(y + ((row0 + tt) * heads + h) * p_dim + p,
              (a0 + a1) + (a2 + a3));
    }
    __syncthreads();                   // the tile is restaged next
  }

  float* so = state_out + (static_cast<size_t>(bh) * p_dim + p) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) so[i] = st[i];
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, const void* state0,
                   void* y, void* state_out, int batch, int seq, int heads,
                   int p_dim, cudaStream_t stream) {
  ssd_kernel<T, N><<<batch * heads, p_dim, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state_out), seq, heads, p_dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* a_log,
                     const void* bm, const void* cm, const void* state0,
                     void* y, void* state_out, int batch, int seq, int heads,
                     int p_dim, int n, cudaStream_t stream) {
  switch (n) {
    case 8:
      return launch<T, 8>(x, dt, a_log, bm, cm, state0, y, state_out, batch,
                          seq, heads, p_dim, stream);
    case 16:
      return launch<T, 16>(x, dt, a_log, bm, cm, state0, y, state_out, batch,
                           seq, heads, p_dim, stream);
    case 32:
      return launch<T, 32>(x, dt, a_log, bm, cm, state0, y, state_out, batch,
                           seq, heads, p_dim, stream);
    case 64:
      return launch<T, 64>(x, dt, a_log, bm, cm, state0, y, state_out, batch,
                           seq, heads, p_dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [batch, seq, heads, p_dim] and b, c [batch, seq, n], contiguous,
// of type dtype (0 float32, 1 bf16); dt [batch, seq, heads], a_log
// [heads], state0 and state_out [batch, heads, p_dim, n], all float32 and
// contiguous. 1 <= p_dim <= 128; n is 8, 16, 32 or 64; batch * heads is
// positive and fits the grid. Returns the launch's cudaError_t.
extern "C" int suprasnn_ssd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, const void* state0,
                            void* y, void* state_out, int dtype, int batch,
                            int seq, int heads, int p_dim, int n,
                            void* stream) {
  if (p_dim < 1 || p_dim > kMaxP) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, dt, a_log, b, c, state0, y, state_out, batch,
                             seq, heads, p_dim, n, st);
    case 1:
      return dispatch<__nv_bfloat16>(x, dt, a_log, b, c, state0, y,
                                     state_out, batch, seq, heads, p_dim, n,
                                     st);
    default:
      return cudaErrorInvalidValue;
  }
}
