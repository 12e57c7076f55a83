// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::wkv6_pallas (body
// `_kernel`, launched by its pallas_call). Per (batch b, head h), over
// the tokens t in order, with the key-major state S [N, N] (f32):
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T
// r/k/v [B, S, H, N] (float32 or bf16), w_log [B, S, H, N] float32 (the
// log-decay, <= 0), u [H, N] float32, state0 [B, H, N, N] float32; y in
// r's type, the final state in float32. Every sum is float32.
//
// What bounds it on the H100: at the rwkv6-3b prefill (B = 8, S = 1024,
// H = 40, N = 64) the kernel must move r/k/v/y in bf16, w in float32
// and the state in and out, about 0.26 GB (78 us at 3.35 TB/s), and do
// about 5 N^2 float32 operations per token and head, about 6.7 GFLOP
// (100 us at 67 TFLOP/s outside the tensor cores). So it is bound by
// float32 operations, and by the length of the sequential chain over
// the tokens, which no block can split.
//
// What the design does about that: the TPU kernel carries S in VMEM
// across a sequential chunk grid; Hopper has no sequential grid, so one
// block owns one (b, h) for the whole sequence, and a loop over the
// tokens inside the block takes the place of the chunk axis. Thread n
// owns column n of S (the value dimension) in N registers, so the state
// never leaves the SM and its update needs no communication. Tokens are
// staged kChunk at a time in shared memory as float32 (r, k, v, and
// exp(w) computed once per element with expf), with the bonus r.(u*k)
// of each token summed once by one thread in key order. Then for each
// token every thread forms y_t[n] from its column with four partial sums
// in a fixed order (key index mod 4, met as (a0 + a1) + (a2 + a3)), so
// a result repeats from run to run, writes it (the block's N threads
// write one contiguous row), and updates its column. A ragged tail tile
// stages only the tokens that exist: there is no padding. Making it
// fast (the chunked tensor-core form, TMA, more than one block per
// head) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 32;             // tokens staged per tile

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w_log,
            const float* __restrict__ u, const float* __restrict__ state0,
            T* __restrict__ y, float* __restrict__ state_out, int seq,
            int heads) {
  __shared__ __align__(16) float s_r[kChunk][N];
  __shared__ __align__(16) float s_k[kChunk][N];
  __shared__ __align__(16) float s_decay[kChunk][N];
  __shared__ float s_v[kChunk][N];
  __shared__ float s_u[N];
  __shared__ float s_bonus[kChunk];

  const int n = threadIdx.x;           // this thread's state column
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const size_t tok_stride = static_cast<size_t>(heads) * N;
  // element n of token 0 of this (b, h)
  const size_t base = static_cast<size_t>(b) * seq * tok_stride +
                      static_cast<size_t>(h) * N + n;

  float st[N];                         // column n of S: st[i] = S[i][n]
  const float* s0 = state0 + static_cast<size_t>(bh) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = s0[i * N + n];
  s_u[n] = u[h * N + n];

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    for (int tt = 0; tt < len; ++tt) {
      const size_t off = base + static_cast<size_t>(t0 + tt) * tok_stride;
      s_r[tt][n] = load_f(r + off);
      s_k[tt][n] = load_f(k + off);
      s_v[tt][n] = load_f(v + off);
      s_decay[tt][n] = expf(w_log[off]);
    }
    __syncthreads();
    for (int tt = n; tt < len; tt += N) {        // the current-token bonus
      float bonus = 0.0f;
      for (int i = 0; i < N; ++i)
        bonus += s_r[tt][i] * s_u[i] * s_k[tt][i];
      s_bonus[tt] = bonus;
    }
    __syncthreads();

    for (int tt = 0; tt < len; ++tt) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 rv = *reinterpret_cast<const float4*>(&s_r[tt][i]);
        a0 = fmaf(rv.x, st[i], a0);
        a1 = fmaf(rv.y, st[i + 1], a1);
        a2 = fmaf(rv.z, st[i + 2], a2);
        a3 = fmaf(rv.w, st[i + 3], a3);
      }
      const float vn = s_v[tt][n];
      const float yv = ((a0 + a1) + (a2 + a3)) + s_bonus[tt] * vn;
      store_f(y + base + static_cast<size_t>(t0 + tt) * tok_stride, yv);
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 dv = *reinterpret_cast<const float4*>(&s_decay[tt][i]);
        const float4 kv = *reinterpret_cast<const float4*>(&s_k[tt][i]);
        st[i] = fmaf(dv.x, st[i], kv.x * vn);
        st[i + 1] = fmaf(dv.y, st[i + 1], kv.y * vn);
        st[i + 2] = fmaf(dv.z, st[i + 2], kv.z * vn);
        st[i + 3] = fmaf(dv.w, st[i + 3], kv.w * vn);
      }
    }
    __syncthreads();                   // the tile is restaged next
  }

  float* so = state_out + static_cast<size_t>(bh) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) so[i * N + n] = st[i];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w_log, const void* u, const void* state0,
                   void* y, void* state_out, int batch, int seq, int heads,
                   cudaStream_t stream) {
  wkv6_kernel<T, N><<<batch * heads, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w_log),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state_out), seq, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w_log, const void* u, const void* state0,
                     void* y, void* state_out, int batch, int seq, int heads,
                     int n, cudaStream_t stream) {
  switch (n) {
    case 8:
      return launch<T, 8>(r, k, v, w_log, u, state0, y, state_out, batch,
                          seq, heads, stream);
    case 16:
      return launch<T, 16>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, stream);
    case 32:
      return launch<T, 32>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, stream);
    case 64:
      return launch<T, 64>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y [batch, seq, heads, n] contiguous, of type dtype (0 float32,
// 1 bf16); w_log [batch, seq, heads, n], u [heads, n], state0 and
// state_out [batch, heads, n, n], all float32 and contiguous. n is 8, 16,
// 32 or 64; batch * heads is positive and fits the grid. Returns the
// launch's cudaError_t.
extern "C" int suprasnn_wkv6(const void* r, const void* k, const void* v,
                             const void* w_log, const void* u,
                             const void* state0, void* y, void* state_out,
                             int dtype, int batch, int seq, int heads, int n,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(r, k, v, w_log, u, state0, y, state_out, batch,
                             seq, heads, n, st);
    case 1:
      return dispatch<__nv_bfloat16>(r, k, v, w_log, u, state0, y, state_out,
                                     batch, seq, heads, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
