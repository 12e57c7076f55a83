// Mamba-2 SSD recurrence for Hopper (sm_90a), chunked on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_pallas (body
// `_kernel`, launched by its pallas_call). Per (batch b, head h), with
// the state S [P, N] (f32), it computes what the token recurrence
//   S_t = exp(-exp(a_log_h) dt_t) S_{t-1} + dt_t x_t b_t^T,  y_t = S_t c_t
// computes (y is read after the update; the D-skip and the gate stay
// outside, as in the model), in the chunked form of
// src/repro/models/mamba2.py::ssd_chunked. x [B, S, H, P] and b/c
// [B, S, N] (float32 or bf16, one type; b and c shared by the H heads),
// dt [B, S, H] and a_log [H] float32, state0 [B, H, P, N] float32; y in
// x's type, the final state in float32.
//
// What bounds it on the H100: at the zamba2-7b prefill (B = 4, S = 1024,
// H = 112, P = N = 64) it must move x and y in bf16, dt, b and c, and the
// state in and out, about 0.135 GB: 40 us at 3.35 TB/s. The chunked form
// does about 2 (3 C N + 2 P N) flops per token and head on the tensor
// cores (G = C B^T, M x, C S0^T and the state hop, counted once each as
// bf16 products), about 9.4 GFLOP, 10 us at 989 TFLOP/s, and a few float
// operations per token and head outside them. So the bound is the bytes;
// the sequential form the parent kernel ran (5 P N float32 operations per
// token and head, 140 us at 67 TFLOP/s) is not the least work.
//
// Design (ssm_sm90.cuh: one CTA of 4 warps per (b, h), chunks of 64
// tokens, one 16-token sub-chunk of y rows per warp, S in accumulators;
// x, b, c, dt in single buffers, 47 KB of shared memory and at most 128
// registers a thread at P <= 64, so 4 CTAs share an SM).
// Per chunk, with cum the running sum of -exp(a_log) dt (taken token by
// token by one thread, so the emulation repeats it):
//   y   = exp(cum_t) (C S0^T)                     C exact, S0 in terms
//       + M X,  M[t,s] = (c_t . b_s) exp(cum_t - cum_s) dt_s, s <= t
//   S  <- exp(cum_end) S + (X coef)^T B,  coef_s = dt_s exp(cum_end - cum_s)
// G = C B^T [16 x 16 per (sub-chunk, earlier sub-chunk)] is recomputed
// per head (b and c are shared by the heads; the tensor-core time is a
// few us in all). G becomes M in registers and M becomes the A operand
// of M X in registers. The decay is one scalar per token, so every
// scaling is a row scaling of an accumulator (exact float32) or a factor
// of one operand. Every exponent is <= 0: nothing overflows, and an
// exponent far below 0 only underflows a term that is itself negligible.
//
// Rounding points (bf16 inputs; float32 inputs take three terms in each):
// x, b, c are exact; S0 is rounded to hi + lo once per chunk; M to hi + lo
// in registers; X coef to hi + lo; every sum is float32, and y is rounded
// to x's type once. Products over the padded P and N run on zero rows.
// The schedule runs as ssd_emulated in kernels/ssd.py on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "ssm_sm90.cuh"

namespace {

using ssm::kChunk;
using ssm::kSub;
using ssm::kThreads;

constexpr int kMaxP = 128;

template <typename T, int NP, int PT>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);  // 16 B: rows stay aligned
  static constexpr int kLdx = 64 * PT + kPad;  // and banks spread
  static constexpr int kLdn = NP + kPad;
  static constexpr int kLds = NP + 8;
  T x[kChunk][kLdx];
  T b[kChunk][kLdn];
  T c[kChunk][kLdn];
  float dt[kChunk];
  __nv_bfloat16 s0[ssm::Terms<T>::der][64 * PT][kLds];   // S0 [p][n]
  float cum[kChunk];
  float ecum[kChunk];     // exp(cum_t)
  float coef[kChunk];     // dt_s exp(cum_end - cum_s)
};

// CTAs an SM must hold: four of the bf16 kernel at P <= 64 (47 KB of
// shared memory, 128 registers a thread) cover the zamba2-7b prefill's
// 448 CTAs at once
template <typename T, int PT> struct Occupancy {
  static constexpr int value = 1;
};
template <> struct Occupancy<__nv_bfloat16, 1> {
  static constexpr int value = 4;
};

// NP: N padded to a whole K-step (16, 32 or 64); PT: P padded to 64 PT
template <typename T, int NP, int PT>
__global__ void __launch_bounds__(kThreads, Occupancy<T, PT>::value)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ state0,
           T* __restrict__ y, float* __restrict__ state_out, int seq,
           int heads, int p_dim, int n_dim, int gran_x, int gran_bc) {
  using S = Smem<T, NP, PT>;
  constexpr int kIn = ssm::Terms<T>::in, kDer = ssm::Terms<T>::der;
  constexpr int kPW = 64 * PT;     // padded P
  constexpr int kNN = NP / 8;      // n-tiles over N
  constexpr int kNP = kPW / 8;     // n-tiles over P
  constexpr int kKN = NP / 16;     // K-steps over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, bi = bh / heads, h = bh % heads;
  const float neg_a = expf(a_log[h]);
  const size_t tok_x = static_cast<size_t>(heads) * p_dim;
  const T* xb = x + static_cast<size_t>(bi) * seq * tok_x +
                static_cast<size_t>(h) * p_dim;
  T* yb = y + static_cast<size_t>(bi) * seq * tok_x +
          static_cast<size_t>(h) * p_dim;
  const float* dtb = dt + static_cast<size_t>(bi) * seq * heads + h;
  const T* bb = bm + static_cast<size_t>(bi) * seq * n_dim;
  const T* cb = cm + static_cast<size_t>(bi) * seq * n_dim;

  // S rows p = 16 warp + 64 m + g (+ 8), columns n = 8 nt + 2q (+ 1)
  float st[PT][kNN][4];
  const float* s0g = state0 + static_cast<size_t>(bh) * p_dim * n_dim;
#pragma unroll
  for (int m = 0; m < PT; ++m)
#pragma unroll
    for (int nt = 0; nt < kNN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * warp + 64 * m + g + 8 * (e >> 1);
        const int n = 8 * nt + 2 * q + (e & 1);
        st[m][nt][e] = p < p_dim && n < n_dim
                           ? s0g[static_cast<size_t>(p) * n_dim + n]
                           : 0.0f;
      }

  // Single buffers, restaged once a chunk is done: the other CTAs of the
  // SM cover the wait.
  auto stage = [&](int ch) {
    const int t0 = ch * kChunk, len = min(kChunk, seq - t0);
    contract::stage<kThreads, kChunk, kPW>(
        &sm.x[0][0], S::kLdx, xb + t0 * tok_x, tok_x, 0, len, 0, p_dim,
        gran_x);
    contract::stage<kThreads, kChunk, NP>(
        &sm.b[0][0], S::kLdn, bb + static_cast<size_t>(t0) * n_dim, n_dim,
        0, len, 0, n_dim, gran_bc);
    contract::stage<kThreads, kChunk, NP>(
        &sm.c[0][0], S::kLdn, cb + static_cast<size_t>(t0) * n_dim, n_dim,
        0, len, 0, n_dim, gran_bc);
    if (tid < kChunk)
      contract::cp_async<4>(&sm.dt[tid],
                            tid < len ? dtb + static_cast<size_t>(t0 + tid) *
                                                  heads
                                      : dtb,
                            tid < len ? 4 : 0);
    ssm::cp_async_commit();
  };

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kChunk, len = min(kChunk, seq - t0);
    ssm::cp_async_wait<0>();
    __syncthreads();

    // 1. the chunk's decay sums (warp 0) and S0's terms (every warp)
    if (warp == 0) {
      if (lane == 0) {
        float dv[kChunk], acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) dv[t] = sm.dt[t];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(-neg_a, dv[t]));
          sm.cum[t] = acc;
        }
      }
      __syncwarp();
      const float end = sm.cum[kChunk - 1];
      for (int t = lane; t < kChunk; t += 32) {
        sm.ecum[t] = expf(sm.cum[t]);
        sm.coef[t] = sm.dt[t] * expf(end - sm.cum[t]);
      }
    }
#pragma unroll
    for (int m = 0; m < PT; ++m)
#pragma unroll
      for (int nt = 0; nt < kNN; ++nt) {
        const int p = 16 * warp + 64 * m + g, n = 8 * nt + 2 * q;
        uint32_t lo[kDer], hi[kDer];
        ssm::split_pair<kDer>(st[m][nt][0], st[m][nt][1], lo);
        ssm::split_pair<kDer>(st[m][nt][2], st[m][nt][3], hi);
#pragma unroll
        for (int i = 0; i < kDer; ++i) {
          *reinterpret_cast<uint32_t*>(&sm.s0[i][p][n]) = lo[i];
          *reinterpret_cast<uint32_t*>(&sm.s0[i][p + 8][n]) = hi[i];
        }
      }
    __syncthreads();

    // 2. y for the rows of one sub-chunk; the sub-chunk turns with the
    // block, so the longest rows (the last sub-chunk's) fall on every
    // scheduler of an SM in turn
    {
      const int sub = (warp + blockIdx.x) & (ssm::kWarps - 1);
      const int r0 = sub * kSub + g, r1 = r0 + 8;
      uint32_t ca[kKN][kIn][4];                  // C rows r0, r1
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk)
        ssm::input_a<kIn>(&sm.c[r0][16 * kk + 2 * q],
                          &sm.c[r1][16 * kk + 2 * q], ca[kk]);
      float acc[kNP][4];
#pragma unroll
      for (int nt = 0; nt < kNP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk)
#pragma unroll
        for (int nt = 0; nt < kNP; ++nt) {
          uint32_t sb[kDer][2];
#pragma unroll
          for (int i = 0; i < kDer; ++i) {
            const __nv_bfloat16* row = &sm.s0[i][8 * nt + g][16 * kk + 2 * q];
            sb[i][0] = *reinterpret_cast<const uint32_t*>(row);
            sb[i][1] = *reinterpret_cast<const uint32_t*>(row + 8);
          }
          ssm::mma_terms<kIn, kDer>(acc[nt], ca[kk], sb);
        }
      const float e0 = sm.ecum[r0], e1 = sm.ecum[r1];
#pragma unroll
      for (int nt = 0; nt < kNP; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      for (int j = 0; j <= sub; ++j) {
        float gt[2][4] = {};                     // G rows r0/r1, sub-chunk j
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            uint32_t bf[kIn][2];
            ssm::input_b_row<kIn>(
                &sm.b[16 * j + 8 * h2 + g][16 * kk + 2 * q], bf);
            ssm::mma_terms<kIn, kIn>(gt[h2], ca[kk], bf);
          }
        float v[8];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? r0 : r1;
            const int s = 16 * j + 8 * h2 + 2 * q + (e & 1);
            v[4 * h2 + e] = s <= t ? gt[h2][e] *
                                         expf(sm.cum[t] - sm.cum[s]) *
                                         sm.dt[s]
                                   : 0.0f;
          }
        uint32_t ma[kDer][4];
        ssm::frag_a<kDer>(v, ma);
#pragma unroll
        for (int nt = 0; nt < kNP; ++nt) {
          uint32_t xf[kIn][2];
          ssm::input_b_col<kIn>(&sm.x[0][0], S::kLdx, 16 * j, 8 * nt,
                                xf);
          ssm::mma_terms<kDer, kIn>(acc[nt], ma, xf);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? r1 : r0;
        if (t < len) {
          T* row = yb + static_cast<size_t>(t0 + t) * tok_x;
#pragma unroll
          for (int nt = 0; nt < kNP; ++nt) {
            const int p = 8 * nt + 2 * q;
            if (p < p_dim)
              ssm::store_pair(row + p, acc[nt][2 * half],
                              acc[nt][2 * half + 1], p, p_dim);
          }
        }
      }
    }

    // 3. the state hop: S <- exp(cum_end) S + (X coef)^T B
    {
      const float decay = expf(sm.cum[kChunk - 1]);
#pragma unroll
      for (int m = 0; m < PT; ++m)
#pragma unroll
        for (int nt = 0; nt < kNN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[m][nt][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const int s = 16 * kk + 2 * q;
        const float c0 = sm.coef[s], c1 = sm.coef[s + 1];
        const float c8 = sm.coef[s + 8], c9 = sm.coef[s + 9];
        uint32_t xa[PT][kDer][4];
#pragma unroll
        for (int m = 0; m < PT; ++m) {
          const int p0 = 16 * warp + 64 * m + g, p1 = p0 + 8;
          const float v[8] = {
              ssm::to_f(sm.x[s][p0]) * c0,
              ssm::to_f(sm.x[s + 1][p0]) * c1,
              ssm::to_f(sm.x[s][p1]) * c0,
              ssm::to_f(sm.x[s + 1][p1]) * c1,
              ssm::to_f(sm.x[s + 8][p0]) * c8,
              ssm::to_f(sm.x[s + 9][p0]) * c9,
              ssm::to_f(sm.x[s + 8][p1]) * c8,
              ssm::to_f(sm.x[s + 9][p1]) * c9};
          ssm::frag_a<kDer>(v, xa[m]);
        }
#pragma unroll
        for (int nt = 0; nt < kNN; ++nt) {
          uint32_t bf[kIn][2];
          ssm::input_b_col<kIn>(&sm.b[0][0], S::kLdn, 16 * kk, 8 * nt, bf);
#pragma unroll
          for (int m = 0; m < PT; ++m)
            ssm::mma_terms<kDer, kIn>(st[m][nt], xa[m], bf);
        }
      }
    }
    __syncthreads();                 // the buffers are free: stage the next
    if (ch + 1 < n_chunks) stage(ch + 1);
  }

  float* so = state_out + static_cast<size_t>(bh) * p_dim * n_dim;
#pragma unroll
  for (int m = 0; m < PT; ++m)
#pragma unroll
    for (int nt = 0; nt < kNN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * warp + 64 * m + g + 8 * (e >> 1);
        const int n = 8 * nt + 2 * q + (e & 1);
        if (p < p_dim && n < n_dim)
          so[static_cast<size_t>(p) * n_dim + n] = st[m][nt][e];
      }
}

template <typename T, int NP, int PT>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, const void* state0,
                   void* y, void* state_out, int batch, int seq, int heads,
                   int p_dim, int n_dim, cudaStream_t stream) {
  static bool smem_set = false;
  const auto kernel = ssd_kernel<T, NP, PT>;
  constexpr size_t smem = sizeof(Smem<T, NP, PT>);
  cudaError_t err = ssm::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int gran_x = contract::copy_granule(x, p_dim * sizeof(T));
  const int gran_bc = std::min(contract::copy_granule(bm, n_dim * sizeof(T)),
                               contract::copy_granule(cm, n_dim * sizeof(T)));
  kernel<<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state_out), seq, heads, p_dim,
      n_dim, gran_x, gran_bc);
  return cudaGetLastError();
}

template <typename T, int PT>
cudaError_t dispatch_n(const void* x, const void* dt, const void* a_log,
                       const void* bm, const void* cm, const void* state0,
                       void* y, void* state_out, int batch, int seq,
                       int heads, int p_dim, int n, cudaStream_t stream) {
  switch (n) {
    case 8:
    case 16:
      return launch<T, 16, PT>(x, dt, a_log, bm, cm, state0, y, state_out,
                               batch, seq, heads, p_dim, n, stream);
    case 32:
      return launch<T, 32, PT>(x, dt, a_log, bm, cm, state0, y, state_out,
                               batch, seq, heads, p_dim, n, stream);
    case 64:
      return launch<T, 64, PT>(x, dt, a_log, bm, cm, state0, y, state_out,
                               batch, seq, heads, p_dim, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* a_log,
                     const void* bm, const void* cm, const void* state0,
                     void* y, void* state_out, int batch, int seq, int heads,
                     int p_dim, int n, cudaStream_t stream) {
  return p_dim <= 64
             ? dispatch_n<T, 1>(x, dt, a_log, bm, cm, state0, y, state_out,
                                batch, seq, heads, p_dim, n, stream)
             : dispatch_n<T, 2>(x, dt, a_log, bm, cm, state0, y, state_out,
                                batch, seq, heads, p_dim, n, stream);
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
