// RWKV-6 WKV recurrence for Hopper (sm_90a), chunked on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::wkv6_pallas (body
// `_kernel`, launched by its pallas_call). Per (batch b, head h), with
// the key-major state S [N, N] (f32), it computes what the token
// recurrence
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T
// computes, in the chunked form of src/repro/models/rwkv.py::wkv6_chunked.
// r/k/v [B, S, H, N] (float32 or bf16), w_log [B, S, H, N] float32 (the
// log-decay, <= 0), u [H, N] float32, state0 [B, H, N, N] float32; y in
// r's type, the final state in float32.
//
// What bounds it on the H100: at the rwkv6-3b prefill (B = 8, S = 1024,
// H = 40, N = 64) it must move r/k/v/y in bf16, w in float32 and the
// state in and out, about 0.26 GB: 78 us at 3.35 TB/s. The chunked form
// does about 2 (C N + 2 N^2) flops per token and head on the tensor cores
// (the causal scores r k^T and att v, r S0 and the state hop), about 8
// GFLOP, 8 us at 989 TFLOP/s, and about 10 float operations per token,
// key and head outside them (the decays). So the bound is the bytes; the
// sequential form the parent kernel ran (5 N^2 float32 operations per
// token and head, 100 us at 67 TFLOP/s) is not the least work.
//
// Design (ssm_sm90.cuh: one CTA of 4 warps per (b, h), chunks of 64
// tokens, one 16-token sub-chunk of y rows per warp, S in accumulators).
// Per chunk, la is the running sum of w_log over the chunk up to each
// token (one thread per key, token by token, so the emulation repeats
// it), lp the same one token earlier (0 at the chunk's start); E_i is lp
// at sub-chunk i's first token and la_e(j) la at sub-chunk j's last. The
// decay is per key, so the ratio exp(lp_t - la_s) is not a product of
// two matrices; it is factorized at points that keep every factor
// bounded, each factor's exponential taken once per chunk:
//   Q[t] = r_t exp(lp_t - E_i)        t in sub-chunk i          <= 1
//   K[s] = k_s exp(la_e(j) - la_s)    s in sub-chunk j          <= 1
//   rho_ij = exp(E_i - la_e(j))       j < i: <= 1; j = i: >= 1
//   inter-chunk   y  = (Q eps_i) S0,  eps_i = exp(E_i)          <= 1
//   scores        att[t, s] = Q_t . (K_s rho_ij), s in sub-chunk j <= i:
//                 the product is factorized at the start of t's
//                 sub-chunk; for j < i every factor is <= 1; for j = i
//                 (s < t) the B factor is at most e^span, span =
//                 max_k (E_i - la_e(i)), used only while span is below
//                 kSpanMax (e^60 ~ 1e26, far from the float32 and bf16
//                 maximum of 3.4e38);
//   otherwise the diagonal block is summed in log space on the CUDA
//   cores, sum_k r_t k_s exp(lp_t - la_s), every exponent <= 0. The route
//   is chosen per warp and sub-chunk, as wkv6_routes in kernels/wkv6.py.
//   att[t, t] = r_t . (u k_t) (the bonus, float32); y += att v
//   state hop     S <- diag(exp(la_end)) S + (K gamma_j)^T v,
//                 gamma_j = exp(la_end - la_e(j))                <= 1
// An exponent far below 0 only underflows a term that is itself
// negligible.
//
// Phases of a chunk: (1) la, the per-key tables (E, eps, rho, gamma) and
// the bonus, S0 written as bf16 terms; (2a) each warp's Q fragments (kept
// in registers), its inter-chunk product and, where the span is too
// wide, its log-space block; (2b) the K plane, in place of la; the next
// chunk's r and k are then staged; (3) the scores and att v; (4) the
// state hop; then the next chunk's w and v are staged. Every input has a
// single buffer, so a CTA takes 70 KB of shared memory and, at 168
// registers a thread, three CTAs share an SM: the rwkv6-3b prefill's 320
// CTAs run in one round, and the other CTAs of an SM cover each one's
// waits for its loads.
//
// Rounding points (bf16 inputs; float32 inputs take three terms in each):
// r, k, v are exact inputs; S0 is rounded to hi + lo once per chunk; Q,
// Q eps, K rho and K gamma to hi + lo as they enter a product; the scores
// att to hi + lo in registers; every sum is float32, and y is rounded to
// r's type once. The schedule runs as wkv6_emulated in kernels/wkv6.py on
// the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "ssm_sm90.cuh"

namespace {

using ssm::kChunk;
using ssm::kSub;
using ssm::kThreads;
using ssm::kWarps;

constexpr float kSpanMax = 60.0f;       // ssm_chunks.SPAN_MAX

template <typename T, int NP>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLd = NP + kPad;
  static constexpr int kLdf = NP + 4;
  static constexpr int kLds = NP + 8;
  T r[kChunk][kLd];
  T k[kChunk][kLd];
  T v[kChunk][kLd];
  float w[kChunk][kLdf];   // w_log as staged, then la, then K in place
  __nv_bfloat16 s0[ssm::Terms<T>::der][NP][kLds];   // S0^T: [value][key]
  float e[kWarps + 1][NP];             // E_0..E_3, then la at the end
  float eps[kWarps][NP];               // exp(E_i)
  float gam[kWarps][NP];               // exp(la_end - la_e(j))
  float rho[kWarps][kWarps][NP];       // exp(E_i - la_e(j)), j <= i
  float dec[NP];                       // exp(la_end)
  float u[NP];
  float bonus[kChunk];
};

// CTAs an SM must hold: three of the bf16 kernel (its shared memory is
// under a third of an SM) cover the rwkv6-3b prefill's 320 CTAs at once
template <typename T> struct Occupancy { static constexpr int value = 1; };
template <> struct Occupancy<__nv_bfloat16> {
  static constexpr int value = 3;
};

// NP: N padded to a whole K-step (16, 32 or 64)
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::value)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w_log,
            const float* __restrict__ u, const float* __restrict__ state0,
            T* __restrict__ y, float* __restrict__ state_out, int seq,
            int heads, int n_dim, int gran, int gran_w) {
  using S = Smem<T, NP>;
  constexpr int kIn = ssm::Terms<T>::in, kDer = ssm::Terms<T>::der;
  constexpr int kNT = NP / 8;          // n-tiles over N
  constexpr int kKN = NP / 16;         // K-steps over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, bi = bh / heads, h = bh % heads;
  const size_t tok = static_cast<size_t>(heads) * n_dim;
  const size_t base = static_cast<size_t>(bi) * seq * tok +
                      static_cast<size_t>(h) * n_dim;

  // the warp's sub-chunk turns with the block, so the longest rows (the
  // last sub-chunk's) fall on every scheduler of an SM in turn
  const int sub = (warp + blockIdx.x) & (kWarps - 1);
  const int r0 = sub * kSub + g, r1 = r0 + 8;

  // S rows (keys) 16 warp + g (+ 8) for warp < NP / 16, columns (values)
  // 8 nt + 2q (+ 1)
  const bool owns_state = warp < kKN;
  const int key0 = 16 * warp + g, key1 = key0 + 8;
  float st[kNT][4];
  const float* s0g = state0 + static_cast<size_t>(bh) * n_dim * n_dim;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = e < 2 ? key0 : key1, n = 8 * nt + 2 * q + (e & 1);
      st[nt][e] = owns_state && key < n_dim && n < n_dim
                      ? s0g[static_cast<size_t>(key) * n_dim + n]
                      : 0.0f;
    }
  if (tid < NP) sm.u[tid] = tid < n_dim ? u[h * n_dim + tid] : 0.0f;

  // Single buffers: r and k are restaged once the K plane is made, w and v
  // once the chunk is done; the other CTAs of the SM cover the wait.
  auto stage = [&](int ch, T* dst, const T* src) {
    const int t0 = ch * kChunk, len = min(kChunk, seq - t0);
    contract::stage<kThreads, kChunk, NP>(
        dst, S::kLd, src + base + static_cast<size_t>(t0) * tok, tok, 0, len,
        0, n_dim, gran);
  };
  auto stage_w = [&](int ch) {
    const int t0 = ch * kChunk, len = min(kChunk, seq - t0);
    contract::stage<kThreads, kChunk, NP>(
        &sm.w[0][0], S::kLdf, w_log + base + static_cast<size_t>(t0) * tok,
        tok, 0, len, 0, n_dim, gran_w);
  };

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    stage(0, &sm.r[0][0], r);
    stage(0, &sm.k[0][0], k);
    stage(0, &sm.v[0][0], v);
    stage_w(0);
    ssm::cp_async_commit();
  }
  float(*la)[S::kLdf] = sm.w;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kChunk, len = min(kChunk, seq - t0);
    ssm::cp_async_wait<0>();
    __syncthreads();

    // 1. la and the per-key tables (a thread per key), the bonus (a
    // thread per token), S0's terms
    if (tid < NP) {
      const int c = tid;
      float acc = 0.0f;
#pragma unroll 16
      for (int t = 0; t < kChunk; ++t) {
        acc = __fadd_rn(acc, la[t][c]);
        la[t][c] = acc;
        if (t % kSub == kSub - 1) sm.e[t / kSub + 1][c] = acc;
      }
      float ev[kWarps + 1];
      ev[0] = 0.0f;
#pragma unroll
      for (int i = 1; i <= kWarps; ++i) ev[i] = sm.e[i][c];
      sm.e[0][c] = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        sm.eps[i][c] = expf(ev[i]);
        sm.gam[i][c] = expf(ev[kWarps] - ev[i + 1]);
#pragma unroll
        for (int j = 0; j <= i; ++j) sm.rho[i][j][c] = expf(ev[i] - ev[j + 1]);
      }
      sm.dec[c] = expf(ev[kWarps]);
    } else if (tid >= kThreads - kChunk) {
      const int t = tid - (kThreads - kChunk);
      float acc = 0.0f;
      for (int i = 0; i < NP; ++i)
        acc += ssm::to_f(sm.r[t][i]) * sm.u[i] * ssm::to_f(sm.k[t][i]);
      sm.bonus[t] = acc;
    }
    if (owns_state) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = 8 * nt + 2 * q;
        uint32_t lo[kDer], hi[kDer];
        ssm::split_pair<kDer>(st[nt][0], st[nt][1], lo);
        ssm::split_pair<kDer>(st[nt][2], st[nt][3], hi);
#pragma unroll
        for (int i = 0; i < kDer; ++i) {
          uint16_t* col0 = reinterpret_cast<uint16_t*>(&sm.s0[i][n][0]);
          uint16_t* col1 = reinterpret_cast<uint16_t*>(&sm.s0[i][n + 1][0]);
          col0[key0] = static_cast<uint16_t>(lo[i]);
          col1[key0] = static_cast<uint16_t>(lo[i] >> 16);
          col0[key1] = static_cast<uint16_t>(hi[i]);
          col1[key1] = static_cast<uint16_t>(hi[i] >> 16);
        }
      }
    }
    __syncthreads();

    // 2a. the warp's span, its Q fragments (kept in registers), its
    // inter-chunk product and, past the threshold, its diagonal block in
    // log space
    float span = 0.0f;
    for (int c = lane; c < NP; c += 32)
      span = fmaxf(span, sm.e[sub][c] - sm.e[sub + 1][c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      span = fmaxf(span, __shfl_xor_sync(0xffffffffu, span, o));
    const bool log_route = !(span < kSpanMax);

    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    uint32_t qa[kKN][kDer][4];           // Q rows r0, r1, every K-step
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      const int c = 16 * kk + 2 * q;
      const int cols[8] = {c, c + 1, c, c + 1, c + 8, c + 9, c + 8, c + 9};
      float qv[8], iv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = (e & 2) ? r1 : r0, cc = cols[e];
        const float lp = t > 0 ? la[t - 1][cc] : 0.0f;
        qv[e] = ssm::to_f(sm.r[t][cc]) * __expf(lp - sm.e[sub][cc]);
        iv[e] = qv[e] * sm.eps[sub][cc];
      }
      ssm::frag_a<kDer>(qv, qa[kk]);
      uint32_t ia[kDer][4];
      ssm::frag_a<kDer>(iv, ia);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t sb[kDer][2];
#pragma unroll
        for (int i = 0; i < kDer; ++i) {
          const __nv_bfloat16* row = &sm.s0[i][8 * nt + g][c];
          sb[i][0] = *reinterpret_cast<const uint32_t*>(row);
          sb[i][1] = *reinterpret_cast<const uint32_t*>(row + 8);
        }
        ssm::mma_terms<kDer, kDer>(acc[nt], ia, sb);
      }
    }
    float at_log[2][4] = {};
    if (log_route) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1;
          const int s = sub * kSub + 8 * h2 + 2 * q + (e & 1);
          float sum = 0.0f;
          if (s < t)                  // then t > 0: lp_t = la[t - 1]
            for (int c = 0; c < NP; ++c)
              sum += ssm::to_f(sm.r[t][c]) * ssm::to_f(sm.k[s][c]) *
                     expf(la[t - 1][c] - la[s][c]);
          at_log[h2][e] = sum;
        }
    }
    __syncthreads();                 // la is read no more

    // 2b. K in place of la (each element from its own la)
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int s = i / NP, c = i % NP;
      la[s][c] = ssm::to_f(sm.k[s][c]) *
                 __expf(sm.e[s / kSub + 1][c] - la[s][c]);
    }
    __syncthreads();                 // r and k are free: stage the next
    if (ch + 1 < n_chunks) {
      stage(ch + 1, &sm.r[0][0], r);
      stage(ch + 1, &sm.k[0][0], k);
      ssm::cp_async_commit();
    }
    float(*kq)[S::kLdf] = sm.w;

    // 3. the scores against each sub-chunk j <= sub, then att v_j
    for (int j = 0; j <= sub; ++j) {
      float at[2][4] = {}, at_odd[2][4] = {};   // two chains of products
      const bool diag = j == sub;
      if (diag && log_route) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) at[h2][e] = at_log[h2][e];
      } else {
        const float* rho = sm.rho[sub][j];
#pragma unroll
        for (int kk = 0; kk < kKN; ++kk) {
          const int c = 16 * kk + 2 * q;
          const float2 p0 = *reinterpret_cast<const float2*>(rho + c);
          const float2 p8 = *reinterpret_cast<const float2*>(rho + c + 8);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float* row = kq[16 * j + 8 * h2 + g];
            const float2 k0 = *reinterpret_cast<const float2*>(row + c);
            const float2 k8 = *reinterpret_cast<const float2*>(row + c + 8);
            uint32_t b[kDer][2];
            ssm::frag_b<kDer>(k0.x * p0.x, k0.y * p0.y, k8.x * p8.x,
                              k8.y * p8.y, b);
            ssm::mma_terms<kDer, kDer>(kk & 1 ? at_odd[h2] : at[h2], qa[kk],
                                       b);
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 4; ++e) at[h2][e] += at_odd[h2][e];
      }
      float vals[8];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1;
          const int s = 16 * j + 8 * h2 + 2 * q + (e & 1);
          vals[4 * h2 + e] = !diag || s < t ? at[h2][e]
                             : s == t       ? sm.bonus[t]
                                            : 0.0f;
        }
      uint32_t aa[kDer][4];
      ssm::frag_a<kDer>(vals, aa);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t vb[kIn][2];
        ssm::input_b_col<kIn>(&sm.v[0][0], S::kLd, 16 * j, 8 * nt, vb);
        ssm::mma_terms<kDer, kIn>(acc[nt], aa, vb);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? r1 : r0;
      if (t < len) {
        T* row = y + base + static_cast<size_t>(t0 + t) * tok;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int n = 8 * nt + 2 * q;
          if (n < n_dim)
            ssm::store_pair(row + n, acc[nt][2 * half],
                            acc[nt][2 * half + 1], n, n_dim);
        }
      }
    }

    // 4. the state hop: S <- diag(exp(la_end)) S + (K gamma_j)^T v
    if (owns_state) {
      const float d0 = sm.dec[key0], d1 = sm.dec[key1];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        st[nt][0] *= d0;
        st[nt][1] *= d0;
        st[nt][2] *= d1;
        st[nt][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const int s = 16 * kk + 2 * q;  // every s of the K-step in sub kk
        const float g0 = sm.gam[kk][key0], g1 = sm.gam[kk][key1];
        const float vals[8] = {
            kq[s][key0] * g0,     kq[s + 1][key0] * g0,
            kq[s][key1] * g1,     kq[s + 1][key1] * g1,
            kq[s + 8][key0] * g0, kq[s + 9][key0] * g0,
            kq[s + 8][key1] * g1, kq[s + 9][key1] * g1};
        uint32_t a[kDer][4];
        ssm::frag_a<kDer>(vals, a);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t vb[kIn][2];
          ssm::input_b_col<kIn>(&sm.v[0][0], S::kLd, 16 * kk, 8 * nt, vb);
          ssm::mma_terms<kDer, kIn>(st[nt], a, vb);
        }
      }
    }
    __syncthreads();                 // w and v are free: stage the next
    if (ch + 1 < n_chunks) {
      stage(ch + 1, &sm.v[0][0], v);
      stage_w(ch + 1);
      ssm::cp_async_commit();
    }
  }

  if (owns_state) {
    float* so = state_out + static_cast<size_t>(bh) * n_dim * n_dim;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key0 : key1, n = 8 * nt + 2 * q + (e & 1);
        if (key < n_dim && n < n_dim)
          so[static_cast<size_t>(key) * n_dim + n] = st[nt][e];
      }
  }
}

template <typename T, int NP>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w_log, const void* u, const void* state0,
                   void* y, void* state_out, int batch, int seq, int heads,
                   int n_dim, cudaStream_t stream) {
  static bool smem_set = false;
  const auto kernel = wkv6_kernel<T, NP>;
  constexpr size_t smem = sizeof(Smem<T, NP>);
  cudaError_t err = ssm::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const size_t row = n_dim * sizeof(T);
  const int gran = std::min({contract::copy_granule(r, row),
                             contract::copy_granule(k, row),
                             contract::copy_granule(v, row)});
  const int gran_w = contract::copy_granule(w_log, n_dim * sizeof(float));
  kernel<<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w_log),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state_out), seq, heads, n_dim,
      gran, gran_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w_log, const void* u, const void* state0,
                     void* y, void* state_out, int batch, int seq, int heads,
                     int n, cudaStream_t stream) {
  switch (n) {
    case 8:
    case 16:
      return launch<T, 16>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, n, stream);
    case 32:
      return launch<T, 32>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, n, stream);
    case 64:
      return launch<T, 64>(r, k, v, w_log, u, state0, y, state_out, batch,
                           seq, heads, n, stream);
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
