// The chunked tensor-core design shared by the two state-space kernels,
// ssd.cu and wkv6.cu, for Hopper (sm_90a). kernels/ssm_chunks.py is its
// host side and replays its roundings for the emulations.
//
// One CTA of 4 warps owns one (batch, head) and walks its sequence in
// chunks of kChunk tokens, so the sequential chain is seq / kChunk state
// hops, not seq token updates. Warp w owns one kSub-token sub-chunk's
// rows of y (one m16 tile) and 16 rows of the state, whose float32 value
// stays in mma accumulator fragments for the whole sequence and is
// written to shared memory once per chunk (as bf16 terms) for the next
// chunk's inter-chunk product. A chunk's inputs are staged with cp.async
// into single buffers, each restaged as soon as the chunk is done with
// it: shared memory stays small enough for 3 (wkv6) or 4 (ssd) CTAs on
// an SM, whose warps cover each other's waits, and the prefills' 320 and
// 448 CTAs run in one round. The tail of the last chunk is zero-filled,
// which makes its tokens a no-op (no decay, no input).
//
// Products run on mma.sync m16n8k16 bf16 with float32 accumulation. An
// input operand of bf16 type is exact and enters as itself; a float32
// input, and every float32 value the kernel derives (a decayed factor,
// the state, a masked score), enters as a sum of bf16 terms: hi + lo for
// bf16 inputs (about 16 significant bits), hi + mid + lo for float32
// inputs (the whole float32 significand). A product of two split
// operands keeps the cross terms whose orders add up to less than the
// larger term count, smallest first (mma_terms). Sums over tokens and
// keys run in a fixed order with no atomics, so two runs give the same
// bits.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "contract_sm90.cuh"

namespace ssm {

constexpr int kChunk = 64;     // tokens per chunk: one state hop
constexpr int kSub = 16;       // tokens per warp: one m16 tile of rows
constexpr int kWarps = kChunk / kSub;
constexpr int kThreads = 32 * kWarps;

// bf16 terms of an input operand (in) and of a derived float32 one (der)
template <typename T> struct Terms;
template <> struct Terms<__nv_bfloat16> {
  static constexpr int in = 1, der = 2;
};
template <> struct Terms<float> {
  static constexpr int in = 3, der = 3;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as NT packed bf16 pairs (a in the low half): term i is rounded
// to nearest even from what terms 0..i-1 left; each difference is exact.
template <int NT>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&out)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    out[i] = bits(t);
    if (i + 1 < NT) {
      a = __fsub_rn(a, __low2float(t));
      b = __fsub_rn(b, __high2float(t));
    }
  }
}

// d += sum of a[i] b[j] over i + j < max(NA, NB), the smallest orders
// first; fragment layouts as in contract_sm90.cuh
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int order = kMax - 1; order >= 0; --order)
#pragma unroll
    for (int i = NA - 1; i >= 0; --i) {
      const int j = order - i;
      if (j >= 0 && j < NB) contract::mma_bf16(d, a[i], b[j]);
    }
}

// The A fragment (16 x 16) from the eight values a lane holds, in the
// order of two C fragments side by side: (g, 2q), (g, 2q+1), (g+8, 2q),
// (g+8, 2q+1), then the same at columns + 8. So an accumulator tile of
// 16 x 16 becomes the A operand of the next product in registers.
template <int NT>
__device__ __forceinline__ void frag_a(const float (&v)[8],
                                       uint32_t (&a)[NT][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t t[NT];
    split_pair<NT>(v[2 * r], v[2 * r + 1], t);
#pragma unroll
    for (int i = 0; i < NT; ++i) a[i][r] = t[i];
  }
}

// The B fragment (16 x 8) from the four values a lane holds: K rows 2q,
// 2q + 1, 2q + 8, 2q + 9 of column g.
template <int NT>
__device__ __forceinline__ void frag_b(float k0, float k1, float k8, float k9,
                                       uint32_t (&b)[NT][2]) {
  uint32_t t0[NT], t1[NT];
  split_pair<NT>(k0, k1, t0);
  split_pair<NT>(k8, k9, t1);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    b[i][0] = t0[i];
    b[i][1] = t1[i];
  }
}

// The A fragment of an input tile held row-major in shared memory (K
// along the row): row0 / row1 point at the lane's rows g and g + 8,
// column 2q of the K-step.
template <int NT, typename T>
__device__ __forceinline__ void input_a(const T* row0, const T* row1,
                                        uint32_t (&a)[NT][4]) {
  if constexpr (sizeof(T) == 2) {
    static_assert(NT == 1, "bf16 inputs are exact");
    a[0][0] = *reinterpret_cast<const uint32_t*>(row0);
    a[0][1] = *reinterpret_cast<const uint32_t*>(row1);
    a[0][2] = *reinterpret_cast<const uint32_t*>(row0 + 8);
    a[0][3] = *reinterpret_cast<const uint32_t*>(row1 + 8);
  } else {
    const float2 p0 = *reinterpret_cast<const float2*>(row0);
    const float2 p1 = *reinterpret_cast<const float2*>(row1);
    const float2 p2 = *reinterpret_cast<const float2*>(row0 + 8);
    const float2 p3 = *reinterpret_cast<const float2*>(row1 + 8);
    const float v[8] = {p0.x, p0.y, p1.x, p1.y, p2.x, p2.y, p3.x, p3.y};
    frag_a<NT>(v, a);
  }
}

// The B fragment of an input tile whose K runs along the row: `p` points
// at column g's row, K = 2q of the K-step.
template <int NT, typename T>
__device__ __forceinline__ void input_b_row(const T* p,
                                            uint32_t (&b)[NT][2]) {
  if constexpr (sizeof(T) == 2) {
    static_assert(NT == 1, "bf16 inputs are exact");
    b[0][0] = *reinterpret_cast<const uint32_t*>(p);
    b[0][1] = *reinterpret_cast<const uint32_t*>(p + 8);
  } else {
    const float2 p0 = *reinterpret_cast<const float2*>(p);
    const float2 p1 = *reinterpret_cast<const float2*>(p + 8);
    frag_b<NT>(p0.x, p0.y, p1.x, p1.y, b);
  }
}

// The B fragment of an input tile whose K runs down the rows: K rows
// k0 .. k0 + 15 and columns n0 .. n0 + 7 of a row-major tile with row
// stride ld. bf16: one ldmatrix .trans (the rows are 16-byte aligned);
// float32: the lane's four values, split.
template <int NT, typename T>
__device__ __forceinline__ void input_b_col(const T* tile, int ld, int k0,
                                            int n0, uint32_t (&b)[NT][2]) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  if constexpr (sizeof(T) == 2) {
    static_assert(NT == 1, "bf16 inputs are exact");
    contract::ldmatrix_b_trans(
        b[0], reinterpret_cast<const __nv_bfloat16*>(
                  tile + (k0 + (lane & 15)) * ld + n0));
  } else {
    const T* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    frag_b<NT>(p[0], p[ld], p[8 * ld], p[9 * ld], b);
  }
}

// y[0..1] = (a, b) where p and p + 1 lie below `limit` columns; one
// paired store when the row length is even (the pair is then aligned)
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b, int col,
                                           int limit) {
  if ((limit & 1) == 0 && col + 1 < limit) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(a, b);
    return;
  }
  if (col < limit) put(dst, a);
  if (col + 1 < limit) put(dst + 1, b);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Allow `kernel` `bytes` of dynamic shared memory (once per kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

}  // namespace ssm
