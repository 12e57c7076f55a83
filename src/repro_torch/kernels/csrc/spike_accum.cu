// Synaptic accumulation I = S @ W with the spike-tile skip, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spike_accum.py::spike_accum
// (body `_kernel`, launched by its pallas_call):
//   out[b, p] = sum_q S[b, q] * W[q, p]
// over S [B, N_pre] and W [N_pre, N_post] of one type: float32 and bf16
// sum in float32, int32 sums in int32 and wraps (done in uint32, whose
// overflow C++ defines). A K-step (32 pre neurons) whose spikes are all
// zero in a tile's batch rows issues no product: the MC-tree skip of the
// TPU kernel (spike_accum.py:41-48).
//
// What bounds it on the H100: at the SHD training shapes (B = 32; 700 x
// 300, 300 x 300 and 300 x 20 planes) a call moves under a megabyte and
// does a few MFLOP: far below what a launch costs, so the kernel is
// bound by launch and memory latency.
//
// What the design does about that (contract_sm90.cuh): a CTA owns 16
// batch rows x 32 post neurons and, in a cluster of up to 8 CTAs, one
// K-range of the pre axis (at SHD layer 0: 10 post tiles x 2 batch tiles
// x 8 ranks = 160 CTAs, each holding at most 3 K-steps). It requests its
// W slice and its spikes with cp.async (16 B per copy where the rows are
// aligned so); warp w owns posts [8w, 8w + 8) of the tile and walks the
// CTA's K-steps in ascending order, its products chosen by type:
//   * bf16: mma.m16n8k16 bf16 -> f32 with M = batch rows (A = the spikes,
//     one 32-bit shared load per register), N = posts (B = W, row-major,
//     through ldmatrix .trans); bf16 x bf16 products are exact in float32
//     whatever the spike values;
//   * float32: each thread splits its B elements of W, in registers, into
//     three bf16 terms, hi = bf16(w), mid = bf16(w - hi), lo = bf16(w -
//     hi - mid), which hold every float32 of magnitude in [2^-100, 2^127)
//     exactly; a 0/1 spike (the A operand, converted as loaded) times each
//     term is exact, so three bf16 products per K-step give the float32
//     product, each term summed apart. W changes every training step, so
//     the split is made per call, never cached. A K-step holding a spike
//     outside {0, 1}, or a weight of the warp's columns the split cannot
//     hold (smaller than 2^-100, 2^127 or larger, or not finite), takes
//     FFMA products instead;
//   * int32: exact uint32 products on the CUDA cores.
// The other ranks send their partial tiles to the cluster's rank 0
// through distributed shared memory, which adds them in rank order. Every
// output is summed in one fixed order with no atomics, so a float result
// is the same from run to run: the deterministic commit of
// spike_accum.py:13-14.

#include "contract_sm90.cuh"

namespace {

using namespace contract;
using bf16 = __nv_bfloat16;

constexpr int kBM = 16;                 // batch rows per CTA (one m16)
constexpr int kBN = 32;                 // post neurons per CTA (4 x n8)
constexpr int kWarps = kBN / 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kThreads == kChunk, "a thread stages one spike column");
// shared row strides, in elements: 16-byte aligned rows, ldmatrix and
// fragment loads free of bank conflicts
constexpr int kLdW32 = kBN + 4;         // float32 / int32 W rows
constexpr int kLdW16 = kBN + 8;         // bf16 W rows (80 B)
constexpr int kLdS32 = kChunk + 4;      // float32 / int32 spike rows
constexpr int kLdS16 = kChunk + 8;      // bf16 spike rows

// the shared buffers: W and the spikes as staged; bf16 rows are padded
// for ldmatrix, 4-byte rows for the fragment loads
template <typename T> struct Layout {
  static constexpr bool b16 = std::is_same<T, bf16>::value;
  static constexpr int ld_w = b16 ? kLdW16 : kLdW32;
  static constexpr int ld_s = b16 ? kLdS16 : kLdS32;
  static constexpr int w_bytes = kChunk * ld_w * sizeof(T);
  static constexpr int bytes = w_bytes + kBM * ld_s * sizeof(T);
};

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int32_t> { using type = uint32_t; };

// one thread's C fragment, moved as one 16-byte store
template <typename A> struct alignas(16) Frag { A v[4]; };

__device__ __forceinline__ bool splittable(float w) {
  const float a = fabsf(w);
  return w == 0.0f || (a >= 0x1p-100f && a < 0x1p127f);
}

__device__ __forceinline__ uint32_t pack_bf16(float2 x) {
  const __nv_bfloat162 h = __float22bfloat162_rn(x);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x (two weights) = hi + mid + lo, each a bf16 pair packed for the mma:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), with each
// difference exact in float32
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(x);
  const float2 hf = __bfloat1622float2(h);
  const float2 r1 = make_float2(__fsub_rn(x.x, hf.x), __fsub_rn(x.y, hf.y));
  const __nv_bfloat162 m = __float22bfloat162_rn(r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(make_float2(__fsub_rn(r1.x, mf.x), __fsub_rn(r1.y, mf.y)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spike_accum_kernel(const T* __restrict__ s, const T* __restrict__ w,
                   void* __restrict__ out, int batch, int n_pre, int n_post,
                   int n_split, int s_granule, int w_granule) {
  using L = Layout<T>;
  using A = typename Acc<T>::type;
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const w_st = reinterpret_cast<T*>(smem);               // [K][32 posts]
  T* const s_st = reinterpret_cast<T*>(smem + L::w_bytes);  // [16][K]
  __shared__ uint32_t flags_s[kChunkSteps];   // bit 0 live, 1 non-binary
  // rank 0's: the other ranks' partial tiles, in C-fragment order
  __shared__ Frag<A> slot_s[kMaxCluster - 1][kThreads];
  __shared__ uint64_t bar_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const RankReduce reduce{&bar_s, n_split};
  reduce.start(rank);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = (blockIdx.x / n_split) * kBN;
  const int b0 = blockIdx.y * kBM;
  const int n_ks = (n_pre + kKStep - 1) / kKStep;
  const int kb = kstep_begin(rank, n_ks, n_split) * kKStep;
  const int ke = min(kstep_begin(rank + 1, n_ks, n_split) * kKStep, n_pre);
  const int col = 8 * warp + 2 * t;             // this thread's C columns

  // float32's three terms sum apart, so that their products form three
  // short dependency chains; bf16, int32 and FFMA products use acc
  A acc[4] = {A(0), A(0), A(0), A(0)};
  float acc_m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_l[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int c0 = kb; c0 < ke; c0 += kChunk) {
    // W rows [c0, c0 + 128) x posts [n0, n0 + 32); spikes rows [b0,
    // b0 + 16) x pre [c0, c0 + 128); zeros past the edges and the range
    stage<kThreads, kChunk, kBN>(w_st, L::ld_w, w, n_post, c0, ke, n0,
                                 n_post, w_granule);
    stage<kThreads, kBM, kChunk>(s_st, L::ld_s, s, n_pre, b0, batch, c0, ke,
                                 s_granule);
    cp_async_wait_all();
    __syncthreads();

    // spike flags: thread t reads column t, so warp w reads K-step w
    bool live = false, nonbinary = false;
#pragma unroll
    for (int r = 0; r < kBM; ++r) {
      const T x = s_st[r * L::ld_s + threadIdx.x];
      if constexpr (L::b16) {
        live |= __bfloat162float(x) != 0.0f;
      } else {
        live |= x != T(0);
        if constexpr (f32) nonbinary |= x != 0.0f && x != 1.0f;
      }
    }
    live = __any_sync(0xffffffffu, live);
    nonbinary = __any_sync(0xffffffffu, nonbinary);
    if (lane == 0) flags_s[warp] = (live ? 1u : 0u) | (nonbinary ? 2u : 0u);
    __syncthreads();

    for (int ks = 0; ks < kChunkSteps; ++ks) {
      const uint32_t flags = flags_s[ks];
      if (!(flags & 1u)) continue;             // the MC-tree skip
      const int k0 = ks * kKStep;
      if constexpr (std::is_same<T, int32_t>::value) {
        for (int k = k0; k < k0 + kKStep; ++k) {
          const uint32_t s0 = static_cast<uint32_t>(s_st[g * kLdS32 + k]);
          const uint32_t s8 =
              static_cast<uint32_t>(s_st[(g + 8) * kLdS32 + k]);
          const uint32_t w0 = static_cast<uint32_t>(w_st[k * kLdW32 + col]);
          const uint32_t w1 =
              static_cast<uint32_t>(w_st[k * kLdW32 + col + 1]);
          acc[0] += s0 * w0;
          acc[1] += s0 * w1;
          acc[2] += s8 * w0;
          acc[3] += s8 * w1;
        }
      } else if constexpr (L::b16) {
#pragma unroll
        for (int kk = k0; kk < k0 + kKStep; kk += 16) {
          uint32_t a[4], b[2];
          const bf16* sa = s_st + g * kLdS16 + kk + 2 * t;
          a[0] = *reinterpret_cast<const uint32_t*>(sa);
          a[1] = *reinterpret_cast<const uint32_t*>(sa + 8 * kLdS16);
          a[2] = *reinterpret_cast<const uint32_t*>(sa + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(sa + 8 * kLdS16 + 8);
          ldmatrix_b_trans(b, w_st + (kk + lane % 16) * kLdW16 + 8 * warp);
          mma_bf16(acc, a, b);
        }
      } else {
        // float32: this thread's B elements of the K-step (rows kk + 2t,
        // + 1, + 8, + 9 of post 8 warp + g), split into three bf16 terms
        // in registers; the warp takes FFMA products instead if a spike is
        // not 0/1 or a weight does not split
        float wv[2][4];
        bool split_ok = true;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* wb =
              w_st + (k0 + 16 * h + 2 * t) * kLdW32 + 8 * warp + g;
          wv[h][0] = wb[0];
          wv[h][1] = wb[kLdW32];
          wv[h][2] = wb[8 * kLdW32];
          wv[h][3] = wb[9 * kLdW32];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_ok &= splittable(wv[h][i]);
        }
        if ((flags & 2u) || __any_sync(0xffffffffu, !split_ok)) {
          for (int k = k0; k < k0 + kKStep; ++k) {
            const float s0 = s_st[g * kLdS32 + k];
            const float s8 = s_st[(g + 8) * kLdS32 + k];
            const float w0 = w_st[k * kLdW32 + col];
            const float w1 = w_st[k * kLdW32 + col + 1];
            acc[0] = __fmaf_rn(s0, w0, acc[0]);
            acc[1] = __fmaf_rn(s0, w1, acc[1]);
            acc[2] = __fmaf_rn(s8, w0, acc[2]);
            acc[3] = __fmaf_rn(s8, w1, acc[3]);
          }
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sa = s_st + g * kLdS32 + k0 + 16 * h + 2 * t;
          uint32_t a[4], hi[2], mid[2], lo[2];
          a[0] = pack_bf16(*reinterpret_cast<const float2*>(sa));
          a[1] = pack_bf16(*reinterpret_cast<const float2*>(sa + 8 * kLdS32));
          a[2] = pack_bf16(*reinterpret_cast<const float2*>(sa + 8));
          a[3] = pack_bf16(
              *reinterpret_cast<const float2*>(sa + 8 * kLdS32 + 8));
          split3(make_float2(wv[h][0], wv[h][1]), hi[0], mid[0], lo[0]);
          split3(make_float2(wv[h][2], wv[h][3]), hi[1], mid[1], lo[1]);
          mma_bf16(acc_l, a, lo);
          mma_bf16(acc_m, a, mid);
          mma_bf16(acc, a, hi);
        }
      }
    }
    __syncthreads();                           // the buffers are restaged
  }

  if constexpr (f32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += acc_l[i] + acc_m[i];
  }
  if (rank != 0) {
    reduce.push(cluster, &slot_s[rank - 1][0], [&](Frag<A>* dst) {
      dst[threadIdx.x] = Frag<A>{{acc[0], acc[1], acc[2], acc[3]}};
    });
    return;
  }
  reduce.receive();
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) {
    if (r < n_split) {
      const Frag<A> f = slot_s[r - 1][threadIdx.x];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += f.v[i];
    }
  }
  // c0 / c1: row g, columns col and col + 1; c2 / c3: row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = b0 + g + 8 * (i >> 1), p = n0 + col + (i & 1);
    if (row < batch && p < n_post) {
      const size_t o = static_cast<size_t>(row) * n_post + p;
      if constexpr (std::is_same<T, int32_t>::value)
        static_cast<int32_t*>(out)[o] = static_cast<int32_t>(acc[i]);
      else
        static_cast<float*>(out)[o] = acc[i];
    }
  }
}

// The widest copy (16, 8 or 4 bytes) that keeps every row of a matrix at
// `p` with rows of `row_bytes` aligned from a column that is a multiple of
// a K-step; 2 or 1 (below 4: element by element) where none does.
int copy_granule(const void* p, size_t row_bytes) {
  const size_t x = (reinterpret_cast<uintptr_t>(p) | row_bytes) & 15u;
  return x == 0 ? 16 : static_cast<int>(x & (~x + 1));
}

template <typename T>
cudaError_t launch(const void* s, const void* w, void* out, int batch,
                   int n_pre, int n_post, cudaStream_t stream) {
  const int s_granule = copy_granule(s, sizeof(T) * n_pre);
  const int w_granule = copy_granule(w, sizeof(T) * n_post);
  constexpr int bytes = Layout<T>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      spike_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const int n_split = cluster_split((n_pre + kKStep - 1) / kKStep);
  const dim3 grid(((n_post + kBN - 1) / kBN) * n_split,
                  (batch + kBM - 1) / kBM);
  return launch_cluster(spike_accum_kernel<T>, grid, kThreads, bytes,
                        n_split, stream, static_cast<const T*>(s),
                        static_cast<const T*>(w), out, batch, n_pre, n_post,
                        n_split, s_granule, w_granule);
}

}  // namespace

// s [batch, n_pre] and w [n_pre, n_post] are contiguous arrays of one
// type: dtype 0 float32, 1 bf16, 2 int32. out [batch, n_post] is float32
// for dtypes 0 and 1, int32 for 2. batch and n_post are positive; batch
// is at most 65535 * 16 (the grid's y limit). Returns the launch's
// cudaError_t.
extern "C" int suprasnn_spike_accum(const void* s, const void* w, void* out,
                                    int dtype, int batch, int n_pre,
                                    int n_post, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(s, w, out, batch, n_pre, n_post, st);
    case 1:
      return launch<bf16>(s, w, out, batch, n_pre, n_post, st);
    case 2:
      return launch<int32_t>(s, w, out, batch, n_pre, n_post, st);
    default:
      return cudaErrorInvalidValue;
  }
}
