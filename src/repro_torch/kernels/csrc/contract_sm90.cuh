// The device design shared by the two contraction kernels, fused_step.cu
// and spike_accum.cu, for Hopper (sm_90a).
//
// Both compute out = S @ W over a pre (K) axis of a few hundred to a few
// thousand neurons, at small batch. At those sizes the work is a few MOP
// and under a megabyte, far below what a launch costs, so time goes to
// memory latency. The design pays that latency once per CTA:
//
// * The K axis is split across a thread-block cluster of up to 8 CTAs
//   (the portable limit), launched with cudaLaunchKernelEx. CTA `rank` of
//   a cluster owns one output tile and the K-steps
//   [kstep_begin(rank), kstep_begin(rank + 1)); a K-step is 32 pre
//   neurons, the granule of the MC-tree skip. So a CTA holds at most
//   ceil(n_ksteps / 8) K-steps and, at the SHD shapes, about 128 pre rows.
// * A CTA requests its whole W slice at once with cp.async (16 B per
//   thread where the rows allow it) and stages its spikes beside it: one
//   round of loads, not one per pre row. Slices longer than a chunk of
//   kChunkSteps K-steps are walked chunk by chunk.
// * Products run on the tensor cores (mma.sync) where they are exact, on
//   the CUDA cores where they would not be.
// * The ranks' partial tiles meet in the rank-0 CTA (RankReduce): each
//   other rank writes its tile into a slot of rank 0's shared memory
//   through distributed shared memory (cluster.map_shared_rank) and
//   arrives on an mbarrier there, then exits; rank 0 waits on it, adds
//   the slots to its own tile in rank order and runs the epilogue. No
//   atomics touch a sum, so float results repeat bit for bit from run to
//   run.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace contract {

namespace cg = cooperative_groups;

constexpr int kKStep = 32;        // pre neurons per K-step
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kChunkSteps = 4;    // K-steps staged per pass
constexpr int kChunk = kKStep * kChunkSteps;

// How many CTAs split n_ksteps K-steps, and where rank r's range begins.
// kernels/fused_step.py::cluster_split mirrors this for the emulation.
__host__ __device__ inline int cluster_split(int n_ksteps) {
  return n_ksteps < 1 ? 1 : (n_ksteps < kMaxCluster ? n_ksteps : kMaxCluster);
}
__host__ __device__ inline int kstep_begin(int rank, int n_ksteps,
                                           int n_split) {
  return rank * n_ksteps / n_split;
}

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (<= N) from global to shared and zero the rest of N.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(N), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Stage the window rows [r0, r0 + NR) x cols [c0, c0 + NC) of a row-major
// global matrix (leading dimension ld) into shared memory with row stride
// sld, zero wherever row >= r_end or col >= c_end, in copies of G bytes:
// 16, 8 or 4 through cp.async (the caller checked that ld, the base
// pointer and c0 keep every copy aligned to it), below 4 element by
// element. NC * sizeof(T) and sld * sizeof(T) are multiples of 16.
// A thread's copies share one column and step down the rows, so the loop
// is pointer increments with no index arithmetic: with one warp per
// scheduler nothing hides that arithmetic's latency. Completion:
// cp_async_wait_all() then a barrier.
template <int G, int THREADS, int NR, int NC, typename T>
__device__ __forceinline__ void stage_by(T* dst, int sld, const T* src,
                                         size_t ld, int r0, int r_end,
                                         int c0, int c_end) {
  constexpr int E = sizeof(T);
  constexpr int per = G >= 4 ? G / E : 1;      // elements per copy
  constexpr int vpr = NC / per;                // copies per row
  static_assert(NC % per == 0 && THREADS % vpr == 0, "copies tile rows");
  constexpr int rstep = THREADS / vpr;         // rows between a thread's
  constexpr int iters = (NR + rstep - 1) / rstep;
  const int c = static_cast<int>(threadIdx.x) % vpr * per;
  const int r = static_cast<int>(threadIdx.x) / vpr;
  const int valid_c = min(max(c_end - (c0 + c), 0), per);
  const T* g = src + static_cast<size_t>(r0 + r) * ld + (c0 + c);
  T* s = dst + r * sld + c;
  if constexpr (G >= 4) {
#pragma unroll
    for (int j = 0; j < iters; ++j) {
      if (NR % rstep == 0 || r + j * rstep < NR) {
        const int valid = r0 + r + j * rstep < r_end ? valid_c : 0;
        cp_async<G>(s + j * rstep * sld, valid ? g + j * rstep * ld : src,
                    valid * E);
      }
    }
  } else {
    T v[iters];                                // every load, then stores
#pragma unroll
    for (int j = 0; j < iters; ++j)
      v[j] = (NR % rstep == 0 || r + j * rstep < NR) &&
                     r0 + r + j * rstep < r_end && valid_c
                 ? g[j * rstep * ld]
                 : T(0);
#pragma unroll
    for (int j = 0; j < iters; ++j)
      if (NR % rstep == 0 || r + j * rstep < NR) s[j * rstep * sld] = v[j];
  }
}

// stage_by with the copy width known only at run time (uniform per launch)
template <int THREADS, int NR, int NC, typename T>
__device__ __forceinline__ void stage(T* dst, int sld, const T* src,
                                      size_t ld, int r0, int r_end, int c0,
                                      int c_end, int granule) {
  if (granule == 16)
    stage_by<16, THREADS, NR, NC>(dst, sld, src, ld, r0, r_end, c0, c_end);
  else if (granule == 8)
    stage_by<8, THREADS, NR, NC>(dst, sld, src, ld, r0, r_end, c0, c_end);
  else if (granule == 4 && sizeof(T) <= 4)
    stage_by<4, THREADS, NR, NC>(dst, sld, src, ld, r0, r_end, c0, c_end);
  else
    stage_by<1, THREADS, NR, NC>(dst, sld, src, ld, r0, r_end, c0, c_end);
}

// ---- tensor-core products ------------------------------------------------
// Fragments of mma.sync.m16n8k{32,16}: lane = 4 * g + t. A (16 x K,
// row-major): a0 row g, a1 row g + 8, a2 / a3 the same rows at K + half;
// B (K x 8, "col"): b0 column g at K 4t.. (8-bit) or 2t.. (16-bit), b1
// the same at K + half; C: c0 / c1 row g, columns 2t and 2t + 1; c2 / c3
// row g + 8.

// d += A (u8) * B (u8), exact integer products, int32 sums (no .satfinite)
__device__ __forceinline__ void mma_u8u8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (s8) * B (u8)
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (bf16) * B (bf16), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of a 16 x 8 bf16 tile kept K-major in shared memory (row
// k holds 8 consecutive columns, 16-byte aligned): ldmatrix .trans turns
// the rows into the column pairs the mma wants. Lanes 0-15 address rows
// k0 .. k0 + 15; the other lanes' addresses are not read.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t (&b)[2],
                                                 const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1]) : "r"(smem_addr(row)));
}

// ---- the rank-order reduction ------------------------------------------

// Rank 0 of a cluster of n_split CTAs receives the other ranks' partial
// tiles in `slots` (slot r - 1 from rank r, in its shared memory) and an
// arrival of each on `bar`. Usage, by every thread of every CTA:
//   start(...)                       at kernel entry (rank 0 inits bar)
//   ... the CTA computes its partial tile ...
//   if (rank) { push(...) ... return; }    ranks > 0 send and exit
//   receive(...)                     rank 0: the slots are readable
// start() arrives on a cluster barrier that push() and receive() wait
// on, so bar is initialised before any rank touches it; the wait comes
// long after the arrival, so it costs nothing.
struct RankReduce {
  uint64_t* bar;        // in each CTA's shared memory; rank 0's is used
  int n_split;

  __device__ __forceinline__ void start(int rank) const {
    if (n_split == 1) return;
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_addr(bar)), "r"(n_split - 1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }

  // Rank > 0: `write(T* leader_slot)` stores this CTA's tile into rank
  // 0's slot (the pointer maps rank 0's shared memory); then one arrival.
  template <typename T, typename Write>
  __device__ __forceinline__ void push(cg::cluster_group& cluster,
                                       T* slot, Write write) const {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    write(cluster.map_shared_rank(slot, 0));
    __syncthreads();                  // every thread's stores, then release
    if (threadIdx.x == 0) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                   : "=r"(remote) : "r"(smem_addr(bar)));
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
          :: "r"(remote) : "memory");
    }
  }

  // Rank 0: returns once every other rank's slot is written.
  __device__ __forceinline__ void receive() const {
    if (n_split == 1) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    asm volatile(
        "{\n .reg .pred done;\n"
        "WAIT_%=:\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, "
        "[%0], 0;\n"
        " @!done bra WAIT_%=;\n}\n"
        :: "r"(smem_addr(bar)) : "memory");
  }
};

// ---- launch --------------------------------------------------------------

// Launch `kernel` over `grid` with clusters of n_split CTAs along x.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           size_t smem, int n_split, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel,
                                             static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace contract
