// One whole SupraSNN timestep in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py::fused_step
// (body `_kernel`, launched by its pallas_call). Per batch row b:
//   current[b, p] = sum_q s_all[b, q] * W[q, p]        (int32, wrapping)
//   pkt[b]        = #{q : s_all[b, q] != 0}            (one MC packet each)
//   v' = v - (v >> leak_shift) + current; spike = v' >= v_threshold;
//   v  = spike ? v_reset : v'                          (in place)
// with s_all = ext_t ‖ s_prev read through two pointers, never concatenated.
//
// What bounds it on the H100: at the SHD shape (1020 pre x 320 post, an
// int16 plane, B = 8) a step reads under 700 KB (L2-resident after the
// first step) and does a few MOP: both far below what a launch costs.
// The step is bound by launch and memory latency.
//
// What the design does about that (contract_sm90.cuh): the plane comes
// packed once at engine build (kernels/fused_step.py::pack_plane) as
// W^T [m_pad, k_pad], K-contiguous, padded with zeros to multiples of 16
// posts and 32 pre neurons; an int16 plane as two byte planes, lo =
// W & 0xFF (u8) and hi = W >> 8 (s8). A CTA owns 16 post neurons x 8
// batch rows and, in a cluster of up to 8 CTAs, one K-range of the pre
// axis: at the SHD shape 20 post tiles x 8 ranks = 160 CTAs of 128
// threads, each holding 4 K-steps. It requests its W slice with 16-byte
// cp.async and stages its spikes beside it (one memory latency), then
// warp w takes K-step w of each chunk:
//   * a K-step whose spikes are all zero in the tile's rows issues no
//     product (the MC-tree skip);
//   * a K-step of 0/1 spikes runs on the s8 tensor cores:
//     mma.m16n8k32 with M = posts (A = W^T, one 32-bit shared load per
//     register), N = batch rows (B = the spikes as u8, which s_all's
//     row-major layout already is), K = pre; an int8 plane takes one
//     product, an int16 plane two, current = 256 * (s @ hi) + s @ lo,
//     combined in uint32 so that it wraps as the reference does;
//   * a K-step holding any spike outside {0, 1} (external spikes are any
//     int32), and every K-step of an int32 plane (the range proof needs
//     more than 16 bits), takes exact int32 products on the CUDA cores.
// The warps' partial currents meet in shared memory; the other ranks
// send theirs to the cluster's rank 0 through distributed shared memory,
// which adds them in rank order and runs the Neuron Unit epilogue with v
// already loaded. Packets are counted by the CTAs of the first post tile
// and summed the same way.
// Spikes go to s_next, a buffer apart from s_prev: other CTAs of this
// launch still read s_prev.

#include "contract_sm90.cuh"

namespace {

using namespace contract;

constexpr int kM = 16;                 // post neurons per CTA (one m16)
constexpr int kN = 8;                  // batch rows per CTA (one n8)
constexpr int kWarps = kChunkSteps;    // warp w takes K-step w of a chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kPad8 = kChunk + 16;     // byte rows: 144 B, conflict-free
constexpr int kPad32 = kChunk + 4;     // int32 rows
static_assert(kThreads == kChunk, "a thread stages one spike column");
static_assert(kThreads == kM * kN, "epilogue: one thread per output");

// kind: the plane's element size, 1 (int8), 2 (int16 as lo/hi) or 4
template <int kind>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const int32_t* __restrict__ ext,
                  const int32_t* __restrict__ s_prev,
                  const void* __restrict__ plane0,
                  const int8_t* __restrict__ plane1, int32_t* __restrict__ v,
                  int32_t* __restrict__ s_next, int32_t* __restrict__ pkt,
                  int batch, int n_ext, int n_int, int k_pad, int n_split,
                  int leak_shift, int v_threshold, int v_reset) {
  __shared__ __align__(16) uint8_t w0_s[kind == 4 ? 16 : kM * kPad8];
  __shared__ __align__(16) int8_t w1_s[kind == 2 ? kM * kPad8 : 16];
  __shared__ __align__(16) int32_t w32_s[kind == 4 ? kM * kPad32 : 4];
  __shared__ __align__(16) uint8_t s8_s[kN * kPad8];
  __shared__ int32_t s32_s[kN][kChunk];
  __shared__ uint32_t part_s[kWarps][kN][kM];
  __shared__ uint32_t pkt_s[kN];
  __shared__ uint32_t flags_s[kWarps];   // bit 0 live, bit 1 non-binary
  // rank 0's: the other ranks' currents (one per thread), then packets
  __shared__ uint32_t slot_s[kMaxCluster - 1][kThreads + kN];
  __shared__ uint64_t bar_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const RankReduce reduce{&bar_s, n_split};
  reduce.start(rank);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (blockIdx.x / n_split) * kM;
  const int b0 = blockIdx.y * kN;
  const int n_all = n_ext + n_int;
  const int n_ks = k_pad / kKStep;
  const int kb = kstep_begin(rank, n_ks, n_split) * kKStep;
  const int ke = kstep_begin(rank + 1, n_ks, n_split) * kKStep;
  const bool count_packets = m0 == 0;

  // rank 0 loads its epilogue's v now, under the staging latency
  const int eb = threadIdx.x / kM, ep = threadIdx.x % kM;
  const int e_row = b0 + eb, e_col = m0 + ep;
  const bool e_ok = rank == 0 && e_row < batch && e_col < n_int;
  const size_t e_i = static_cast<size_t>(e_row) * n_int + e_col;
  const int32_t v_old = e_ok ? v[e_i] : 0;

  if (threadIdx.x < kN) pkt_s[threadIdx.x] = 0u;   // the loop syncs first
  int d_lo[4] = {0, 0, 0, 0}, d_hi[4] = {0, 0, 0, 0};
  uint32_t exact[4] = {0u, 0u, 0u, 0u};
  uint32_t cnt[kN];
#pragma unroll
  for (int r = 0; r < kN; ++r) cnt[r] = 0u;

  for (int c0 = kb; c0 < ke; c0 += kChunk) {
    const int nc = min(kChunk, ke - c0);
    // W^T [m0, m0 + 16) x [c0, c0 + nc): rows are 16-byte aligned (k_pad
    // is a multiple of 32), so 16-byte copies throughout
    if constexpr (kind == 4) {
      stage_by<16, kThreads, kM, kChunk>(
          w32_s, kPad32, static_cast<const int32_t*>(plane0), k_pad, m0,
          m0 + kM, c0, c0 + nc);
    } else {
      stage_by<16, kThreads, kM, kChunk>(
          w0_s, kPad8, static_cast<const uint8_t*>(plane0), k_pad, m0,
          m0 + kM, c0, c0 + nc);
      if constexpr (kind == 2)
        stage_by<16, kThreads, kM, kChunk>(w1_s, kPad8, plane1, k_pad, m0,
                                           m0 + kM, c0, c0 + nc);
    }
    // spikes: thread t loads column c0 + t of the tile's 8 rows (every
    // load issued before the first is used); the columns of warp w are
    // K-step w of the chunk
    const int q = c0 + threadIdx.x;
    const bool in_ext = q < n_ext;
    const int32_t* src =
        in_ext ? ext + q : s_prev + (q - n_ext);   // row b0's element
    const size_t ld = in_ext ? n_ext : n_int;
    const bool col_ok = q < n_all && static_cast<int>(threadIdx.x) < nc;
    int32_t sv[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r)
      sv[r] = col_ok && b0 + r < batch
                  ? src[static_cast<size_t>(b0 + r) * ld]
                  : 0;
    bool live = false, nonbinary = false;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      s32_s[r][threadIdx.x] = sv[r];
      s8_s[r * kPad8 + threadIdx.x] = static_cast<uint8_t>(sv[r]);
      live |= sv[r] != 0;
      nonbinary |= (sv[r] & ~1) != 0;
      cnt[r] += sv[r] != 0;
    }
    live = __any_sync(0xffffffffu, live);
    nonbinary = __any_sync(0xffffffffu, nonbinary);
    if (lane == 0) flags_s[warp] = (live ? 1u : 0u) | (nonbinary ? 2u : 0u);
    cp_async_wait_all();
    __syncthreads();

    const uint32_t flags = flags_s[warp];
    const int k0 = warp * kKStep;              // this warp's K-step
    if ((flags & 1u) && k0 < nc) {
      if (kind == 4 || (flags & 2u)) {
        // exact int32 products on the CUDA cores, C-fragment ownership
        for (int k = k0; k < k0 + kKStep; ++k) {
          const uint32_t s0 = static_cast<uint32_t>(s32_s[2 * t][k]);
          const uint32_t s1 = static_cast<uint32_t>(s32_s[2 * t + 1][k]);
          uint32_t wg, wg8;
          if constexpr (kind == 4) {
            wg = static_cast<uint32_t>(w32_s[g * kPad32 + k]);
            wg8 = static_cast<uint32_t>(w32_s[(g + 8) * kPad32 + k]);
          } else if constexpr (kind == 2) {
            wg = static_cast<uint32_t>(w1_s[g * kPad8 + k] * 256 +
                                       w0_s[g * kPad8 + k]);
            wg8 = static_cast<uint32_t>(w1_s[(g + 8) * kPad8 + k] * 256 +
                                        w0_s[(g + 8) * kPad8 + k]);
          } else {
            wg = static_cast<uint32_t>(
                static_cast<int32_t>(static_cast<int8_t>(w0_s[g * kPad8 + k])));
            wg8 = static_cast<uint32_t>(static_cast<int32_t>(
                static_cast<int8_t>(w0_s[(g + 8) * kPad8 + k])));
          }
          exact[0] += wg * s0;
          exact[1] += wg * s1;
          exact[2] += wg8 * s0;
          exact[3] += wg8 * s1;
        }
      } else {
        uint32_t b[2], a[4];
        const uint8_t* sb = s8_s + g * kPad8 + k0 + 4 * t;
        b[0] = *reinterpret_cast<const uint32_t*>(sb);
        b[1] = *reinterpret_cast<const uint32_t*>(sb + 16);
        const int ka = g * kPad8 + k0 + 4 * t;
        const int ka8 = (g + 8) * kPad8 + k0 + 4 * t;
        a[0] = *reinterpret_cast<const uint32_t*>(w0_s + ka);
        a[1] = *reinterpret_cast<const uint32_t*>(w0_s + ka8);
        a[2] = *reinterpret_cast<const uint32_t*>(w0_s + ka + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(w0_s + ka8 + 16);
        if constexpr (kind == 2) {
          mma_u8u8(d_lo, a, b);              // lo bytes are unsigned
          a[0] = *reinterpret_cast<const uint32_t*>(w1_s + ka);
          a[1] = *reinterpret_cast<const uint32_t*>(w1_s + ka8);
          a[2] = *reinterpret_cast<const uint32_t*>(w1_s + ka + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(w1_s + ka8 + 16);
          mma_s8u8(d_hi, a, b);
        } else {
          mma_s8u8(d_lo, a, b);              // the int8 plane is signed
        }
      }
    }
    __syncthreads();                         // the buffers are restaged
  }

  // this warp's partial currents: c0/c1 post g, c2/c3 post g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = 256u * static_cast<uint32_t>(d_hi[i]) +
                       static_cast<uint32_t>(d_lo[i]) + exact[i];
    part_s[warp][2 * t + (i & 1)][g + 8 * (i >> 1)] = c;
  }
  if (count_packets) {
    uint32_t c[kN];                   // independent warp sums, then atomics
#pragma unroll
    for (int r = 0; r < kN; ++r) c[r] = __reduce_add_sync(0xffffffffu, cnt[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kN; ++r)
        if (c[r]) atomicAdd(&pkt_s[r], c[r]);   // integer: any order
    }
  }
  __syncthreads();
  // this CTA's current for output (eb, ep) and, in the first post tile,
  // its packets of batch row threadIdx.x
  const uint32_t mine = part_s[0][eb][ep] + part_s[1][eb][ep] +
                        part_s[2][eb][ep] + part_s[3][eb][ep];
  const bool pkt_lane = count_packets && threadIdx.x < kN;
  const uint32_t my_pkt = pkt_lane ? pkt_s[threadIdx.x] : 0u;
  if (rank != 0) {
    reduce.push(cluster, &slot_s[rank - 1][0], [&](uint32_t* dst) {
      dst[threadIdx.x] = mine;
      if (pkt_lane) dst[kThreads + threadIdx.x] = my_pkt;
    });
    return;
  }
  reduce.receive();
  uint32_t current = mine, n_pkt = my_pkt;    // integers: any order
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) {
    if (r < n_split) {
      current += slot_s[r - 1][threadIdx.x];
      if (pkt_lane) n_pkt += slot_s[r - 1][kThreads + threadIdx.x];
    }
  }
  if (e_ok) {
    const int32_t upd = static_cast<int32_t>(
        static_cast<uint32_t>(v_old) -
        static_cast<uint32_t>(v_old >> leak_shift) + current);
    const bool spike = upd >= v_threshold;
    v[e_i] = spike ? v_reset : upd;
    s_next[e_i] = spike ? 1 : 0;
  }
  if (pkt_lane && b0 + threadIdx.x < batch)
    pkt[b0 + threadIdx.x] = static_cast<int32_t>(n_pkt);
}

template <int kind>
cudaError_t launch(const void* ext, const void* s_prev, const void* plane0,
                   const void* plane1, void* v, void* s_next, void* pkt,
                   int batch, int n_ext, int n_int, int k_pad, int leak_shift,
                   int v_threshold, int v_reset, cudaStream_t stream) {
  const int n_split = cluster_split(k_pad / kKStep);
  const dim3 grid(((n_int + kM - 1) / kM) * n_split, (batch + kN - 1) / kN);
  return launch_cluster(
      fused_step_kernel<kind>, grid, kThreads, 0, n_split, stream,
      static_cast<const int32_t*>(ext), static_cast<const int32_t*>(s_prev),
      plane0, static_cast<const int8_t*>(plane1), static_cast<int32_t*>(v),
      static_cast<int32_t*>(s_next), static_cast<int32_t*>(pkt), batch, n_ext,
      n_int, k_pad, n_split, leak_shift < 31 ? leak_shift : 31, v_threshold,
      v_reset);
}

}  // namespace

// ext [batch, n_ext], s_prev/v/s_next [batch, n_int] and pkt [batch] are
// contiguous int32. The plane is packed (kernels/fused_step.py::pack_plane):
// kind 1: plane0 = W^T int8; kind 2: plane0 = lo (u8), plane1 = hi (s8);
// kind 4: plane0 = W^T int32; each [m_pad, k_pad] row-major, m_pad >=
// n_int a multiple of 16, k_pad >= n_ext + n_int a multiple of 32,
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int suprasnn_fused_step(const void* ext, const void* s_prev,
                                   const void* plane0, const void* plane1,
                                   int kind, void* v, void* s_next, void* pkt,
                                   int batch, int n_ext, int n_int, int k_pad,
                                   int leak_shift, int v_threshold,
                                   int v_reset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 1:
      return launch<1>(ext, s_prev, plane0, plane1, v, s_next, pkt, batch,
                       n_ext, n_int, k_pad, leak_shift, v_threshold, v_reset,
                       st);
    case 2:
      return launch<2>(ext, s_prev, plane0, plane1, v, s_next, pkt, batch,
                       n_ext, n_int, k_pad, leak_shift, v_threshold, v_reset,
                       st);
    case 4:
      return launch<4>(ext, s_prev, plane0, plane1, v, s_next, pkt, batch,
                       n_ext, n_int, k_pad, leak_shift, v_threshold, v_reset,
                       st);
    default:
      return cudaErrorInvalidValue;
  }
}
