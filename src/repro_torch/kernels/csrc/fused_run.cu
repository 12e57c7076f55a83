// A whole SupraSNN run, all T timesteps, in one kernel, for Hopper (sm_90a).
//
// Replaces the reference's compiled scan over its TPU kernel
// src/repro/kernels/fused_step.py::fused_step (body `_kernel`, launched by
// its pallas_call; the scan is src/repro/core/engine_jax.py's `_scan`).
// For every batch row b and step t, with s[-1] = 0 and v = 0 at the start:
//   s_all     = ext[t] ‖ s[t-1]
//   current   = s_all @ W                             (int32, wrapping)
//   pkt[t, b] = #{q : s_all[b, q] != 0}               (one MC packet each)
//   v' = v - (v >> leak_shift) + current; spike = v' >= v_threshold;
//   v  = spike ? v_reset : v';  spikes[t] = spike
// and v_final = v after step T - 1.
//
// What bounds it on the H100: the steps are a serial chain (step t reads
// the spikes of step t - 1), and a step's work is a few MOP over a plane
// of under a megabyte, far below what one launch costs. fused_step.cu
// pays a launch per step and reloads its plane slice each time; here the
// chain runs inside one launch and the plane is read from device memory
// once. What is left is one cluster barrier per step, which nothing can
// overlap, and a step's chain of shared-memory passes between two of them.
//
// Design (the K-step machinery of contract_sm90.cuh):
// * One cluster of up to 8 CTAs (run_split) owns a tile of 8 batch rows
//   for the whole run. Batch rows never depend on each other, so the
//   clusters never wait on one another.
// * The cluster splits the post axis, not K: rank r owns the 16-post
//   tiles [tile_begin(r), tile_begin(r + 1)) of the packed plane and loads
//   its rows of W^T (all of K) into shared memory once, with cp.async.
//   A rank's current is then whole, no partial sum crosses CTAs, and v
//   stays in shared memory for the run.
// * Every rank keeps the whole spike row s_all of its 8 batch rows, twice
//   (step parity): the external part as int32, staged per step from
//   ext[t] (prefetched with cp.async during step t - 1), the internal part
//   as bytes, written by the ranks that own those posts through
//   distributed shared memory at the end of step t - 1: the 4 threads of a
//   tile's row (4 posts each) push its 16 spikes as one 16-byte store to
//   each rank. One cluster barrier per step then makes the spikes visible
//   and releases the buffers read in step t; the step's outputs to device
//   memory are written between its arrive and its wait, so its release
//   does not wait for them.
// * Warp w of 16 takes K-steps w, w + 16, ... with fused_step.cu's rules.
//   Lane (g, t) loads its B operands, 8 spikes of batch row g, so the warp
//   holds the whole K-step and takes its flags and packet counts from the
//   same loads: a K-step whose spikes are all zero in the tile's rows
//   issues no product; a K-step of 0/1 spikes runs on the s8 tensor cores
//   (mma.m16n8k32, the spikes packed to bytes, the A fragment one
//   ldmatrix.x4, an int16 plane as 256 * (s @ hi) + s @ lo in uint32)
//   against up to 4 of the rank's tiles at once, each its own accumulator
//   chain; a K-step holding a spike outside {0, 1}, and every K-step of an
//   int32 plane, takes exact int32 products on the CUDA cores. The warps'
//   partial currents meet in shared memory; the Neuron Unit follows. Rank
//   0 sums the packets.
// kernels/fused_step.py::run_smem_bytes mirrors the layout below; the
// engine takes this kernel where the layout fits (suprasnn_fused_run_plan)
// and fused_step.cu, one launch a step, where it does not.

#include "contract_sm90.cuh"

#include <atomic>

namespace {

using namespace contract;

constexpr int kM = 16;                 // post neurons per tile (one m16)
constexpr int kN = 8;                  // batch rows per cluster (one n8)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;     // a CTA's shared memory on Hopper

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// How many CTAs split m_tiles post tiles, and where rank r's tiles begin.
// kernels/fused_step.py::run_split / run_tiles mirror these.
__host__ __device__ inline int run_split(int m_tiles) {
  return m_tiles < 1 ? 1 : (m_tiles < kMaxCluster ? m_tiles : kMaxCluster);
}
__host__ __device__ inline int tile_begin(int rank, int m_tiles,
                                          int n_split) {
  return rank * m_tiles / n_split;
}

// The dynamic shared memory of one CTA, byte offsets; every region starts
// on 16 bytes.
struct RunLayout {
  int tiles;     // post tiles of the largest rank
  int w_ld;      // plane row stride: bytes (kind 1, 2) or int32 (kind 4)
  int i_ld;      // internal spike row stride, bytes
  int e_ld;      // staged ext row stride, int32
  int w0, w1, si, e32, part, v, pkt, spk, total;
};

__host__ __device__ inline RunLayout run_layout(int kind, int n_ext,
                                                int k_pad, int m_pad) {
  RunLayout L;
  const int m_tiles = m_pad / kM;
  const int n_split = run_split(m_tiles);
  L.tiles = (m_tiles + n_split - 1) / n_split;
  // rows padded by 16 bytes: an odd multiple of 16, so ldmatrix's 8 rows
  // of 16 bytes, and the exact path's loads, fall in distinct banks
  L.w_ld = kind == 4 ? k_pad + 4 : k_pad + 16;
  // the internal columns of K (padding included) and every post a rank
  // pushes, 16-byte rows
  L.i_ld = round16(k_pad - n_ext > m_pad ? k_pad - n_ext : m_pad) + 16;
  L.e_ld = (n_ext + 3) & ~3;
  const int w_bytes = L.tiles * kM * L.w_ld * (kind == 4 ? 4 : 1);
  int off = 0;
  L.w0 = off;    off += round16(w_bytes);
  L.w1 = off;    off += kind == 2 ? round16(w_bytes) : 0;
  L.si = off;    off += round16(2 * kN * L.i_ld);
  L.e32 = off;   off += round16(2 * kN * L.e_ld * 4);
  L.part = off;  off += round16(kWarps * L.tiles * kN * kM * 4);
  L.v = off;     off += round16(kN * L.tiles * kM * 4);
  L.pkt = off;   off += round16(kWarps * kN * 4);
  L.spk = off;   off += round16(kN * L.tiles * kM);
  L.total = off;
  return L;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stage rows [0, rows) of ext[t] ([batch, n_ext] int32 at `src`, row b0)
// into dst (row stride e_ld) with cp.async, warp r taking row r: 16-byte
// copies where every row keeps them aligned, else 4-byte ones. One commit
// group.
__device__ __forceinline__ void stage_ext(int32_t* dst, int e_ld,
                                          const int32_t* src, int n_ext,
                                          int rows, bool vec) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += kWarps) {
    const int32_t* g = src + static_cast<size_t>(r) * n_ext;
    int32_t* d = dst + r * e_ld;
    if (vec) {
      for (int c = 4 * lane; c < n_ext; c += 128) cp_async<16>(d + c, g + c, 16);
    } else {
      for (int c = lane; c < n_ext; c += 32) cp_async<4>(d + c, g + c, 4);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A fragment of mma.m16n8k32 (8-bit) from a row-major 16 x 32-byte tile
// at `tile` (row stride ld bytes, rows 16-byte aligned): one ldmatrix.x4
// whose four 8 x 16-byte matrices are rows 0-7 / 8-15 at bytes 0 / 16.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const uint8_t* tile, int ld,
                                           int lane) {
  const uint8_t* row = tile + (lane % 16) * ld + (lane / 16) * 16;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(row)));
}

// Spike column k of batch row r this step: ext[t] staged as int32 for
// k < n_ext, else the internal spikes of step t - 1 as bytes.
__device__ __forceinline__ int32_t spike_at(const int32_t* e32c, int e_ld,
                                            const uint8_t* sic, int i_ld,
                                            int n_ext, int r, int k) {
  return k < n_ext ? e32c[r * e_ld + k]
                   : static_cast<int32_t>(sic[r * i_ld + (k - n_ext)]);
}

// Spike columns k .. k + 3 of row r (k a multiple of 4): one 16-byte load
// inside ext, one 32-bit load inside the internal bytes where aligned.
__device__ __forceinline__ int4 spikes4(const int32_t* e32c, int e_ld,
                                        const uint8_t* sic, int i_ld,
                                        int n_ext, int r, int k) {
  if (k + 3 < n_ext)
    return *reinterpret_cast<const int4*>(e32c + r * e_ld + k);
  if (k >= n_ext && ((k - n_ext) & 3) == 0) {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(sic + r * i_ld + (k - n_ext));
    return make_int4(w & 255u, (w >> 8) & 255u, (w >> 16) & 255u, w >> 24);
  }
  return make_int4(spike_at(e32c, e_ld, sic, i_ld, n_ext, r, k),
                   spike_at(e32c, e_ld, sic, i_ld, n_ext, r, k + 1),
                   spike_at(e32c, e_ld, sic, i_ld, n_ext, r, k + 2),
                   spike_at(e32c, e_ld, sic, i_ld, n_ext, r, k + 3));
}

__device__ __forceinline__ uint32_t pack_bytes(int4 s) {
  return (static_cast<uint32_t>(s.x) & 255u) |
         (static_cast<uint32_t>(s.y) & 255u) << 8 |
         (static_cast<uint32_t>(s.z) & 255u) << 16 |
         static_cast<uint32_t>(s.w) << 24;
}

__device__ __forceinline__ uint32_t count_nonzero(int4 s) {
  return (s.x != 0) + (s.y != 0) + (s.z != 0) + (s.w != 0);
}

// kind: the plane's element size, 1 (int8), 2 (int16 as lo/hi) or 4
template <int kind>
__global__ void __launch_bounds__(kThreads)
fused_run_kernel(const int32_t* __restrict__ ext,
                 const void* __restrict__ plane0,
                 const int8_t* __restrict__ plane1, int32_t* __restrict__ v_out,
                 int32_t* __restrict__ spikes, int32_t* __restrict__ pkt,
                 int batch, int t_steps, int n_ext, int n_int, int k_pad,
                 int m_pad, int ext_vec, int leak_shift, int v_threshold,
                 int v_reset) {
  extern __shared__ __align__(16) uint8_t smem[];
  const RunLayout L = run_layout(kind, n_ext, k_pad, m_pad);
  uint8_t* w0 = smem + L.w0;
  int8_t* w1 = reinterpret_cast<int8_t*>(smem + L.w1);
  const int32_t* w32 = reinterpret_cast<const int32_t*>(smem + L.w0);
  uint8_t* si = smem + L.si;
  int32_t* e32 = reinterpret_cast<int32_t*>(smem + L.e32);
  uint32_t* part = reinterpret_cast<uint32_t*>(smem + L.part);
  int32_t* v_s = reinterpret_cast<int32_t*>(smem + L.v);
  uint32_t* pkt_s = reinterpret_cast<uint32_t*>(smem + L.pkt);
  uint32_t* spk_s = reinterpret_cast<uint32_t*>(smem + L.spk);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m_tiles = m_pad / kM;
  const int n_split = run_split(m_tiles);
  const int tile0 = tile_begin(rank, m_tiles, n_split);
  const int n_tiles = tile_begin(rank + 1, m_tiles, n_split) - tile0;
  const int p0 = tile0 * kM;                  // this rank's first post
  const int n_posts = n_tiles * kM;
  const int v_ld = L.tiles * kM;
  const int n_ks = k_pad / kKStep;
  const int b0 = (blockIdx.x / n_split) * kN;
  const int rows = min(kN, batch - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;

  // zero the spike rows (padding and s[-1]), the staged ext (rows past
  // the batch stay zero) and v; then the one-time loads
  for (int i = threadIdx.x; i < 2 * kN * L.i_ld; i += kThreads) si[i] = 0;
  for (int i = threadIdx.x; i < 2 * kN * L.e_ld; i += kThreads) e32[i] = 0;
  for (int i = threadIdx.x; i < kN * v_ld; i += kThreads) v_s[i] = 0;
  __syncthreads();
  {
    // this rank's rows of W^T, all of K; rows are 16-byte multiples
    const int e = kind == 4 ? 4 : 1;
    const int row_bytes = k_pad * e, w_row = L.w_ld * e;
    const int chunks = row_bytes / 16;
    const uint8_t* g0 = static_cast<const uint8_t*>(plane0) +
                        static_cast<size_t>(p0) * row_bytes;
    const uint8_t* g1 = reinterpret_cast<const uint8_t*>(plane1) +
                        static_cast<size_t>(p0) * row_bytes;
    for (int i = threadIdx.x; i < n_posts * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 16;
      cp_async<16>(w0 + r * w_row + c, g0 + static_cast<size_t>(r) * row_bytes
                   + c, 16);
      if constexpr (kind == 2)
        cp_async<16>(w1 + r * w_row + c,
                     g1 + static_cast<size_t>(r) * row_bytes + c, 16);
    }
  }
  stage_ext(e32, L.e_ld, ext + static_cast<size_t>(b0) * n_ext, n_ext, rows,
            ext_vec);
  cp_async_wait_all();
  // every rank has zeroed the buffers the others push into, and runs
  cluster_barrier();

  for (int t = 0; t < t_steps; ++t) {
    const int cur = t & 1;
    const uint8_t* sic = si + cur * kN * L.i_ld;
    const int32_t* e32c = e32 + cur * kN * L.e_ld;
    if (t + 1 < t_steps)                      // prefetch ext[t + 1]
      stage_ext(e32 + (cur ^ 1) * kN * L.e_ld, L.e_ld,
                ext + (static_cast<size_t>(t + 1) * batch + b0) * n_ext,
                n_ext, rows, ext_vec);

    // (1) the warp's K-steps against up to 4 of this rank's tiles at a
    // time, independent accumulators per tile. Lane (g, t4) loads its B
    // operands, columns 4 t4 .. + 3 and 16 + 4 t4 .. + 3 of batch row g:
    // the warp holds the whole K-step, so its flags (live, non-binary)
    // and packets come from the same loads
    uint32_t cnt = 0u;                        // packets of row g, mine
    for (int j0 = 0; j0 < n_tiles; j0 += 4) {
      int d_lo[4][4], d_hi[4][4];
      uint32_t exact[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d_lo[jj][i] = d_hi[jj][i] = 0;
          exact[jj][i] = 0u;
        }
      for (int ks = warp; ks < n_ks; ks += kWarps) {
        const int k0 = ks * kKStep;
        const int4 sa = spikes4(e32c, L.e_ld, sic, L.i_ld, n_ext, g,
                                k0 + 4 * t4);
        const int4 sb = spikes4(e32c, L.e_ld, sic, L.i_ld, n_ext, g,
                                k0 + 16 + 4 * t4);
        const int32_t any = sa.x | sa.y | sa.z | sa.w | sb.x | sb.y | sb.z |
                            sb.w;
        if (j0 == 0) cnt += count_nonzero(sa) + count_nonzero(sb);
        if (!__any_sync(0xffffffffu, any != 0)) continue;  // MC-tree skip
        if (kind == 4 || __any_sync(0xffffffffu, (any & ~1) != 0)) {
          for (int k = k0; k < k0 + kKStep; ++k) {
            const uint32_t s0 = static_cast<uint32_t>(
                spike_at(e32c, L.e_ld, sic, L.i_ld, n_ext, 2 * t4, k));
            const uint32_t s1 = static_cast<uint32_t>(
                spike_at(e32c, L.e_ld, sic, L.i_ld, n_ext, 2 * t4 + 1, k));
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (j0 + jj >= n_tiles) break;
              const int ra = ((j0 + jj) * kM + g) * L.w_ld + k;
              const int ra8 = ra + 8 * L.w_ld;
              uint32_t wg, wg8;
              if constexpr (kind == 4) {
                wg = static_cast<uint32_t>(w32[ra]);
                wg8 = static_cast<uint32_t>(w32[ra8]);
              } else if constexpr (kind == 2) {
                wg = static_cast<uint32_t>(w1[ra] * 256 + w0[ra]);
                wg8 = static_cast<uint32_t>(w1[ra8] * 256 + w0[ra8]);
              } else {
                wg = static_cast<uint32_t>(
                    static_cast<int32_t>(static_cast<int8_t>(w0[ra])));
                wg8 = static_cast<uint32_t>(
                    static_cast<int32_t>(static_cast<int8_t>(w0[ra8])));
              }
              exact[jj][0] += wg * s0;
              exact[jj][1] += wg * s1;
              exact[jj][2] += wg8 * s0;
              exact[jj][3] += wg8 * s1;
            }
          }
        } else {
          const uint32_t b[2] = {pack_bytes(sa), pack_bytes(sb)};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (j0 + jj >= n_tiles) break;
            const int ta = (j0 + jj) * kM * L.w_ld + k0;
            uint32_t a[4];
            if constexpr (kind != 4) {
              ldmatrix_a(a, w0 + ta, L.w_ld, lane);
              if constexpr (kind == 2) {
                mma_u8u8(d_lo[jj], a, b);     // lo bytes are unsigned
                ldmatrix_a(a, reinterpret_cast<const uint8_t*>(w1) + ta,
                           L.w_ld, lane);
                mma_s8u8(d_hi[jj], a, b);
              } else {
                mma_s8u8(d_lo[jj], a, b);     // the int8 plane is signed
              }
            }
          }
        }
      }
      // c0/c1: post g, batch rows 2t, 2t + 1; c2/c3: post g + 8
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + jj >= n_tiles) break;
        uint32_t* pw = part + ((warp * L.tiles + j0 + jj) * kN) * kM;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(2 * t4 + (i & 1)) * kM + g + 8 * (i >> 1)] =
              256u * static_cast<uint32_t>(d_hi[jj][i]) +
              static_cast<uint32_t>(d_lo[jj][i]) + exact[jj][i];
      }
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
    if (t4 == 0) pkt_s[warp * kN + g] = cnt;
    __syncthreads();

    // (2) the Neuron Unit on this rank's posts, a thread 4 neighbouring
    // posts of a row; the 4 threads of a tile's row then push its 16
    // spikes as one 16-byte store into every rank's internal row of step
    // t + 1
    uint8_t* sin = si + (cur ^ 1) * kN * L.i_ld;
    const bool push = t + 1 < t_steps;
    const int quads = n_posts / 4, n_q = kN * quads;
    for (int base = warp * 32; base < n_q; base += kThreads) {
      const int o = base + lane;
      const int r = o / quads, pl = (o - r * quads) * 4;
      uint32_t word = 0u;
      if (o < n_q) {
        const int j = pl / kM, pp = pl - j * kM;
        uint4 c = make_uint4(0u, 0u, 0u, 0u);  // integers: any order
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              part + ((w * L.tiles + j) * kN + r) * kM + pp);
          c.x += x.x; c.y += x.y; c.z += x.z; c.w += x.w;
        }
        int4 v = *reinterpret_cast<const int4*>(v_s + r * v_ld + pl);
        const uint32_t cur4[4] = {c.x, c.y, c.z, c.w};
        int32_t* vp = &v.x;
        const int p = p0 + pl;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int32_t upd = static_cast<int32_t>(
              static_cast<uint32_t>(vp[i]) -
              static_cast<uint32_t>(vp[i] >> leak_shift) + cur4[i]);
          const bool spike = upd >= v_threshold;
          vp[i] = spike ? v_reset : upd;
          // a row past the batch, and a post past n_int, push 0: a spike
          // there would wake the skip flags of the real rows' K-steps
          if (p + i < n_int && spike && r < rows) word |= 1u << (8 * i);
        }
        *reinterpret_cast<int4*>(v_s + r * v_ld + pl) = v;
        spk_s[o] = word;                      // stored after the arrive
      }
      const uint32_t w_1 = __shfl_down_sync(0xffffffffu, word, 1);
      const uint32_t w_2 = __shfl_down_sync(0xffffffffu, word, 2);
      const uint32_t w_3 = __shfl_down_sync(0xffffffffu, word, 3);
      if (push && o < n_q && (o & 3) == 0) {
        const uint4 val = make_uint4(word, w_1, w_2, w_3);
        uint8_t* dst = sin + r * L.i_ld + p0 + pl;   // 16-byte aligned
        for (int rk = 0; rk < n_split; ++rk)
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, rk)) = val;
      }
    }
    uint32_t n_pkt = 0u;
    if (rank == 0 && static_cast<int>(threadIdx.x) < rows) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) n_pkt += pkt_s[w * kN + threadIdx.x];
    }
    cp_async_wait_all();                      // ext[t + 1] has landed
    // the barrier's release covers the spikes pushed and this CTA's
    // shared memory; the outputs to device memory follow it, so the
    // barrier does not wait for their writes
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    for (int o = threadIdx.x; o < kN * quads; o += kThreads) {
      const int r = o / quads, p = p0 + (o - r * quads) * 4;
      if (r >= rows) continue;
      const uint32_t word = spk_s[o];
      int32_t* out = spikes + (static_cast<size_t>(t) * batch + b0 + r) *
                                  n_int + p;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < n_int) out[i] = (word >> (8 * i)) & 1u;
    }
    if (rank == 0 && static_cast<int>(threadIdx.x) < rows)
      pkt[static_cast<size_t>(t) * batch + b0 + threadIdx.x] =
          static_cast<int32_t>(n_pkt);
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }

  for (int o = threadIdx.x; o < kN * n_posts; o += kThreads) {
    const int r = o / n_posts, pl = o - r * n_posts;
    if (r < rows && p0 + pl < n_int)
      v_out[static_cast<size_t>(b0 + r) * n_int + p0 + pl] = v_s[r * v_ld + pl];
  }
}

// The dynamic shared memory limit of fused_run_kernel<kind>, raised once
// per device.
template <int kind>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_run_kernel<kind>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int kind>
cudaError_t plan(int n_ext, int k_pad, int m_pad, int* out) {
  const RunLayout L = run_layout(kind, n_ext, k_pad, m_pad);
  const int n_split = run_split(m_pad / kM);
  out[0] = L.total;
  out[1] = n_split;
  out[2] = 0;
  if (L.total > kSmemLimit) return cudaSuccess;
  cudaError_t err = allow_smem<kind>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&out[2], fused_run_kernel<kind>, &cfg);
}

template <int kind>
cudaError_t launch(const void* ext, const void* plane0, const void* plane1,
                   void* v, void* spikes, void* pkt, int batch, int t_steps,
                   int n_ext, int n_int, int k_pad, int m_pad, int leak_shift,
                   int v_threshold, int v_reset, cudaStream_t stream) {
  const RunLayout L = run_layout(kind, n_ext, k_pad, m_pad);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<kind>();
  if (err != cudaSuccess) return err;
  const int n_split = run_split(m_pad / kM);
  const int ext_vec = n_ext % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(ext) & 15u) == 0;
  const dim3 grid(n_split * ((batch + kN - 1) / kN));
  return launch_cluster(
      fused_run_kernel<kind>, grid, kThreads, L.total, n_split, stream,
      static_cast<const int32_t*>(ext), plane0,
      static_cast<const int8_t*>(plane1), static_cast<int32_t*>(v),
      static_cast<int32_t*>(spikes), static_cast<int32_t*>(pkt), batch,
      t_steps, n_ext, n_int, k_pad, m_pad, ext_vec,
      leak_shift < 31 ? leak_shift : 31, v_threshold, v_reset);
}

// T cluster barriers and nothing else, in one cluster of n_split CTAs of
// kThreads: the serial floor of the run kernel's step chain.
__global__ void __launch_bounds__(kThreads)
cluster_barriers_kernel(int t_steps) {
  for (int t = 0; t < t_steps; ++t) cluster_barrier();
}

}  // namespace

// The run kernel's plan for a packed plane: out[0] = the dynamic shared
// memory of a CTA in bytes, out[1] = the CTAs of a cluster, out[2] = how
// many such clusters the card holds at once (0: the plane does not fit,
// and the caller steps with suprasnn_fused_step). Returns a cudaError_t.
extern "C" int suprasnn_fused_run_plan(int kind, int n_ext, int k_pad,
                                       int m_pad, int* out) {
  switch (kind) {
    case 1: return plan<1>(n_ext, k_pad, m_pad, out);
    case 2: return plan<2>(n_ext, k_pad, m_pad, out);
    case 4: return plan<4>(n_ext, k_pad, m_pad, out);
    default: return cudaErrorInvalidValue;
  }
}

// ext [t_steps, batch, n_ext], spikes [t_steps, batch, n_int], pkt
// [t_steps, batch] and v [batch, n_int] (v_final, written) are contiguous
// int32; the plane is packed as for suprasnn_fused_step. The state starts
// at zero. Returns the launch's cudaError_t.
extern "C" int suprasnn_fused_run(const void* ext, const void* plane0,
                                  const void* plane1, int kind, void* v,
                                  void* spikes, void* pkt, int batch,
                                  int t_steps, int n_ext, int n_int,
                                  int k_pad, int m_pad, int leak_shift,
                                  int v_threshold, int v_reset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 1:
      return launch<1>(ext, plane0, plane1, v, spikes, pkt, batch, t_steps,
                       n_ext, n_int, k_pad, m_pad, leak_shift, v_threshold,
                       v_reset, st);
    case 2:
      return launch<2>(ext, plane0, plane1, v, spikes, pkt, batch, t_steps,
                       n_ext, n_int, k_pad, m_pad, leak_shift, v_threshold,
                       v_reset, st);
    case 4:
      return launch<4>(ext, plane0, plane1, v, spikes, pkt, batch, t_steps,
                       n_ext, n_int, k_pad, m_pad, leak_shift, v_threshold,
                       v_reset, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// One cluster of n_split CTAs passing t_steps cluster barriers: a
// measurement of the step chain's floor, not part of any path.
extern "C" int suprasnn_cluster_barriers(int n_split, int t_steps,
                                         void* stream) {
  return launch_cluster(cluster_barriers_kernel, dim3(n_split), kThreads, 0,
                        n_split, static_cast<cudaStream_t>(stream), t_steps);
}
