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
// int16 plane) one step reads W once, 653 KB (L2-resident after the first
// step: the L2 holds 50 MB), B x 1020 x 4 B of spikes, and reads and
// writes v at B x 320 x 4 B: well under a microsecond of HBM traffic at
// 3.35 TB/s. Its 2 x B x 1020 x 320 integer operations are a few MOP. At
// the serving batches (B <= 17) both are far below what a launch costs,
// so the step is launch- and latency-bound.
//
// What the design does about that: the whole timestep is one launch with
// no scratch traffic (currents never leave the block), and the work is
// spread over enough blocks that no one block walks the whole pre axis
// alone. A block owns 32 post columns (one per lane) x 8 batch rows; its
// 8 warps split the pre axis, which takes the place of the TPU's
// sequential k grid axis, and sum their partial currents in shared memory
// before the LIF epilogue runs in registers. Spikes are staged through
// shared memory 256 pre neurons at a time. A pre neuron that fired in none
// of the block's rows is skipped (a warp-uniform branch), so its W row is
// never read. No atomics touch the currents; integer addition makes every
// order give the same bits. Packets are counted by the blocks of the first
// column block only, once per batch row. Lanes past the ragged edges read
// zeros and write nothing. Spikes go to s_next, a buffer apart from s_prev:
// in a recurrent graph other blocks of this launch still read s_prev.
//
// Later work (tensor cores on s8 with int16 split as 256*hi + lo, TMA,
// CUDA graphs over the T loop) is in ROADMAP Queue B.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;              // post columns per block, one per lane
constexpr int kRows = 8;               // batch rows per block
constexpr int kWarps = 8;              // warps splitting the pre axis
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;       // pre neurons staged per pass
static_assert(kRows * kCols == kThreads, "epilogue: one thread per output");

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const int32_t* __restrict__ ext,
                  const int32_t* __restrict__ s_prev,
                  const WT* __restrict__ w, int32_t* __restrict__ v,
                  int32_t* __restrict__ s_next, int32_t* __restrict__ pkt,
                  int batch, int n_ext, int n_int, int leak_shift,
                  int v_threshold, int v_reset) {
  __shared__ int32_t s_tile[kRows][kChunk];
  __shared__ uint32_t partial[kWarps][kRows][kCols];
  __shared__ uint32_t packets[kRows];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const int n_all = n_ext + n_int;
  const bool count_packets = blockIdx.x == 0;

  if (threadIdx.x < kRows) packets[threadIdx.x] = 0u;

  uint32_t acc[kRows];
  uint32_t cnt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = cnt[r] = 0u;

  for (int base = 0; base < n_all; base += kChunk) {
    // stage s_all[row0:row0+kRows, base:base+kChunk]; thread t loads column t
    const int q = base + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      int32_t s = 0;
      if (row < batch && q < n_all) {
        s = q < n_ext ? ext[static_cast<size_t>(row) * n_ext + q]
                      : s_prev[static_cast<size_t>(row) * n_int + (q - n_ext)];
      }
      s_tile[r][threadIdx.x] = s;
      cnt[r] += s != 0;
    }
    __syncthreads();

    const int len = min(kChunk, n_all - base);
    for (int k = warp; k < len; k += kWarps) {
      int32_t s[kRows];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = s_tile[r][k];
        any |= s[r] != 0;
      }
      if (any && col < n_int) {
        const uint32_t wq = static_cast<uint32_t>(static_cast<int32_t>(
            w[static_cast<size_t>(base + k) * n_int + col]));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] += static_cast<uint32_t>(s[r]) * wq;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) partial[warp][r][lane] = acc[r];
  if (count_packets) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      uint32_t c = cnt[r];
      for (int off = 16; off > 0; off /= 2)
        c += __shfl_down_sync(0xffffffffu, c, off);
      if (lane == 0 && c) atomicAdd(&packets[r], c);
    }
  }
  __syncthreads();

  // Neuron Unit epilogue: thread t owns output (row0 + t / 32, col t % 32)
  const int r = threadIdx.x / kCols;
  const int c = threadIdx.x % kCols;
  const int row = row0 + r;
  const int p = blockIdx.x * kCols + c;
  if (row < batch && p < n_int) {
    uint32_t current = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) current += partial[wi][r][c];
    const size_t i = static_cast<size_t>(row) * n_int + p;
    const int32_t vi = v[i];
    const int32_t upd = static_cast<int32_t>(
        static_cast<uint32_t>(vi) - static_cast<uint32_t>(vi >> leak_shift)
        + current);
    const bool spike = upd >= v_threshold;
    v[i] = spike ? v_reset : upd;
    s_next[i] = spike ? 1 : 0;
  }
  if (count_packets && threadIdx.x < kRows && row0 + threadIdx.x < batch)
    pkt[row0 + threadIdx.x] = static_cast<int32_t>(packets[threadIdx.x]);
}

template <typename WT>
cudaError_t launch(const void* ext, const void* s_prev, const void* w,
                   void* v, void* s_next, void* pkt, int batch, int n_ext,
                   int n_int, int leak_shift, int v_threshold, int v_reset,
                   cudaStream_t stream) {
  const dim3 grid((n_int + kCols - 1) / kCols, (batch + kRows - 1) / kRows);
  fused_step_kernel<WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(ext), static_cast<const int32_t*>(s_prev),
      static_cast<const WT*>(w), static_cast<int32_t*>(v),
      static_cast<int32_t*>(s_next), static_cast<int32_t*>(pkt), batch,
      n_ext, n_int, leak_shift < 31 ? leak_shift : 31, v_threshold, v_reset);
  return cudaGetLastError();
}

}  // namespace

// ext [batch, n_ext], s_prev/v/s_next [batch, n_int] and pkt [batch] are
// contiguous int32; w is a contiguous [n_ext + n_int, n_int] plane of
// w_itemsize-byte signed integers. Returns the launch's cudaError_t.
extern "C" int suprasnn_fused_step(const void* ext, const void* s_prev,
                                   const void* w, int w_itemsize, void* v,
                                   void* s_next, void* pkt, int batch,
                                   int n_ext, int n_int, int leak_shift,
                                   int v_threshold, int v_reset,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_itemsize) {
    case 1:
      return launch<int8_t>(ext, s_prev, w, v, s_next, pkt, batch, n_ext,
                            n_int, leak_shift, v_threshold, v_reset, st);
    case 2:
      return launch<int16_t>(ext, s_prev, w, v, s_next, pkt, batch, n_ext,
                             n_int, leak_shift, v_threshold, v_reset, st);
    case 4:
      return launch<int32_t>(ext, s_prev, w, v, s_next, pkt, batch, n_ext,
                             n_int, leak_shift, v_threshold, v_reset, st);
    default:
      return cudaErrorInvalidValue;
  }
}
