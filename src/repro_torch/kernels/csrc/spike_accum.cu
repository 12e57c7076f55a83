// Synaptic accumulation I = S @ W with the spike-tile skip, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spike_accum.py::spike_accum
// (body `_kernel`, launched by its pallas_call):
//   out[b, p] = sum_q S[b, q] * W[q, p]
// over S [B, N_pre] and W [N_pre, N_post] of one type: float32 and bf16
// sum in float32, int32 sums in int32 and wraps (done in uint32, whose
// overflow C++ defines, as fused_step.cu does). A pre tile whose spikes
// are all zero is skipped, so its weight tile is never read: the MC-tree
// skip of the TPU kernel (spike_accum.py:41-48).
//
// What bounds it on the H100: at the SHD training shapes (B = 32, 700 x
// 300, 300 x 300 and 300 x 20 float32 planes) a call reads at most one
// plane of under a megabyte, 32 spike rows and writes 32 output rows: well
// under a microsecond of HBM time at 3.35 TB/s, and its 2 * nnz * N_post
// flops are a few MFLOP. Both are far below what a launch costs, so the
// kernel is launch- and latency-bound at these shapes.
//
// What the design does about that: no padding and no scratch in device
// memory; enough blocks that no one block walks a whole plane alone. A
// block owns 32 post columns (one per lane) x 8 batch rows. It walks the
// pre axis in tiles of 256 in ascending order, which takes the place of
// the TPU's sequential k grid axis: each tile's spikes are staged in
// shared memory, __syncthreads_or says whether any is non-zero, and a
// dead tile is skipped whole. In a live tile the 8 warps split the pre
// neurons; a pre neuron with no spike in the block's rows is skipped
// (a warp-uniform branch), and otherwise its W row segment is read
// coalesced, 32 neighbouring columns per warp, into 8 register sums. The
// warps' partial sums meet in shared memory and are added in warp order.
// So every output element is summed in one fixed order with no atomics,
// and a float result is the same from run to run: the deterministic
// commit of spike_accum.py:13-14. Lanes past the ragged edges read zeros
// and write nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;              // post columns per block, one per lane
constexpr int kRows = 8;               // batch rows per block
constexpr int kWarps = 8;              // warps splitting a pre tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads;        // pre neurons per tile
static_assert(kRows * kCols == kThreads, "epilogue: one thread per output");

// per input type: the sum's type (float32 for float32 and bf16; uint32
// for int32, so that it wraps) and the output's
template <typename T> struct Types;
template <> struct Types<float> { using acc = float; using out = float; };
template <> struct Types<__nv_bfloat16> {
  using acc = float;
  using out = float;
};
template <> struct Types<int32_t> {
  using acc = uint32_t;
  using out = int32_t;
};
template <typename T> using acc_t = typename Types<T>::acc;
template <typename T> using out_t = typename Types<T>::out;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ uint32_t to_acc(int32_t x) {
  return static_cast<uint32_t>(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spike_accum_kernel(const T* __restrict__ s, const T* __restrict__ w,
                   out_t<T>* __restrict__ out, int batch, int n_pre,
                   int n_post) {
  using A = acc_t<T>;
  __shared__ A s_tile[kRows][kTile];
  __shared__ A partial[kWarps][kRows][kCols];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;

  A acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = A(0);

  for (int base = 0; base < n_pre; base += kTile) {
    // stage S[row0:row0+kRows, base:base+kTile]; thread t loads column t
    const int q = base + threadIdx.x;
    int live = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      A x = A(0);
      if (row < batch && q < n_pre)
        x = to_acc(s[static_cast<size_t>(row) * n_pre + q]);
      s_tile[r][threadIdx.x] = x;
      live |= x != A(0);
    }
    // the MC-tree skip: a tile with no spike never reads its W tile
    if (!__syncthreads_or(live)) continue;

    const int len = min(kTile, n_pre - base);
    for (int k = warp; k < len; k += kWarps) {
      A sk[kRows];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sk[r] = s_tile[r][k];
        any |= sk[r] != A(0);
      }
      if (any && col < n_post) {
        const A wk = to_acc(w[static_cast<size_t>(base + k) * n_post + col]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += sk[r] * wk;
      }
    }
    __syncthreads();                   // s_tile is restaged next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) partial[warp][r][lane] = acc[r];
  __syncthreads();

  // thread t owns output (row0 + t / 32, column t % 32 of the block)
  const int r = threadIdx.x / kCols;
  const int c = threadIdx.x % kCols;
  const int row = row0 + r;
  const int p = blockIdx.x * kCols + c;
  if (row < batch && p < n_post) {
    A sum = A(0);
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += partial[wi][r][c];
    out[static_cast<size_t>(row) * n_post + p] = static_cast<out_t<T>>(sum);
  }
}

template <typename T>
cudaError_t launch(const void* s, const void* w, void* out, int batch,
                   int n_pre, int n_post, cudaStream_t stream) {
  const dim3 grid((n_post + kCols - 1) / kCols, (batch + kRows - 1) / kRows);
  spike_accum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(w),
      static_cast<out_t<T>*>(out), batch, n_pre, n_post);
  return cudaGetLastError();
}

}  // namespace

// s [batch, n_pre] and w [n_pre, n_post] are contiguous arrays of one
// type: dtype 0 float32, 1 bf16, 2 int32. out [batch, n_post] is float32
// for dtypes 0 and 1, int32 for 2. batch and n_post are positive; batch
// is below 65535 * 8 (the grid's y limit). Returns the launch's
// cudaError_t.
extern "C" int suprasnn_spike_accum(const void* s, const void* w, void* out,
                                    int dtype, int batch, int n_pre,
                                    int n_post, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(s, w, out, batch, n_pre, n_post, st);
    case 1:
      return launch<__nv_bfloat16>(s, w, out, batch, n_pre, n_post, st);
    case 2:
      return launch<int32_t>(s, w, out, batch, n_pre, n_post, st);
    default:
      return cudaErrorInvalidValue;
  }
}
