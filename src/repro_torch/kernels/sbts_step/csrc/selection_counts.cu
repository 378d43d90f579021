// selection_counts: out[k, v] = sum_w popcount(rows[v, w] & sel[k, w]),
// i.e. |N(v) ∩ S_k| for every trajectory k and vertex v, over packed
// 32-bit words (bit j of word j/32 is vertex j, little-endian).
//
// Replaces repro/kernels/sbts_step/kernel.py::selection_counts_pallas
// (body _counts_kernel).  The device SBTS engine calls it three times
// per lock-step iteration: on the selection, the addable set and the
// Luby sample (repro_torch/core/mis_device.py, lockstep).
//
// Bound: integer issue, not bytes.  The work is K * n_pad * W
// AND + POPC + ADD; at the 16x16-fabric shape (K = 1024, n_pad = 8448,
// W = 264) that is ~2.3e9 popcounts per call, while rows (8.9 MB) and
// sel (1.1 MB) fit in the 50 MB L2 and the output is 35 MB.
//
// Design (simple and right first; no wgmma, TMA or tuning yet):
// - a block owns a tile of TK trajectories x TN vertices and walks the
//   word axis in chunks of CW words, staging the tile's rows and sel
//   words through shared memory (stored word-major and padded by one,
//   so both the global->shared copy and the reads are free of bank
//   conflicts);
// - each of the 16 x 16 threads keeps RK x RN = 2 x 4 sums in
//   registers, adding __popc(row & sel) per word;
// - every output is written once, with no atomics; ragged K and n_pad
//   edges and a W that is not a multiple of CW are masked (a masked
//   word is staged as 0 and adds nothing).
// The launcher runs on the caller's stream and returns cudaGetLastError
// so that a refused launch is reported to the wrapper.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsN = 16;             // threads along vertices
constexpr int kThreadsK = 16;             // threads along trajectories
constexpr int kRN = 4;                    // vertices per thread
constexpr int kRK = 2;                    // trajectories per thread
constexpr int kTN = kThreadsN * kRN;      // 64 vertices per block
constexpr int kTK = kThreadsK * kRK;      // 32 trajectories per block
constexpr int kCW = 32;                   // words staged per chunk
constexpr int kThreads = kThreadsN * kThreadsK;

__global__ void __launch_bounds__(kThreads)
selection_counts_kernel(const uint32_t* __restrict__ rows,
                        const uint32_t* __restrict__ sel,
                        int32_t* __restrict__ out,
                        int n_pad, int k, int w) {
  __shared__ uint32_t rows_s[kCW][kTN + 1];
  __shared__ uint32_t sel_s[kCW][kTK + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int v0 = blockIdx.x * kTN;
  const int k0 = blockIdx.y * kTK;

  int acc[kRK][kRN];
#pragma unroll
  for (int i = 0; i < kRK; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < w; c0 += kCW) {
    // A warp copies kCW consecutive words of one row: coalesced reads.
    for (int e = tid; e < kTN * kCW; e += kThreads) {
      const int r = e / kCW, c = e % kCW;
      const int v = v0 + r, word = c0 + c;
      rows_s[c][r] = (v < n_pad && word < w)
                         ? rows[static_cast<size_t>(v) * w + word]
                         : 0u;
    }
    for (int e = tid; e < kTK * kCW; e += kThreads) {
      const int r = e / kCW, c = e % kCW;
      const int kk = k0 + r, word = c0 + c;
      sel_s[c][r] = (kk < k && word < w)
                        ? sel[static_cast<size_t>(kk) * w + word]
                        : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kCW; ++c) {
      uint32_t a[kRN], b[kRK];
#pragma unroll
      for (int j = 0; j < kRN; ++j) a[j] = rows_s[c][tx + kThreadsN * j];
#pragma unroll
      for (int i = 0; i < kRK; ++i) b[i] = sel_s[c][ty + kThreadsK * i];
#pragma unroll
      for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += __popc(a[j] & b[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRK; ++i) {
    const int kk = k0 + ty + kThreadsK * i;
    if (kk >= k) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int v = v0 + tx + kThreadsN * j;
      if (v < n_pad) out[static_cast<size_t>(kk) * n_pad + v] = acc[i][j];
    }
  }
}

}  // namespace

// rows: uint32 [n_pad, w], sel: uint32 [k, w], out: int32 [k, n_pad],
// all contiguous on the device; stream: the caller's cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int selection_counts_launch(const void* rows, const void* sel,
                                       void* out, int n_pad, int k, int w,
                                       void* stream) {
  if (n_pad <= 0 || k <= 0) return 0;
  const dim3 grid((n_pad + kTN - 1) / kTN, (k + kTK - 1) / kTK);
  const dim3 block(kThreadsN, kThreadsK);
  selection_counts_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(sel),
      static_cast<int32_t*>(out), n_pad, k, w);
  return static_cast<int>(cudaGetLastError());
}
