// selection_counts: out[k, v] = sum_w popcount(rows[v, w] & sel[k, w]),
// i.e. |N(v) ∩ S_k| for every trajectory k and vertex v, over packed
// 32-bit words (bit j of word j/32 is vertex j, little-endian).
//
// Replaces repro/kernels/sbts_step/kernel.py::selection_counts_pallas
// (body _counts_kernel).  The device SBTS engine calls it three times
// per lock-step iteration: on the selection, the addable set and the
// Luby sample (repro_torch/core/mis_device.py, lockstep).
//
// The function is a binary matrix product, out = S A^T over {0, 1}
// with a depth of 32 W bits, and Hopper's tensor cores compute it as it
// stands: wgmma's .b1 form (m64nNk256, .and.popc) sums popcount(a & b)
// over 256 bits per row pair.  The sum over the depth does not depend
// on the order of the bits within it so long as both operands share it,
// so the packed words go into the operands unshuffled: sel is A (K x
// depth, K-major) and rows is B (n_pad x depth, K-major; the adjacency
// is symmetric, so its rows are its columns).
//
// Why .b1 wgmma.  Measured on an H100 80GB HBM3 at 700 W
// (src/repro_torch/kernels/sbts_step/csrc/mma_probe.cu, timed by
// chip_smoke.py's times phase), as rates of the same 0/1 product at
// 2 m n k operations per instruction: wgmma .b1 m64n256k256 1.5e16/s,
// mma.sync .b1 m16n8k256 5.1e15/s, wgmma .s8 m64n256k32 1.9e15/s (the
// data sheet's int8 rate), mma.sync .s8 6.5e14/s.  The .b1 wgmma is 8x
// the int8 wgmma, reads 8x fewer bytes into shared memory, and needs no
// unpacking of words into bytes.  A CUDA-core design is held to the
// POPC pipe: 16 popcounts a clock an SM, 4.2e12/s over 132 SMs at
// 1.98 GHz, 0.55 ms for the K n_pad W = 2.28e9 popcounts of the 16x16
// shape (K = 1024, n_pad = 8448, W = 264).
//
// Bound.  2 K n_pad 32 W = 1.46e11 operations take 0.074 ms at the int8
// tensor-core rate (1,979e12/s) and 0.0097 ms at the measured .b1 rate;
// the bytes (rows and sel read once, 10 MB; the int32 output written
// once, 35 MB) take 0.0133 ms at 3.35e12 B/s.  With the .b1 rate bytes
// bind: the output's writes are the floor.
//
// Design (simple and right first: no producer warp, no TMA, no
// persistence):
// - a block of two warpgroups owns 128 trajectories x 256 vertices;
//   each warpgroup accumulates its 64 x 256 tile in 128 s32 registers a
//   thread, written once at the end;
// - the depth goes by 128-byte panels (32 words, four wgmmas of 256
//   bits each): a panel of sel (128 rows) and of rows (256 rows) is
//   copied with 16-byte cp.async into a ring of four stages under the
//   128-byte swizzle, two panels ahead of the one multiplied; the
//   wgmmas of a panel may still run while the next panel's start;
// - ragged edges are zero in shared memory, where a zero word adds
//   nothing: cp.async's source size zero-fills rows past K or n_pad and
//   words past W (W is ragged in steps of 4 words, n_pad % 128 == 0 in
//   the engine, so W % 4 == 0 there); where W % 4 != 0 or an operand is
//   not 16-byte aligned, the same ring is filled by plain loads;
// - a warpgroup whose 64 trajectories all lie past K (K = 32 in a tile
//   of 128) issues no wgmma and stores nothing;
// - output offsets are 64-bit.
// Measured (chip_smoke.py's times phase, H100 80GB HBM3 at 700 W):
// 0.042 ms at the 16x16 shape, 3.2x the bytes bound.  What holds it
// there: with one block an SM (193 KB of ring), a block's 128 KB of
// counts are stored with no loads in flight, and each of the eight
// trajectory tiles reads the whole adjacency from L2 again.
// The launcher runs on the caller's stream and returns cudaGetLastError
// so that a refused launch is reported to the wrapper.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma_s32.cuh"

namespace {

constexpr int kWG = 2;                 // warpgroups, 64 trajectories each
constexpr int kTK = 64 * kWG;          // trajectories per block
constexpr int kTN = 256;               // vertices per block (the wgmma's N)
constexpr int kThreads = 128 * kWG;
constexpr int kPanelWords = 32;        // 128 bytes of depth per panel
constexpr int kStages = 4;             // ring depth (a power of 2)
constexpr int kAhead = 2;              // panels loading while one multiplies
constexpr int kStageBytes = (kTK + kTN) * 128;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes;

// Copies panel p (words 32 p .. 32 p + 31) of rows [r0, r0 + R) of an
// (nrows, w) word matrix into a swizzled panel of R 128-byte rows at
// dst; rows >= nrows and words >= w read as 0.
template <int R>
__device__ __forceinline__ void load_panel(uint8_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int r0, int nrows, int w, int p,
                                           bool vec, int tid) {
#pragma unroll
  for (int idx = tid; idx < R * 8; idx += kThreads) {
    const int r = idx >> 3, c = idx & 7;
    const int row = r0 + r, word = p * kPanelWords + c * 4;
    uint8_t* dp = dst + swz(r, c);
    const uint32_t* sp = src + static_cast<size_t>(row) * w + word;
    if (vec) {
      const bool ok = row < nrows && word < w;
      cp_async16(smem_u32(dp), ok ? sp : src, ok);
    } else {
      uint4 v;
      const bool in_row = row < nrows;
      v.x = in_row && word < w ? sp[0] : 0u;
      v.y = in_row && word + 1 < w ? sp[1] : 0u;
      v.z = in_row && word + 2 < w ? sp[2] : 0u;
      v.w = in_row && word + 3 < w ? sp[3] : 0u;
      *reinterpret_cast<uint4*>(dp) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
selection_counts_kernel(const uint32_t* __restrict__ rows,
                        const uint32_t* __restrict__ sel,
                        int32_t* __restrict__ out, int n_pad, int k, int w,
                        int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Stage s: sel's panel (kTK rows) then rows' panel (kTN rows).
  const int tid = threadIdx.x, wg = tid >> 7;
  const int v0 = blockIdx.x * kTN;
  const int k0 = blockIdx.y * kTK;
  const int n_panels = (w + kPanelWords - 1) / kPanelWords;
  const bool active = k0 + wg * 64 < k;   // warpgroup-uniform

  auto load = [&](int p) {
    uint8_t* st = smem + (p & (kStages - 1)) * kStageBytes;
    load_panel<kTK>(st, sel, k0, k, w, p, vec, tid);
    load_panel<kTN>(st + kTK * 128, rows, v0, n_pad, w, p, vec, tid);
  };
  for (int p = 0; p < kAhead; ++p) {
    if (p < n_panels) load(p);
    cp_async_commit();
  }

  const uint32_t base = smem_u32(smem);
  // Descriptors of stage 0 (this warpgroup's 64 rows of sel; the 256
  // rows of rows); a panel adds its stage's offset, a wgmma 32 bytes.
  const uint64_t da = desc(base + wg * 64 * 128, 16, 1024);
  const uint64_t db = desc(base + kTK * 128, 16, 1024);
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  for (int p = 0; p < n_panels; ++p) {
    cp_async_wait<kAhead - 1>();   // panel p has landed
    fence_proxy_async();           // visible to wgmma, before new copies
    __syncthreads();               // every thread's copies of panel p
    // Over panel p - 2's stage: its wgmmas were waited for in step p - 1.
    if (p + kAhead < n_panels) load(p + kAhead);
    cp_async_commit();
    if (active) {
      const uint64_t off = ((p & (kStages - 1)) * kStageBytes) >> 4;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_b1_m64n256(acc, da + off + 2 * kk, db + off + 2 * kk, 1);
      wg_commit();
      wg_wait<1>();   // panel p - 1's wgmmas are done
    }
  }
  if (active) {
    wg_wait<0>();
    wgmma_fence_regs(acc);
  }
  cp_async_wait<0>();
  if (!active) return;

  // The accumulator's fragment: thread (warp, lane) of the warpgroup
  // holds rows 16 warp + lane / 4 and 8 more, columns 8 i + 2 (lane % 4)
  // and the next, for i < 32.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = k0 + wg * 64 + warp * 16 + (lane >> 2);
  const bool pairs = (n_pad & 1) == 0;   // int2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = row0 + 8 * h;
    if (kk >= k) continue;
    int32_t* orow = out + static_cast<size_t>(kk) * n_pad;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int v = v0 + 8 * i + 2 * (lane & 3);
      const int a = acc[4 * i + 2 * h], b = acc[4 * i + 2 * h + 1];
      if (pairs && v + 1 < n_pad) {
        *reinterpret_cast<int2*>(orow + v) = make_int2(a, b);
      } else {
        if (v < n_pad) orow[v] = a;
        if (v + 1 < n_pad) orow[v + 1] = b;
      }
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
  cudaError_t err = cudaFuncSetAttribute(
      selection_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cp.async moves 16 bytes: whole runs of 4 words from 16-byte aligned
  // rows; otherwise plain loads.
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  const dim3 grid((n_pad + kTN - 1) / kTN, (k + kTK - 1) / kTK);
  selection_counts_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(sel),
      static_cast<int32_t*>(out), n_pad, k, w, vec);
  return static_cast<int>(cudaGetLastError());
}
