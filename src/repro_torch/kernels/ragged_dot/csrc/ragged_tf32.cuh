// The grouped product's fp32 kernels on the TF32 tensor cores (3xTF32:
// csrc/tf32_mma.cuh), for fp32 x and weights: the forward (ragged_dot.cu)
// and dx (ragged_dot_bwd.cu) are one kernel, ragged_tf32_kernel; dw
// (ragged_dot_bwd.cu, ragged_dw_tf32_kernel) shares its pieces here.
//
// The shape of the bf16 route (ragged_tc.cuh) with three TF32 products
// for each fp32 one: a persistent grid of one block an SM; a producer
// warpgroup whose thread 0 issues TMA loads into a ring of stages
// (mbarriers: full, then ready, then empty) and whose warps 1-3 split
// each landed stage's B operand into TF32 hi and lo panels; and two
// consumer warpgroups on wgmma.m64n128k8 (tf32 in, fp32 sums) with the
// weights (dw: x) as A from registers, split there, and the rows of x
// or dy (dw: dy transposed) as B.  Per 8-deep step three products (hi
// hi, hi lo, lo hi), summed a stage at a time (`products`).  Every
// output is summed by one warpgroup in a fixed order: no atomics, and
// two calls give the same bits.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"
#include "../../csrc/tf32_mma.cuh"
#include "../../csrc/wgmma_bf16.cuh"
#include "ragged_tc.cuh"

namespace {
namespace tf {

static_assert(kPasses == 3, "three TF32 products an fp32 product");

constexpr int kBK = 32;            // reduction depth of a stage: 128 bytes
constexpr int kSteps = kBK / 8;    // wgmma k8 steps a stage
constexpr int kRows = 128;         // rows of x (dy) an item: wgmma's N
constexpr int kPanel = 128 * 128;  // 128 rows of 128 bytes, 16 KB
constexpr int kBox = kBK * 128;    // 32 rows of 128 bytes, 4 KB
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kSplitters = 96;     // warps 1-3 of the producer warpgroup
constexpr int kThreads = kConsumers + 128;
// Forward and dx: a stage is B (hi, split in place), B's lo and the
// weights' 16 KB.
constexpr int kStages = 4;
constexpr int kStageBytes = 3 * kPanel;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment

// The stage's B panel split in place: hi = tf32(v) where v landed, lo =
// tf32(v - hi) one panel on (elementwise, so the swizzle holds).
__device__ __forceinline__ void split_panel(uint8_t* p, int sid) {
#pragma unroll 2
  for (int c = sid; c < kPanel / 16; c += kSplitters)
    store_split(p, 16 * c, kPanel,
                *reinterpret_cast<const float4*>(p + 16 * c));
}

// Byte offset of (row r, column c) in four boxes of 32 columns x 32
// rows (128-byte rows, swizzled): the forward's weights, dw's x.
__device__ __forceinline__ uint32_t box_at(int r, int c) {
  return (c >> 5) * kBox + swz(r, (c & 31) >> 2) + (c & 3) * 4;
}

// The column that A row g + 8 u of warp `warp` of warpgroup wg stands
// for when A is read across box rows (the forward's weights, dw's x):
// each warp takes two 4-column groups 16 apart of a 32-column box, so a
// fragment load's lanes (rows t or t + 4, 8 columns) meet 32 banks.
__device__ __forceinline__ int perm_col(int wg, int warp, int g, int u) {
  return 64 * wg + 32 * (warp >> 1) + 8 * (warp & 1) + 16 * (g >> 2) +
         4 * u + (g & 3);
}

// One stage's products for a consumer warpgroup, 4 k8 steps: the small
// terms first (hi lo, lo hi), then hi hi, into `chunk`, which the first
// overwrites; then total += chunk on the CUDA cores.  The tensor cores
// truncate what they add into an accumulator, an error that grows with
// the accumulator's size: a whole 14336-deep sum held in one drifted past
// the fp32 tolerance on the card, so each stage's 32-deep sum starts
// from zero and joins the fp32 total rounded to nearest.  `bh` is the
// descriptor of the hi panel at step 0; lo is one panel on.
__device__ __forceinline__ void products(float (&total)[64],
                                         float (&chunk)[64],
                                         uint32_t (&ah)[kSteps][4],
                                         uint32_t (&al)[kSteps][4],
                                         uint64_t bh) {
  uint64_t db[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    db[s] = bh + 2 * s;   // 32 bytes a step
    asm volatile("" : "+l"(db[s])::"memory");
  }
  pin_frags(ah);
  pin_frags(al);
  fence_acc(chunk);
  wg_fence();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    wgmma_rs128(chunk, ah[s], db[s] + (kPanel >> 4), s > 0);
    wgmma_rs128(chunk, al[s], db[s], 1);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) wgmma_rs128(chunk, ah[s], db[s], 1);
  wg_commit();
  wg_wait<0>();
  fence_acc(chunk);
#pragma unroll
  for (int j = 0; j < 64; ++j) total[j] += chunk[j];
}

// kDx false, the forward: out (m, cols = N) = x (m, depth = K) w[g];
// true, dx: out (m, cols = K) = dy (m, depth = N) w[g]^T.  tmb maps x or
// dy, (depth, m) in boxes of 32 x 128 rows; tmw maps w, (N, K, G): the
// forward loads 32 (N) x 32 (K) boxes, dx one 32 (N) x 128 (K).
template <bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_tf32_kernel(const __grid_constant__ CUtensorMap tmb,
                       const __grid_constant__ CUtensorMap tmw,
                       const int* __restrict__ offsets,
                       float* __restrict__ out, int m, int cols, int depth,
                       int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[3 * kStages];   // full, ready, empty
  __shared__ int edge[tc::kMaxGroups + 1];
  __shared__ int cum[tc::kMaxGroups + 3];
  const int tid = threadIdx.x, lane = tid & 31;
  const int col_tiles = (cols + tc::kBW - 1) / tc::kBW;
  const int ktiles = (depth + kBK - 1) / kBK;

  for (int j = tid; j <= groups; j += kThreads) edge[j] = offsets[j];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[kStages + s]), kSplitters);
      mbar_init(smem_u32(&bars[2 * kStages + s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {
    tc::scan_edges(edge, groups, m, lane);
    tc::count_items<kRows>(edge, cum, groups, m, col_tiles, lane);
  }
  __syncthreads();
  const int items = cum[groups + 2];

  if (tid >= kConsumers) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int sid = tid - kConsumers - 32;   // splitters: warps 1-3
    if (sid < 0 && tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const tc::Item it = tc::item_at<kRows>(i, cum, edge, groups, m);
      if (it.seg == 0 || it.seg > groups) continue;   // zeros: no loads
      for (int kt = 0; kt < ktiles; ++kt) {
        uint8_t* st = smem + stage * kStageBytes;
        if (sid < 0) {
          mbar_wait(smem_u32(&bars[2 * kStages + stage]), phase ^ 1);
          const uint32_t full = smem_u32(&bars[stage]);
          const uint32_t sa = smem_u32(st);
          mbar_expect_tx(full, 2 * kPanel);
          tma_load_2d(sa, &tmb, full, kt * kBK, it.r0);
          if (kDx) {
            tma_load_3d(sa + 2 * kPanel, &tmw, full, kt * kBK, it.n0,
                        it.seg - 1);
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p)
              tma_load_3d(sa + 2 * kPanel + p * kBox, &tmw, full,
                          it.n0 + 32 * p, kt * kBK, it.seg - 1);
          }
        } else {
          mbar_wait(smem_u32(&bars[stage]), phase);
          split_panel(st, sid);
          fence_proxy_async();
          mbar_arrive(smem_u32(&bars[kStages + stage]));
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");

  // A consumer: A row g + 8 u of warp `warp` is output column col[u]
  // (wgmma's M); its k indices are t and t + 4 of each k8 step.  The
  // forward reads them across the weights' box rows (perm_col, box_at);
  // dx along row col[u] of its 128 x 32 weight panel, whose swizzle
  // XORs chunk g (col[u] is g mod 8).
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  int col[2];
  uint32_t aoff[4];   // A element e at step 0: u = e & 1, k t + 4 (e >> 1)
#pragma unroll
  for (int u = 0; u < 2; ++u)
    col[u] = kDx ? 64 * wg + 16 * warp + g + 8 * u
                 : perm_col(wg, warp, g, u);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    aoff[e] = kDx ? col[e & 1] * 128 + 4 * t
                  : box_at(t + 4 * (e >> 1), col[e & 1]);
  const uint64_t d0 = desc(smem_u32(smem));

  float total[64], chunk[64];
  uint32_t ah[kSteps][4], al[kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const tc::Item it = tc::item_at<kRows>(i, cum, edge, groups, m);
    if (it.seg == 0 || it.seg > groups) {   // rows outside the groups
      for (int e = tid; e < kRows * (tc::kBW / 4); e += kConsumers) {
        const int row = it.r0 + e / (tc::kBW / 4);
        const int c = it.n0 + 4 * (e % (tc::kBW / 4));
        if (row < it.r_end && c < cols)
          *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * cols +
                                     c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) total[j] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      mbar_wait(smem_u32(&bars[kStages + stage]), phase);
      const uint8_t* wt = smem + stage * kStageBytes + 2 * kPanel;
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t o =
              kDx ? aoff[e] + (((2 * s + (e >> 1)) ^ g) << 4)
                  : aoff[e] + 1024 * s;
          split(*reinterpret_cast<const float*>(wt + o), ah[s][e], al[s][e]);
        }
      products(total, chunk, ah, al, d0 + ((stage * kStageBytes) >> 4));
      mbar_arrive(smem_u32(&bars[2 * kStages + stage]));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // total[4 j + 2 u + e] is (output column col[u], row 8 j + 2 t + e
    // of the item).
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = it.r0 + 8 * j + 2 * t + e, c = it.n0 + col[u];
          if (row < it.r_end && c < cols)
            out[static_cast<int64_t>(row) * cols + c] =
                total[4 * j + 2 * u + e];
        }
  }
}

template <bool kDx>
int launch(const CUtensorMap& tmb, const CUtensorMap& tmw, const int* offsets,
           float* out, int m, int cols, int depth, int groups,
           cudaStream_t s) {
  const long long items = ((m + kRows - 1LL) / kRows + groups + 2) *
                          ((cols + tc::kBW - 1) / tc::kBW);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = tc::sm_count(&sms);
  if (err != 0) return err;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const cudaError_t e = cudaFuncSetAttribute(
      ragged_tf32_kernel<kDx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ragged_tf32_kernel<kDx><<<blocks, kThreads, kSmem, s>>>(
      tmb, tmw, offsets, out, m, cols, depth, groups);
  return static_cast<int>(cudaGetLastError());
}

// Whether the fp32 tensor-core kernels take a shape: TMA copies rows of
// whole 16-byte units (K and N multiples of 4) from 16-byte bases, and
// a block keeps at most kMaxGroups group edges.
inline bool takes(int k, int n, int groups, uintptr_t bases) {
  return k % 4 == 0 && n % 4 == 0 && groups >= 0 &&
         groups <= tc::kMaxGroups && bases % 16 == 0;
}

}  // namespace tf
}  // namespace
