// The grouped (ragged) matrix product of the mixture-of-experts FFN:
// rows sorted by group, each group's rows times its own weight matrix.
//
// The port's counterpart of jax.lax.ragged_dot as repro/models/moe.py
// (moe_ffn, :67-73) calls it, on p["w_*"].astype(compute_dtype).
// ragged_dot is an XLA operation, not a Pallas kernel: the JAX package
// has no TPU kernel for it to replace.
//
//   x (M, K) bf16, rows sorted by group; w (G, K, N) bf16 or fp32;
//   offsets (G + 1,) int32 on the device, group g the rows
//   [offsets[g], offsets[g + 1]); rows outside [offsets[0], offsets[G])
//   are zero
//   -> y (M, N) bf16,  y[r] = bf16(sum_k x[r, k] bf16(w[g(r), k, :])),
//   summed in fp32, where bf16(w) rounds fp32 weights to nearest even as
//   w.to(torch.bfloat16) does.  The MoE FFN passes its fp32 expert
//   stacks as they are stored, and the kernel rounds them as it loads
//   them: no call casts a stack.  fp32 x with fp32 w (the port's fp32
//   compute mode) takes the TF32 tensor cores, three TF32 products for
//   each fp32 one (ragged_tf32.cuh), or the CUDA cores in fp32.
//
// The offsets are read on the card: the caller never needs a group's
// size on the host, so a MoE layer makes no host sync (a loop of
// torch.matmul over the groups would need every size there).
//
// Bound.  2 M K N FLOP at the bf16 tensor-core rate against the bytes:
// x, the weights of every non-empty group at their stored width, y, each
// once.  mixtral's prefill gate/up (8000 rows, K = 4096, N = 14336, 8
// groups) is 9.4e11 FLOP, 0.95 ms at 989e12 FLOP/s, against 2.2 GB
// with fp32 weights, 0.65 ms at 3.35e12 B/s: operations bind.  A decode
// step (8 rows in 5 groups) reads 5 fp32 weight matrices, 1.17 GB,
// 0.35 ms: bytes bind.
//
// Design of the bf16 route (ragged_dot_tc_kernel: TMA and wgmma), for
// K a multiple of 8, N a multiple of 4 (fp32 w) or 8 (bf16 w), x and w
// on 16 bytes and G <= 1024 (every model path's shape):
// - Operands swapped: an item computes y^T = w^T x^T, so the weights are
//   wgmma's A, taken from registers, and x's rows are wgmma's N.  The
//   consumer threads read their A fragments of the weight tile from
//   shared memory and round them there (cvt.rn.bf16x2.f32): the rounded
//   weights never go back to shared memory, where a bf16 B tile would
//   cost one more write and read of every weight element per item.  x,
//   bf16 and K-major, is B, read by wgmma from shared memory as TMA lays
//   it out (128-byte swizzle).  A bf16 weight is taken as it is, so the
//   fp32 call is bit for bit the call on w.to(torch.bfloat16).  The swap
//   also suits decode: x's few rows a group are wgmma's N, which can be
//   small, where they would pad a 64-row M.
// - Work items are (segment, row tile, 128-column tile), with row tiles
//   of BX = 256 rows, or 64 when M <= 64 (decode: every group fits in
//   one).  A row tile starts at its group's first row, so no tile is
//   computed for two groups (rows of x past the group that a tile loads
//   are computed and not stored).  Each block scans the offsets into the
//   segments' rows and item counts with one warp (the rows before the
//   first group and past the last are segments whose items write zeros).
// - Persistent grid: one block an SM walks items blockIdx.x, +gridDim.x,
//   ...; items are numbered group by group, column tile by column tile,
//   row tile fastest, so the blocks that run together share one group's
//   weight column panels and x rows in the 50 MB L2.
// - A block is a producer warpgroup (40 registers a thread, setmaxnreg)
//   and two consumer warpgroups (232).  One producer thread issues each
//   64-deep K slice as TMA loads: x's BX x 64 box (a 2-D map) and the
//   weights' 64 x 128 as boxes of 128 bytes a row (a 3-D map over
//   (G, K, N): 4 boxes of 32 fp32 columns or 2 of 64 bf16), into a ring
//   of as many stages as 220 KB holds (3 of 64 KB for fp32 weights at
//   BX = 256), with full and empty mbarriers; it runs on into the next
//   item while the consumers store the last one.  Each consumer
//   warpgroup owns 64 of the 128 columns: per stage it reads its A
//   fragments (8 loads a thread per 16-deep step, free of bank conflicts
//   under the swizzle), issues four wgmma.m64nBXk16 (bf16 in, fp32
//   sums), and releases the stage when they are done.
// - Epilogue: each sum rounded once to bf16; lanes g and g ^ 1 swap one
//   value so each stores two adjacent columns of a row of y; rows past
//   the item's group and columns past N are not stored.
// - The tensor maps are encoded on the host for each call with
//   cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (the
//   library does not link libcuda), and passed as __grid_constant__
//   parameters.
// - What holds it back at mixtral's prefill (twice its bound): a 16-deep
//   step of a block moves 40 KB through shared memory (x read by both
//   warpgroups' wgmma, the fp32 weights read into A, the TMA writes)
//   against 246 cycles of tensor work at the peak rate, and three 64 KB
//   stages are all the ring holds: with two it runs far slower, and
//   32-deep stages (six of them) were slower still.
//
// Other bf16 inputs (ragged_dot_kernel, mma.sync): 128-row tiles aligned
// at 0; a work item is one (group, row tile) pair whose rows meet, so a
// tile that spans a group edge is computed once for each of its groups
// with the other groups' rows zeroed on load and left out of the store.
// There are at most ceil(M / 128) + G such items, plus two that write
// zeros before offsets[0] and past offsets[G]; grid.y counts that many
// and each block finds its own item by walking the offsets.  A block of
// 8 warps computes a 128 x 128 tile of y on mma.sync m16n8k16, each warp
// 32 x 64, from a two-stage ring of 32-deep K slices: x's rows as A
// (ldmatrix), w's rows [k][n] as B (ldmatrix .trans).  Rows and columns
// past the edges load as zeros.  Rows that are not whole 16-byte chunks
// (K or N not a multiple of 8, or a base off 16 bytes) and fp32 weights
// (rounded on load) take plain loads; the rest cp.async.
//
// fp32 x and w, for K and N multiples of 4, x, w and y on 16 bytes and
// G <= 1024 (every model path's shape): ragged_tf32_kernel<false>
// (ragged_tf32.cuh), the TMA + wgmma design above on the TF32 tensor
// cores: 128-row items, 32-deep stages (x's 128 rows split into TF32 hi
// and lo panels by the producer warpgroup's spare warps, the weights'
// 32 x 128 as four boxes), the weights as A split in registers, and per
// 8-deep step three wgmma.m64n128k8 (hi hi, hi lo, lo hi) into a stage
// sum that joins an fp32 total.  Bound: 2 M K N FLOP three times at the
// TF32 rate (494e12), 5.8 ms at mixtral's gate/up; what holds it back is
// shared memory: each 8-deep step reads its B panel in three products in
// each warpgroup (32 bytes of B for every 1024 FLOP), and the split pass
// reads each B element once and writes it twice.
// Other fp32 inputs (ragged_dot_f32_kernel, the CUDA cores): the
// mma.sync route's work items on 64-row tiles; a block of 256 threads
// computes 64 x 64 outputs, 4 x 4 a thread, with fp32 FMAs in k order
// from 16-deep slices in shared memory (plain loads).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "../../csrc/mma_bf16.cuh"
#include "../../csrc/sm90.cuh"
#include "../../csrc/tf32_mma.cuh"
#include "../../csrc/wgmma_bf16.cuh"
#include "ragged_items.cuh"
#include "ragged_tc.cuh"
#include "ragged_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// ------------------------------------------------- the mma.sync route
constexpr int BM = 128;            // rows of y a block computes
constexpr int BN = 128;            // columns of y a block computes
constexpr int BK = 32;             // the K slice of one ring stage
constexpr int THREADS = 256;       // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;       // bf16 a row of the A stage (80 bytes)
constexpr int B_LD = BN + 8;       // bf16 a row of the B stage (272 bytes)

struct __align__(16) Stage {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 b[BK * B_LD];
};

// One K slice [kb, kb + BK) into a ring stage: A is rows [m0, m0 + BM)
// of x, zero outside [lo, hi); B is rows [kb, kb + BK) of the group's
// weights, columns [n0, n0 + BN), rounded to bf16 if they are fp32.
template <bool VEC, typename TW>
__device__ __forceinline__ void load_stage(Stage& st,
                                           const __nv_bfloat16* __restrict__ x,
                                           const TW* __restrict__ wg,
                                           int m0, int lo, int hi, int n0,
                                           int kb, int k, int n) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int c = threadIdx.x; c < BM * BK / 8; c += THREADS) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int row = m0 + r, col = kb + kc;
    const bool in = row >= lo && row < hi;
    __nv_bfloat16* dst = &st.a[r * A_LD + kc];
    if (VEC) {
      const bool v = in && col < k;
      cp_async16(smem_u32(dst), v ? x + static_cast<size_t>(row) * k + col : x,
                 v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = in && col + j < k ? x[static_cast<size_t>(row) * k + col + j]
                                   : zero;
    }
  }
  for (int c = threadIdx.x; c < BK * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int kk = kb + r, col = n0 + nc;
    __nv_bfloat16* dst = &st.b[r * B_LD + nc];
    if (VEC && sizeof(TW) == 2) {
      const bool v = kk < k && col < n;
      cp_async16(smem_u32(dst),
                 v ? wg + static_cast<size_t>(kk) * n + col : wg, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = kk < k && col + j < n
                     ? to_bf16(wg[static_cast<size_t>(kk) * n + col + j])
                     : zero;
    }
  }
}

template <bool VEC, typename TW>
__global__ void __launch_bounds__(THREADS)
    ragged_dot_kernel(const __nv_bfloat16* __restrict__ x,
                      const TW* __restrict__ w,
                      const int* __restrict__ offsets,
                      __nv_bfloat16* __restrict__ y, int m, int k, int n,
                      int groups) {
  __shared__ Stage ring[2];
  __shared__ int item[4];

  if (!find_item<BM>(offsets, m, groups, item)) return;
  const int seg = item[0], m0 = item[1], lo = item[2], hi = item[3];
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (seg >= 1 && seg <= groups) {
    const TW* wg = w + static_cast<size_t>(seg - 1) * k * n;
    const int ktiles = (k + BK - 1) / BK;
    if (ktiles > 0)
      load_stage<VEC, TW>(ring[0], x, wg, m0, lo, hi, n0, 0, k, n);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles)
        load_stage<VEC, TW>(ring[(kt + 1) & 1], x, wg, m0, lo, hi, n0,
                            (kt + 1) * BK, k, n);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const Stage& st = ring[kt & 1];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + (lane & 15);
          const int c = kk + (lane >> 4) * 8;
          ldsm_x4(a[mt], smem_u32(&st.a[r * A_LD + c]));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // Matrices 0-3: k rows kk..+7 and kk+8..+15 of the n8 tile
          // 2 np, then of tile 2 np + 1.
          const int mi = lane >> 3;
          const int kr = kk + (mi & 1) * 8 + (lane & 7);
          const int nc = wn * 64 + np * 16 + (mi >> 1) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(&st.b[kr * B_LD + nc]));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
      __syncthreads();
    }
  }

  // Store this item's rows [lo, hi) of the tile, rounded once to bf16.
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
      if (row < lo || row >= hi) continue;
      __nv_bfloat16* yr = y + static_cast<size_t>(row) * n;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (VEC) {
          if (col < n)
            *reinterpret_cast<__nv_bfloat162*>(yr + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) yr[col] = __float2bfloat16_rn(v0);
          if (col + 1 < n) yr[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ------------------------------------------ the TMA + wgmma route
namespace tc {

constexpr int kBK = 64;              // K of a ring stage (128 bytes of x)
constexpr int kSteps = kBK / 16;     // wgmma k-steps a stage
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kPanelBytes = kBK * 128;      // one weight box, 8 KB
constexpr int kRingBudget = 220 * 1024;     // of the 227 KB a block may use

// BX x rows an item (wgmma's N: 256, or 64 when every group fits in 64
// rows), weights of type TW.
template <typename TW, int BX>
struct Cfg {
  static constexpr int kXBytes = BX * kBK * 2;
  static constexpr int kPanelCols = 128 / static_cast<int>(sizeof(TW));
  static constexpr int kPanels = kBW / kPanelCols;
  static constexpr int kStageBytes = kXBytes + kPanels * kPanelBytes;
  static constexpr int kStages =
      kRingBudget / kStageBytes < 8 ? kRingBudget / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
};

template <typename TW, int BX>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_dot_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw,
                         const int* __restrict__ offsets,
                         bf16* __restrict__ y, int m, int k, int n,
                         int groups) {
  using C = Cfg<TW, BX>;
  constexpr int kAcc = BX / 2;   // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[2 * C::kStages];   // full, then empty
  // edge[j] = min(max(0, offsets[0..j]), m): group g is the rows
  // [edge[g], edge[g + 1]), as the plain version clamps them; segment 0
  // is [0, edge[0]) and segment groups + 1 is [edge[groups], m).
  __shared__ int edge[kMaxGroups + 1];
  __shared__ int cum[kMaxGroups + 3];         // items before segment s
  const int tid = threadIdx.x, lane = tid & 31;
  const int col_tiles = (n + kBW - 1) / kBW;
  const int ktiles = (k + kBK - 1) / kBK;

  for (int j = tid; j <= groups; j += kThreads) edge[j] = offsets[j];
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[C::kStages + s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {   // scans of 32 at a time: the running max, then cum
    scan_edges(edge, groups, m, lane);
    count_items<BX>(edge, cum, groups, m, col_tiles, lane);
  }
  __syncthreads();
  const int items = cum[groups + 2];

  if (tid >= kConsumers) {   // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it = item_at<BX>(i, cum, edge, groups, m);
        if (it.seg == 0 || it.seg > groups) continue;   // zeros: no loads
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(smem_u32(&bars[C::kStages + stage]), phase ^ 1);
          const uint32_t full = smem_u32(&bars[stage]);
          const uint32_t st = smem_u32(smem + stage * C::kStageBytes);
          mbar_expect_tx(full, C::kStageBytes);
          tma_load_2d(st, &tmx, full, kt * kBK, it.r0);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)
            tma_load_3d(st + C::kXBytes + p * kPanelBytes, &tmw, full,
                        it.n0 + p * C::kPanelCols, kt * kBK, it.seg - 1);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // A consumer: warpgroup wg owns columns [64 wg, 64 wg + 64) of an
  // item's 128, warp w of it 16 of them; the thread's A rows are the
  // columns c0 and c0 + 8, its k the rows 2 t, 2 t + 1, 2 t + 8 and
  // 2 t + 9 of each 16-deep step (wgmma's A fragment).
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * 64 + warp * 16 + g;
  // Byte offsets in a stage of (column c0 + 8 ci, k row 2 t + kb + 8 kh)
  // of step 0: the weights' panel, the row, the swizzled chunk.
  uint32_t off[2][2][2];
#pragma unroll
  for (int ci = 0; ci < 2; ++ci)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int c = c0 + 8 * ci, kr = 2 * t + kb + 8 * kh;
        const int byte = (c % C::kPanelCols) * static_cast<int>(sizeof(TW));
        off[ci][kb][kh] = C::kXBytes + (c / C::kPanelCols) * kPanelBytes +
                          kr * 128 + (((byte >> 4) ^ (kr & 7)) << 4) +
                          (byte & 15);
      }
  const uint64_t x_desc = desc(smem_u32(smem), 16, 1024);

  float acc[kAcc];
  uint32_t a[kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  // One K slice: the stage's A fragments, its kSteps wgmma, and the
  // stage released once they are done.  A warpgroup's next A fragments wait
  // for its products: ptxas serialises wgmma whose register inputs are
  // written while earlier ones are in flight, and the other warpgroup's
  // products fill the tensor cores meanwhile.
  auto step = [&]() {
    mbar_wait(smem_u32(&bars[stage]), phase);
    const uint8_t* st = smem + stage * C::kStageBytes;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = e & 1, kh = e >> 1;
        a[s][e] = pack2(
            reinterpret_cast<const TW*>(st + s * 2048 + off[ci][0][kh]),
            reinterpret_cast<const TW*>(st + s * 2048 + off[ci][1][kh]));
      }
    uint64_t db[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      db[s] = x_desc + ((stage * C::kStageBytes + s * 32) >> 4);
      asm volatile("" : "+l"(db[s])::"memory");
    }
    pin_frags(a);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      Wgmma<BX>::template rs<0>(acc, a[s], db[s], 1);
    wg_commit();

    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive(smem_u32(&bars[C::kStages + stage]));
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at<BX>(i, cum, edge, groups, m);
    if (it.seg == 0 || it.seg > groups) {   // rows outside the groups
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
      for (int e = tid; e < BX * (kBW / 2); e += kConsumers) {
        const int row = it.r0 + e / (kBW / 2);
        const int col = it.n0 + 2 * (e % (kBW / 2));
        if (row < it.r_end && col < n)
          *reinterpret_cast<__nv_bfloat162*>(
              y + static_cast<int64_t>(row) * n + col) = z;
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) step();

    // acc[4 j + 2 h + e] is (column c0 + 8 h, x row 8 j + 2 t + e) of
    // the item.  Lane g ^ 1 holds the neighbouring column: an even g
    // stores row 2 t, columns (c, c + 1), an odd g row 2 t + 1, columns
    // (c - 1, c).
    const bool odd = g & 1;
    const int col_base = it.n0 + c0 - (odd ? 1 : 0);
#pragma unroll
    for (int j = 0; j < BX / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int row = it.r0 + 8 * j + 2 * t + (odd ? 1 : 0);
        const int col = col_base + 8 * h;
        if (row < it.r_end && col < n)
          *reinterpret_cast<__nv_bfloat162*>(
              y + static_cast<int64_t>(row) * n + col) =
              odd ? __floats2bfloat162_rn(other, v1)
                  : __floats2bfloat162_rn(v0, other);
      }
  }
}

template <typename TW, int BX>
int launch(const CUtensorMap& tmx, const CUtensorMap& tmw,
           const int* offsets, bf16* y, int m, int k, int n, int groups,
           int sms, cudaStream_t s) {
  const long long items =
      ((m + BX - 1LL) / BX + groups + 2) * ((n + kBW - 1) / kBW);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const cudaError_t e = cudaFuncSetAttribute(
      ragged_dot_tc_kernel<TW, BX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<TW, BX>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ragged_dot_tc_kernel<TW, BX><<<blocks, kThreads, Cfg<TW, BX>::kSmem, s>>>(
      tmx, tmw, offsets, y, m, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

constexpr int F_TILE = 64;         // fp32: rows and columns a block computes
constexpr int F_BK = 16;           // fp32: the K slice in shared memory

__global__ void __launch_bounds__(THREADS)
    ragged_dot_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const int* __restrict__ offsets,
                          float* __restrict__ y, int m, int k, int n,
                          int groups) {
  __shared__ float as[F_BK][F_TILE + 4];   // x's slice, k-major
  __shared__ float bs[F_BK][F_TILE + 4];
  __shared__ int item[4];
  if (!find_item<F_TILE>(offsets, m, groups, item)) return;
  const int seg = item[0], m0 = item[1], lo = item[2], hi = item[3];
  const int n0 = blockIdx.x * F_TILE;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  if (seg >= 1 && seg <= groups) {
    const float* wg = w + static_cast<size_t>(seg - 1) * k * n;
    for (int kb = 0; kb < k; kb += F_BK) {
      for (int e = threadIdx.x; e < F_TILE * F_BK; e += THREADS) {
        const int r = e / F_BK, kk = e % F_BK, row = m0 + r;
        as[kk][r] = row >= lo && row < hi && kb + kk < k
                        ? x[static_cast<size_t>(row) * k + kb + kk]
                        : 0.0f;
        const int br = e / F_TILE, bc = e % F_TILE;
        bs[br][bc] = kb + br < k && n0 + bc < n
                         ? wg[static_cast<size_t>(kb + br) * n + n0 + bc]
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = as[kk][tr * 4 + i];
          b[i] = bs[kk][tc * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tr * 4 + i;
    if (row < lo || row >= hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tc * 4 + j;
      if (col < n) y[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

}  // namespace

// The TMA + wgmma route: x (m, k) bf16, w (groups, k, n) fp32
// (w_fp32 != 0) or bf16, offsets (groups + 1,) int32 and y (m, n) bf16,
// all on the current device; k a multiple of 8, n of 4 (fp32) or 8
// (bf16), x and w on 16 bytes, groups <= 1024 (ops.TC_MAX_GROUPS).
// Returns the launch's CUDA error (0 on success), or 100000 plus the
// CUresult of a tensor map that could not be encoded.
extern "C" int ragged_dot_tc_launch(const void* x, const void* w,
                                    const void* offsets, void* y, int m,
                                    int k, int n, int groups, int w_fp32,
                                    void* stream) {
  using namespace tc;
  if (m <= 0 || n <= 0) return 0;
  const int esz = w_fp32 ? 4 : 2;
  if (k < 0 || groups < 0 || groups > kMaxGroups || k % 8 != 0 ||
      n % (16 / esz) != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // 64-row items when every group fits in one (decode), else 256.
  const int bx = m <= 64 ? 64 : 256;
  CUtensorMap tmx, tmw;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmw, 0, sizeof(tmw));
  if (k > 0) {   // with k == 0 no item loads: every row is zero
    const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(k) * 2};
    const cuuint32_t xbox[2] = {kBK, static_cast<cuuint32_t>(bx)};
    int r = encode(&tmx, x, false, 2, xdim, xstride, xbox);
    if (r != 0) return 100000 + r;
    if (groups > 0) {
      const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(k),
                                  static_cast<cuuint64_t>(groups)};
      const cuuint64_t wstride[2] = {
          static_cast<cuuint64_t>(n) * esz,
          static_cast<cuuint64_t>(k) * n * esz};
      const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(128 / esz), kBK,
                                  1};
      r = encode(&tmw, w, w_fp32 != 0, 3, wdim, wstride, wbox);
      if (r != 0) return 100000 + r;
    }
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  auto* yp = static_cast<bf16*>(y);
  if (bx == 64)
    return w_fp32
               ? launch<float, 64>(tmx, tmw, op, yp, m, k, n, groups, sms, s)
               : launch<bf16, 64>(tmx, tmw, op, yp, m, k, n, groups, sms, s);
  return w_fp32
             ? launch<float, 256>(tmx, tmw, op, yp, m, k, n, groups, sms, s)
             : launch<bf16, 256>(tmx, tmw, op, yp, m, k, n, groups, sms, s);
}

// The fp32 route on the TF32 tensor cores (ragged_tf32.cuh): x (m, k),
// w (groups, k, n), offsets (groups + 1,) int32 and y (m, n), float32 on
// the current device; k and n multiples of 4, x, w and y on 16 bytes,
// groups <= 1024 (ops.fp32_tc_route).  Returns the launch's CUDA error
// (0 on success), or 100000 plus the CUresult of a tensor map that could
// not be encoded.
extern "C" int ragged_dot_tf32_launch(const void* x, const void* w,
                                      const void* offsets, void* y, int m,
                                      int k, int n, int groups,
                                      void* stream) {
  using namespace tf;
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || !takes(k, n, groups,
                      reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmw, 0, sizeof(tmw));
  if (k > 0) {   // with k == 0 no item loads: every row is zero
    const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(k) * 4};
    const cuuint32_t xbox[2] = {kBK, kRows};
    int r = tc::encode(&tmx, x, true, 2, xdim, xstride, xbox);
    if (r != 0) return 100000 + r;
    if (groups > 0) {
      const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(k),
                                  static_cast<cuuint64_t>(groups)};
      const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(n) * 4,
                                     static_cast<cuuint64_t>(k) * n * 4};
      const cuuint32_t wbox[3] = {32, kBK, 1};
      r = tc::encode(&tmw, w, true, 3, wdim, wstride, wbox);
      if (r != 0) return 100000 + r;
    }
  }
  return launch<false>(tmx, tmw, static_cast<const int*>(offsets),
                       static_cast<float*>(y), m, n, k, groups,
                       static_cast<cudaStream_t>(stream));
}

// The other routes: x (m, k), w (groups, k, n), offsets (groups + 1,)
// int32 and y (m, n), all on the device; fp32 != 0: x, w and y float32
// (the CUDA cores); else x and y bf16 and w bf16, or float32 with
// w_fp32 != 0 (mma.sync, weights rounded on load); vec != 0 when k and
// n are multiples of 8 and x, w and y start on 16 bytes.  Returns the
// launch's CUDA error (0 on success).
extern "C" int ragged_dot_launch(const void* x, const void* w,
                                 const void* offsets, void* y, int m, int k,
                                 int n, int groups, int vec, int fp32,
                                 int w_fp32, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = fp32 ? F_TILE : BM;
  const long long items =
      (m + tile - 1) / tile + static_cast<long long>(groups) + 2;
  const long long col_tiles = (n + tile - 1) / tile;
  if (items > 65535 || col_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  if (fp32) {
    ragged_dot_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), op,
        static_cast<float*>(y), m, k, n, groups);
    return static_cast<int>(cudaGetLastError());
  }
  auto* xp = static_cast<const bf16*>(x);
  auto* yp = static_cast<bf16*>(y);
  if (w_fp32) {
    auto* wp = static_cast<const float*>(w);
    if (vec)
      ragged_dot_kernel<true, float><<<grid, THREADS, 0, s>>>(
          xp, wp, op, yp, m, k, n, groups);
    else
      ragged_dot_kernel<false, float><<<grid, THREADS, 0, s>>>(
          xp, wp, op, yp, m, k, n, groups);
  } else {
    auto* wp = static_cast<const bf16*>(w);
    if (vec)
      ragged_dot_kernel<true, bf16><<<grid, THREADS, 0, s>>>(
          xp, wp, op, yp, m, k, n, groups);
    else
      ragged_dot_kernel<false, bf16><<<grid, THREADS, 0, s>>>(
          xp, wp, op, yp, m, k, n, groups);
  }
  return static_cast<int>(cudaGetLastError());
}
