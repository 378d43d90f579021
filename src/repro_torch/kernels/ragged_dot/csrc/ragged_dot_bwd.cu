// The backward of the grouped (ragged) matrix product: the gradients of
// y = ragged_dot(x, w, offsets) (ragged_dot.cu) given dy.
//
// It replaces no TPU kernel: the JAX package trains the MoE FFN through
// jax.grad of jax.lax.ragged_dot (repro/models/moe.py, moe_ffn, :67-73),
// whose transpose XLA computes.  The port's ragged_dot is a hand-written
// kernel, so its autograd needs these two:
//
//   ragged_dot_dx:  dx[r] = x_type(sum_n dy[r, n] bf16(w[g(r), :, n]))
//                   for r in [offsets[0], offsets[G]), zero elsewhere;
//   ragged_dot_dw:  dw[g] = w_type(x_type(sum_{r in group g} x[r]^T dy[r]))
//                   zero for an empty group,
//
// each sum in fp32 and rounded once to x's type; fp32 weights are
// rounded to bf16 as they load (the forward's rounding), and dw is then
// written in w's type: fp32 w gets the bf16-rounded value, which is what
// autograd through ref.ragged_dot_ref, and the reference's astype VJP,
// both give.  Groups are clamped as the forward clamps them (offsets
// that go down make empty groups), and the offsets are read on the card:
// no host sync.
//
// Bound.  Each of the two is 2 M K N FLOP (every row once through its
// group) at the bf16 tensor-core rate, against its bytes (dx: dy, the
// weights of the used groups, dx; dw: x, dy, dw).  mixtral's gate/up
// backward at M = 8192, K = 4096, N = 14336 is 9.6e11 FLOP each, 0.97 ms
// at 989e12 FLOP/s, against ~0.5 GB: operations bind.  deepseek's at
// (24576, 2048, 1408; 64 groups) is bound by bytes (the fp32 dw of every
// group, 0.74 GB).
//
// Design of the bf16 route for K and N multiples of 8, x, dy and w on 16
// bytes and G <= 1024 (every model path's shape): TMA and wgmma, with a
// persistent grid of one block an SM, each block a producer warpgroup
// (40 registers a thread, setmaxnreg) whose one thread issues TMA loads
// into a ring of stages with full and empty mbarriers, and two consumer
// warpgroups (232) on wgmma; the producer runs on into the next work
// item while the consumers store the last one.
// - dx (ragged_dx_tc_kernel) is the forward's kernel (ragged_dot.cu,
//   ragged_dot_tc_kernel) with dy in x's place: operands swapped, an item
//   computes dx^T = w[g] dy^T over (segment, 256-row tile, 128-column
//   tile of K) items that start at their group's first row (ragged_tc.cuh:
//   segments before the first group and past the last write zeros).  The
//   weights' 128 (K) x 64 (N) slice lands as boxes of 128 bytes a row and
//   is wgmma's A from registers: K-major, so each A register is one 8-byte
//   (fp32, rounded with cvt.rn.bf16x2.f32) or 4-byte (bf16) load of two
//   adjacent n; dy's rows are B, K-major as TMA lays them out.
// - dw (ragged_dw_tc_kernel): an item is (group, 128 rows of K, 256
//   columns of N), k tiles fastest, so that the blocks that run together
//   read one group's rows.  A stage is 64 of the group's rows, from its
//   first: x's as two 64-column boxes (A, MN-major: the transposed
//   operand, which wgmma takes for bf16) and dy's as four (B, MN-major),
//   and each consumer warpgroup issues wgmma.m64n256k16 with both from
//   shared memory.  A box that runs past the group's last row holds other
//   groups' rows (or zeros past M): the consumers zero those rows of both
//   operands in shared memory before the product, since dw sums over the
//   rows.  Each block walks its group's rows in order and writes its tile
//   once: no atomics and no split over the rows, so two calls give the
//   same bits; an empty group's tiles are written as zeros.
// Other bf16 inputs (K or N off a multiple of 8, a base off 16 bytes,
// more than 1024 groups) take the mma.sync kernels, counted apart
// (ops.py: LAUNCHES["ragged_dot_bwd_mma"]): mma.sync m16n8k16 with fp32
// accumulators, a block of 8 warps computing a 128 x 128 output tile,
// each warp 32 x 64, from a two-stage ring of 32-deep slices (cp.async
// for whole 16-byte chunks; plain loads for ragged rows and for fp32
// weights, which are rounded as they are stored to shared memory).
// - dx: the forward's work items ((group, 128-row tile) pairs whose rows
//   meet, found by walking the offsets; rows of other groups zeroed on
//   load and left out of the store), the output's columns over K, the
//   slices over N.  A = dy's rows (ldmatrix); B = w[g]'s rows k as they
//   are stored, n contiguous, which is mma's column-major B.
// - dw: grid (N tile, K tile, group); each block walks its group's rows
//   in ascending order, 32 a slice, and writes its tile once.  A = x^T
//   and B = dy, both stored row by row, ldmatrix .trans for A.
// fp32 (x and w fp32), for K and N multiples of 4, every pointer on 16
// bytes and G <= 1024: the TF32 tensor cores, three TF32 products for
// each fp32 one, summed a 32-deep stage at a time into an fp32 total
// (ragged_tf32.cuh), bound by 3 x 2 M K N FLOP at the TF32 rate (5.8 ms
// each at mixtral's gate/up) and held back by shared memory as the
// forward is.
// - dx is the forward's kernel (ragged_tf32_kernel<true>) with dy in x's
//   place and w[g]'s 128 (K) x 32 (N) panel as A, read along its rows.
// - dw (ragged_dw_tf32_kernel): the bf16 dw's items and row walk, with
//   A = x^T from registers (read across its box rows, as the forward's
//   weights) and B = dy^T: TF32 wgmma reads B K-major only, so the
//   producer warpgroup's spare warps transpose each stage's dy rows into
//   hi and lo panels, zeroing the rows past the group in x and dy.
// Other fp32 inputs take the CUDA cores: 64 x 64 outputs a block of 256
// threads, 4 x 4 a thread, fp32 FMAs in the reduction's order from
// 16-deep slices in shared memory (plain loads).
//
// Every route is deterministic: every output is summed by one thread in
// a fixed order.  The launchers are plain C functions (no PyTorch
// headers) that return cudaGetLastError, so a refused launch is reported;
// the TMA routes' tensor maps are encoded on the host for each call
// (ragged_tc.cuh).

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

constexpr int BM = 128;        // output rows a block computes
constexpr int BN = 128;        // output columns a block computes
constexpr int BK = 32;         // the reduction slice of one ring stage
constexpr int THREADS = 256;   // 8 warps: 4 along the rows x 2 along columns
constexpr int S_LD = BK + 8;   // dx: bf16 a row of a [128][32] stage (80 B)
constexpr int T_LD = BN + 8;   // dw: bf16 a row of a [32][128] stage (272 B)

struct __align__(16) DxStage {
  bf16 a[BM * S_LD];   // dy rows [m0, m0 + 128), columns of a slice of N
  bf16 b[BN * S_LD];   // w[g] rows [k0, k0 + 128), the same columns
};
struct __align__(16) DwStage {
  bf16 a[BK * T_LD];   // x rows of a slice, columns [k0, k0 + 128)
  bf16 b[BK * T_LD];   // dy rows of the slice, columns [n0, n0 + 128)
};

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
// A sum rounded once to bf16, then written in the output's type.
template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ bf16 store_as<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight elements of a row from src (cols [c, c + 8) of a row of length
// len, zeros past it and where !in) as bf16 into 16 bytes of shared
// memory: a cp.async of 16 bytes for bf16 when vec, else loads (two
// float4 for fp32 when vec) rounded to bf16.
template <bool VEC, typename T>
__device__ __forceinline__ void load8(bf16* dst, const T* src, bool in, int c,
                                      int len) {
  if (VEC && sizeof(T) == 2) {
    const bool v = in && c < len;
    cp_async16(smem_u32(dst), v ? src + c : src, v);
  } else if (VEC) {
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (in && c < len) {
      lo = *reinterpret_cast<const float4*>(src + c);
      hi = *reinterpret_cast<const float4*>(src + c + 4);
    }
    __align__(16) bf16 t[8] = {to_bf16(lo.x), to_bf16(lo.y), to_bf16(lo.z),
                               to_bf16(lo.w), to_bf16(hi.x), to_bf16(hi.y),
                               to_bf16(hi.z), to_bf16(hi.w)};
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(t);
  } else {
    __align__(16) bf16 t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t[j] = in && c + j < len ? to_bf16(src[c + j]) : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(t);
  }
}

// The rows [lo, hi) of segment s (0: before offsets[0]; 1..groups: group
// s - 1; groups + 1: past offsets[groups]) clamped as the forward clamps
// them: each segment starts where the one before it ended.
__device__ __forceinline__ void segment_rows(const int* __restrict__ offsets,
                                             int m, int groups, int s,
                                             int& lo, int& hi) {
  int prev = 0;
  lo = hi = 0;
  for (int sg = 0; sg <= s; ++sg) {
    int a = sg == 0 ? 0 : offsets[sg - 1];
    int b = sg == 0 ? offsets[0] : sg <= groups ? offsets[sg] : m;
    a = min(max(a, prev), m);
    b = min(max(b, a), m);
    prev = b;
    lo = a;
    hi = b;
  }
}

// ---------------------------------------------------------------- dx, bf16
// One slice [nb, nb + BK) of N: A is dy's rows [m0, m0 + BM), zero
// outside [lo, hi); B is w[g]'s rows [k0, k0 + BN), bf16.
template <bool VEC, typename TW>
__device__ __forceinline__ void dx_stage(DxStage& st,
                                         const bf16* __restrict__ dy,
                                         const TW* __restrict__ wg, int m0,
                                         int lo, int hi, int k0, int nb, int k,
                                         int n) {
  for (int c = threadIdx.x; c < BM * BK / 8; c += THREADS) {
    const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
    const int row = m0 + r;
    const bool in = row >= lo && row < hi;
    load8<VEC>(&st.a[r * S_LD + cc],
               dy + static_cast<int64_t>(in ? row : 0) * n, in, nb + cc, n);
    const int kr = k0 + r;
    load8<VEC>(&st.b[r * S_LD + cc],
               wg + static_cast<int64_t>(kr < k ? kr : 0) * n, kr < k,
               nb + cc, n);
  }
}

template <bool VEC, typename TW>
__global__ void __launch_bounds__(THREADS)
    ragged_dx_kernel(const bf16* __restrict__ dy, const TW* __restrict__ w,
                     const int* __restrict__ offsets, bf16* __restrict__ dx,
                     int m, int k, int n, int groups) {
  __shared__ DxStage ring[2];
  __shared__ int item[4];
  if (!find_item<BM>(offsets, m, groups, item)) return;
  const int seg = item[0], m0 = item[1], lo = item[2], hi = item[3];
  const int k0 = blockIdx.x * BN;
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
    const TW* wg = w + static_cast<int64_t>(seg - 1) * k * n;
    const int slices = (n + BK - 1) / BK;
    if (slices > 0) dx_stage<VEC, TW>(ring[0], dy, wg, m0, lo, hi, k0, 0, k, n);
    cp_async_commit();
    for (int t = 0; t < slices; ++t) {
      if (t + 1 < slices)
        dx_stage<VEC, TW>(ring[(t + 1) & 1], dy, wg, m0, lo, hi, k0,
                          (t + 1) * BK, k, n);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const DxStage& st = ring[t & 1];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + (lane & 15);
          ldsm_x4(a[mt], smem_u32(&st.a[r * S_LD + kk + (lane >> 4) * 8]));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          // Matrices 0-3: output columns (rows k of w) 0-7 of the pair
          // at reduction kk..+7 and kk+8..+15, then columns 8-15.
          const int mi = lane >> 3;
          const int kr = wn * 64 + np * 16 + (mi >> 1) * 8 + (lane & 7);
          uint32_t b[4];
          ldsm_x4(b, smem_u32(&st.b[kr * S_LD + kk + (mi & 1) * 8]));
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

  // Rows [lo, hi) of the tile, rounded once to bf16 (segments 0 and
  // groups + 1, the rows outside every group, store zeros).
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + gid + half * 8;
      if (row < lo || row >= hi) continue;
      bf16* xr = dx + static_cast<int64_t>(row) * k;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = k0 + wn * 64 + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (VEC) {
          if (col < k)
            *reinterpret_cast<__nv_bfloat162*>(xr + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < k) xr[col] = __float2bfloat16_rn(v0);
          if (col + 1 < k) xr[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ---------------------------------------------------------------- dw, bf16
// Rows [r0, r0 + BK) of x (columns [k0, k0 + BN)) and dy (columns
// [n0, n0 + BN)), rows at or past hi zero.
template <bool VEC>
__device__ __forceinline__ void dw_stage(DwStage& st,
                                         const bf16* __restrict__ x,
                                         const bf16* __restrict__ dy, int r0,
                                         int hi, int k0, int n0, int k, int n) {
  for (int c = threadIdx.x; c < BK * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int row = r0 + r;
    const bool in = row < hi;
    const int64_t rr = in ? row : 0;
    load8<VEC>(&st.a[r * T_LD + cc], x + rr * k, in, k0 + cc, k);
    load8<VEC>(&st.b[r * T_LD + cc], dy + rr * n, in, n0 + cc, n);
  }
}

template <bool VEC, typename TW>
__global__ void __launch_bounds__(THREADS)
    ragged_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const int* __restrict__ offsets, TW* __restrict__ dw,
                     int m, int k, int n, int groups) {
  __shared__ DwStage ring[2];
  __shared__ int rows[2];
  const int g = blockIdx.z;
  if (threadIdx.x == 0)
    segment_rows(offsets, m, groups, g + 1, rows[0], rows[1]);
  __syncthreads();
  const int lo = rows[0], hi = rows[1];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int slices = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  if (slices > 0) dw_stage<VEC>(ring[0], x, dy, lo, hi, k0, n0, k, n);
  cp_async_commit();
  for (int t = 0; t < slices; ++t) {
    if (t + 1 < slices)
      dw_stage<VEC>(ring[(t + 1) & 1], x, dy, lo + (t + 1) * BK, hi, k0, n0,
                    k, n);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const DwStage& st = ring[t & 1];
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T: matrices (k 0-7, rows kk..+7), (k 8-15, rows kk..+7),
      // (k 0-7, rows kk+8..), (k 8-15, rows kk+8..), each stored as rows
      // of the slice and transposed by ldmatrix.
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = kk + (mi >> 1) * 8 + (lane & 7);
        const int c = wm * 32 + mt * 16 + (mi & 1) * 8;
        ldsm_x4_t(a[mt], smem_u32(&st.a[r * T_LD + c]));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = kk + (mi & 1) * 8 + (lane & 7);
        const int c = wn * 64 + np * 16 + (mi >> 1) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(&st.b[r * T_LD + c]));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  TW* out = dw + static_cast<int64_t>(g) * k * n;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = k0 + wm * 32 + mt * 16 + gid + half * 8;
      if (kr >= k) continue;
      TW* orow = out + static_cast<int64_t>(kr) * n;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + tig * 2;
        if (col < n) orow[col] = store_as<TW>(acc[mt][nt][half * 2]);
        if (col + 1 < n)
          orow[col + 1] = store_as<TW>(acc[mt][nt][half * 2 + 1]);
      }
    }
}

// ------------------------------------------ the TMA + wgmma route, bf16
namespace tc {

constexpr int kBK = 64;              // reduction depth of a ring stage
constexpr int kSteps = kBK / 16;     // wgmma k-steps a stage
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kRingBudget = 220 * 1024;     // of the 227 KB a block may use

// dx: BX rows of dy an item (wgmma's N: 256, or 64 when M <= 64), the
// weights of type TW; a stage holds dy's BX x 64 box and the weights'
// 128 (K) x 64 (N) as boxes of 128 bytes a row.
template <typename TW, int BX>
struct DxCfg {
  static constexpr int kDyBytes = BX * kBK * 2;
  static constexpr int kPanelCols = 128 / static_cast<int>(sizeof(TW));
  static constexpr int kPanels = kBK / kPanelCols;
  static constexpr int kPanelBytes = kBW * 128;
  static constexpr int kStageBytes = kDyBytes + kPanels * kPanelBytes;
  static constexpr int kStages =
      kRingBudget / kStageBytes < 8 ? kRingBudget / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
};

template <typename TW, int BX>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_dx_tc_kernel(const __grid_constant__ CUtensorMap tmdy,
                        const __grid_constant__ CUtensorMap tmw,
                        const int* __restrict__ offsets,
                        bf16* __restrict__ dx, int m, int k, int n,
                        int groups) {
  using C = DxCfg<TW, BX>;
  constexpr int kAcc = BX / 2;   // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[2 * C::kStages];   // full, then empty
  __shared__ int edge[kMaxGroups + 1];
  __shared__ int cum[kMaxGroups + 3];         // items before segment s
  const int tid = threadIdx.x, lane = tid & 31;
  const int col_tiles = (k + kBW - 1) / kBW;
  const int ktiles = (n + kBK - 1) / kBK;     // slices of the reduction

  for (int j = tid; j <= groups; j += kThreads) edge[j] = offsets[j];
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[C::kStages + s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {
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
          tma_load_2d(st, &tmdy, full, kt * kBK, it.r0);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)
            tma_load_3d(st + C::kDyBytes + p * C::kPanelBytes, &tmw, full,
                        kt * kBK + p * C::kPanelCols, it.n0, it.seg - 1);
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

  // A consumer: warpgroup wg owns the K columns [64 wg, 64 wg + 64) of
  // an item's 128, warp w of it 16; the thread's A rows are the K columns
  // c0 and c0 + 8 (rows of w[g]), its reduction indices 2 t, 2 t + 1,
  // 2 t + 8 and 2 t + 9 of each 16-deep step: pairs of adjacent n, one
  // 8-byte (fp32) or 4-byte (bf16) load each from the swizzled box.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int c0 = wg * 64 + warp * 16 + g;
  uint32_t col_off[kSteps][2];   // (step, +8) -> byte offset in a row
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nc = 16 * s + 2 * t + 8 * h;
      const int byte = (nc % C::kPanelCols) * static_cast<int>(sizeof(TW));
      // Row c0 (and c0 + 8) is 7 (mod 8) at g: the swizzle XORs chunk g.
      col_off[s][h] = C::kDyBytes + (nc / C::kPanelCols) * C::kPanelBytes +
                      ((((byte >> 4) ^ g) << 4) | (byte & 15));
    }
  const uint64_t dy_desc = desc(smem_u32(smem), 16, 1024);

  float acc[kAcc];
  uint32_t a[kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  // One slice of the reduction: the stage's A fragments, its kSteps
  // wgmma, and the stage released once they are done.
  auto step = [&]() {
    mbar_wait(smem_u32(&bars[stage]), phase);
    const uint8_t* st = smem + stage * C::kStageBytes;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t* p = st + (c0 + 8 * (e & 1)) * 128 + col_off[s][e >> 1];
        a[s][e] = pack2(reinterpret_cast<const TW*>(p),
                        reinterpret_cast<const TW*>(p) + 1);
      }
    uint64_t db[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      db[s] = dy_desc + ((stage * C::kStageBytes + s * 32) >> 4);
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
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    // Rows outside the groups (segments 0 and groups + 1) store zeros.
    if (it.seg >= 1 && it.seg <= groups)
      for (int kt = 0; kt < ktiles; ++kt) step();

    // acc[4 j + 2 h + e] is (K column c0 + 8 h, row 8 j + 2 t + e) of
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
        if (row < it.r_end && col < k)
          *reinterpret_cast<__nv_bfloat162*>(
              dx + static_cast<int64_t>(row) * k + col) =
              odd ? __floats2bfloat162_rn(other, v1)
                  : __floats2bfloat162_rn(v0, other);
      }
  }
}

// dw: an item is (group, 128-row tile of K, 256-column tile of N); a
// stage holds 64 of the group's rows: x's as two 64-column boxes (K) and
// dy's as four (N), each 64 rows of 128 bytes, 48 KB.
constexpr int kDwRows = 64;
constexpr int kDwN = 256;
constexpr int kDwBox = kDwRows * 128;
constexpr int kDwXBytes = 2 * kDwBox;
constexpr int kDwStageBytes = kDwXBytes + 4 * kDwBox;
constexpr int kDwStages = kRingBudget / kDwStageBytes;
constexpr int kDwSmem = kDwStages * kDwStageBytes + 1024;

// A sum rounded once to bf16, then written in dw's type: two adjacent
// columns.
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(r);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_dw_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmdy,
                        const int* __restrict__ offsets, TW* __restrict__ dw,
                        int m, int k, int n, int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[2 * kDwStages];   // full, then empty
  __shared__ int edge[kMaxGroups + 1];
  const int tid = threadIdx.x, lane = tid & 31;
  const int k_tiles = (k + kBW - 1) / kBW, n_tiles = (n + kDwN - 1) / kDwN;
  const int items = groups * k_tiles * n_tiles;

  for (int j = tid; j <= groups; j += kThreads) edge[j] = offsets[j];
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[kDwStages + s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) scan_edges(edge, groups, m, lane);
  __syncthreads();
  // Item i: group i / (k_tiles n_tiles), then the N tile, then the K
  // tile, fastest: the blocks that run together read one group's rows.
  auto item = [&](int i, int& grp, int& k0, int& n0) {
    grp = i / (k_tiles * n_tiles);
    const int rest = i - grp * k_tiles * n_tiles;
    n0 = rest / k_tiles * kDwN;
    k0 = (rest % k_tiles) * kBW;
  };

  if (tid >= kConsumers) {   // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        int grp, k0, n0;
        item(i, grp, k0, n0);
        for (int r0 = edge[grp]; r0 < edge[grp + 1]; r0 += kDwRows) {
          mbar_wait(smem_u32(&bars[kDwStages + stage]), phase ^ 1);
          const uint32_t full = smem_u32(&bars[stage]);
          const uint32_t st = smem_u32(smem + stage * kDwStageBytes);
          mbar_expect_tx(full, kDwStageBytes);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            tma_load_2d(st + p * kDwBox, &tmx, full, k0 + 64 * p, r0);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_2d(st + kDwXBytes + p * kDwBox, &tmdy, full,
                        n0 + 64 * p, r0);
          if (++stage == kDwStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // A consumer: warpgroup wg owns the K rows [64 wg, 64 wg + 64) of an
  // item's 128 (x's box wg, MN-major A) and all 256 columns (dy's four
  // boxes, MN-major B, 8 KB apart).
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const uint64_t x_desc = desc(base + wg * kDwBox, kDwBox, 1024);
  const uint64_t dy_desc = desc(base + kDwXBytes, kDwBox, 1024);
  float acc[kDwN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int grp, k0, n0;
    item(i, grp, k0, n0);
    const int lo = edge[grp], hi = edge[grp + 1];
#pragma unroll
    for (int j = 0; j < kDwN / 2; ++j) acc[j] = 0.f;
    for (int r0 = lo; r0 < hi; r0 += kDwRows) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      uint8_t* st = smem + stage * kDwStageBytes;
      if (hi - r0 < kDwRows) {
        // The box runs past the group's last row: those rows are other
        // groups' (or past M, read as zeros); zero them in both operands,
        // since dw sums over the rows.
        const int keep = hi - r0;
        for (int e = tid; e < 6 * (kDwRows - keep) * 8; e += kConsumers) {
          const int box = e / ((kDwRows - keep) * 8);
          const int rest = e - box * (kDwRows - keep) * 8;
          *reinterpret_cast<uint4*>(st + box * kDwBox +
                                    (keep + (rest >> 3)) * 128 +
                                    (rest & 7) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      }
      const uint32_t so = stage * kDwStageBytes;
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int s = 0; s < kDwRows / 16; ++s)
        Wgmma<kDwN>::template ss<1, 1>(acc, x_desc + ((so + s * 2048) >> 4),
                                       dy_desc + ((so + s * 2048) >> 4), 1);
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      mbar_arrive(smem_u32(&bars[kDwStages + stage]));
      if (++stage == kDwStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // acc[4 j + 2 h + e] is (K row 64 wg + 16 warp + g + 8 h, column
    // 8 j + 2 t + e) of the item.
    TW* out = dw + static_cast<int64_t>(grp) * k * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + wg * 64 + warp * 16 + g + 8 * h;
      if (kr >= k) continue;
      TW* orow = out + static_cast<int64_t>(kr) * n;
#pragma unroll
      for (int j = 0; j < kDwN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < n) store2(orow + col, acc[4 * j + 2 * h],
                            acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename TW, int BX>
int launch_dx(const CUtensorMap& tmdy, const CUtensorMap& tmw,
              const int* offsets, bf16* dx, int m, int k, int n, int groups,
              int sms, cudaStream_t s) {
  const long long items =
      ((m + BX - 1LL) / BX + groups + 2) * ((k + kBW - 1) / kBW);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const cudaError_t e = cudaFuncSetAttribute(
      ragged_dx_tc_kernel<TW, BX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DxCfg<TW, BX>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ragged_dx_tc_kernel<TW, BX><<<blocks, kThreads, DxCfg<TW, BX>::kSmem, s>>>(
      tmdy, tmw, offsets, dx, m, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------ fp32 on the TF32 tensor cores: dw
namespace tf {

// A stage: x's 32 rows (4 boxes of 32 columns of K), dy's (4 boxes of 32
// columns of N), and dy's rows transposed into a K-major B panel (128 n
// rows of 32 row indices), split: hi, then lo.
constexpr int kDwStages = 3;
constexpr int kDwStageBytes = 4 * kPanel;
constexpr int kDwSmem = kDwStages * kDwStageBytes + 1024;

// dy's 32 rows of a stage (4 boxes of 32 columns) transposed into the
// B panel at bt (row n holds the 32 rows' dy[., n]), split: hi at bt, lo
// one panel on; rows at or past `keep` (other groups', or past M) as
// zeros.  A thread moves 4 x 4 blocks (rows 4 r4.., columns 4 n4..);
// the 8 lanes of a quarter warp take r4 = 0..7 and n4 mod 8 a rotation
// of them, so both the reads (swizzled by the row) and the writes
// (swizzled by n) meet 8 distinct 16-byte chunks.
__device__ __forceinline__ void split_transpose(const uint8_t* raw,
                                                uint8_t* bt, int keep,
                                                int sid) {
  for (int b = sid; b < 256; b += kSplitters) {
    const int r4 = b & 7, h = b >> 3;
    const int n4 = ((h & 3) << 3) | ((r4 + (h >> 2)) & 7);
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * r4 + i;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < keep)
        f = *reinterpret_cast<const float4*>(raw + (n4 >> 3) * kBox +
                                             swz(r, n4 & 7));
      v[i][0] = f.x;
      v[i][1] = f.y;
      v[i][2] = f.z;
      v[i][3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_split(bt, swz(4 * n4 + j, r4), kPanel,
                  make_float4(v[0][j], v[1][j], v[2][j], v[3][j]));
  }
}

// dw[g] = x[rows_g]^T dy[rows_g]: an item is (group, 128 columns of K,
// 128 of N), K tiles fastest, so the blocks that run together read one
// group's rows; each walks its group's rows in order, 32 a stage, and
// writes its tile once (an empty group's as zeros).  A = x^T from
// registers (perm_col, box_at, as the forward's weights); B = dy^T,
// which the splitters transpose, since TF32 wgmma reads B K-major only.
__global__ void __launch_bounds__(kThreads, 1)
    ragged_dw_tf32_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmdy,
                          const int* __restrict__ offsets,
                          float* __restrict__ dw, int m, int k, int n,
                          int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t bars[3 * kDwStages];   // full, ready, empty
  __shared__ int edge[tc::kMaxGroups + 1];
  const int tid = threadIdx.x, lane = tid & 31;
  const int k_tiles = (k + 127) / 128, n_tiles = (n + 127) / 128;
  const int items = groups * k_tiles * n_tiles;

  for (int j = tid; j <= groups; j += kThreads) edge[j] = offsets[j];
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[kDwStages + s]), kSplitters);
      mbar_init(smem_u32(&bars[2 * kDwStages + s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) tc::scan_edges(edge, groups, m, lane);
  __syncthreads();
  auto item = [&](int i, int& grp, int& k0, int& n0) {
    grp = i / (k_tiles * n_tiles);
    const int rest = i - grp * k_tiles * n_tiles;
    n0 = rest / k_tiles * 128;
    k0 = (rest % k_tiles) * 128;
  };

  if (tid >= kConsumers) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int sid = tid - kConsumers - 32;   // splitters: warps 1-3
    if (sid < 0 && tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int grp, k0, n0;
      item(i, grp, k0, n0);
      const int hi = edge[grp + 1];
      for (int r0 = edge[grp]; r0 < hi; r0 += kBK) {
        uint8_t* st = smem + stage * kDwStageBytes;
        if (sid < 0) {
          mbar_wait(smem_u32(&bars[2 * kDwStages + stage]), phase ^ 1);
          const uint32_t full = smem_u32(&bars[stage]);
          const uint32_t sa = smem_u32(st);
          mbar_expect_tx(full, 2 * kPanel);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            tma_load_2d(sa + p * kBox, &tmx, full, k0 + 32 * p, r0);
            tma_load_2d(sa + kPanel + p * kBox, &tmdy, full, n0 + 32 * p,
                        r0);
          }
        } else {
          mbar_wait(smem_u32(&bars[stage]), phase);
          const int keep = hi - r0 < kBK ? hi - r0 : kBK;
          // x's rows past the group: zeros (dw sums over the rows).
          for (int e = sid; e < (kBK - keep) * 32; e += kSplitters)
            *reinterpret_cast<uint4*>(st + (e & 31) / 8 * kBox +
                                      (keep + (e >> 5)) * 128 +
                                      (e & 7) * 16) = make_uint4(0, 0, 0, 0);
          split_transpose(st + kPanel, st + 2 * kPanel, keep, sid);
          fence_proxy_async();
          mbar_arrive(smem_u32(&bars[kDwStages + stage]));
        }
        if (++stage == kDwStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");

  // A consumer: A row g + 8 u of warp `warp` is K column col[u] of the
  // item; its k indices (rows of the group) t and t + 4 of each k8 step.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  int col[2];
  uint32_t aoff[4];
#pragma unroll
  for (int u = 0; u < 2; ++u) col[u] = perm_col(wg, warp, g, u);
#pragma unroll
  for (int e = 0; e < 4; ++e) aoff[e] = box_at(t + 4 * (e >> 1), col[e & 1]);
  const uint64_t d0 = desc(smem_u32(smem) + 2 * kPanel);

  float total[64], chunk[64];
  uint32_t ah[kSteps][4], al[kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int grp, k0, n0;
    item(i, grp, k0, n0);
    const int lo = edge[grp], hi = edge[grp + 1];
#pragma unroll
    for (int j = 0; j < 64; ++j) total[j] = 0.f;
    for (int r0 = lo; r0 < hi; r0 += kBK) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      mbar_wait(smem_u32(&bars[kDwStages + stage]), phase);
      const uint8_t* xs = smem + stage * kDwStageBytes;
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(*reinterpret_cast<const float*>(xs + aoff[e] + 1024 * s),
                ah[s][e], al[s][e]);
      products(total, chunk, ah, al, d0 + ((stage * kDwStageBytes) >> 4));
      mbar_arrive(smem_u32(&bars[2 * kDwStages + stage]));
      if (++stage == kDwStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // total[4 j + 2 u + e] is (K row col[u], N column 8 j + 2 t + e).
    float* outg = dw + static_cast<int64_t>(grp) * k * n;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kr = k0 + col[u];
      if (kr >= k) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < n)
          *reinterpret_cast<float2*>(outg + static_cast<int64_t>(kr) * n +
                                     c) =
              make_float2(total[4 * j + 2 * u], total[4 * j + 2 * u + 1]);
      }
    }
  }
}

}  // namespace tf

// ---------------------------------------------------------------- fp32
constexpr int F_TILE = 64;   // output rows and columns a block computes
constexpr int F_BK = 16;     // the reduction slice in shared memory

// dx = dy w[g]^T: the forward's fp32 work items over 64-row tiles.
__global__ void __launch_bounds__(THREADS)
    ragged_dx_f32_kernel(const float* __restrict__ dy,
                         const float* __restrict__ w,
                         const int* __restrict__ offsets,
                         float* __restrict__ dx, int m, int k, int n,
                         int groups) {
  __shared__ float as[F_BK][F_TILE + 4];   // dy's slice, reduction-major
  __shared__ float bs[F_BK][F_TILE + 4];   // w[g]'s slice
  __shared__ int item[4];
  if (!find_item<F_TILE>(offsets, m, groups, item)) return;
  const int seg = item[0], m0 = item[1], lo = item[2], hi = item[3];
  const int k0 = blockIdx.x * F_TILE;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  if (seg >= 1 && seg <= groups) {
    const float* wg = w + static_cast<int64_t>(seg - 1) * k * n;
    for (int nb = 0; nb < n; nb += F_BK) {
      for (int e = threadIdx.x; e < F_TILE * F_BK; e += THREADS) {
        const int r = e / F_BK, j = e % F_BK, row = m0 + r, kr = k0 + r;
        as[j][r] = row >= lo && row < hi && nb + j < n
                       ? dy[static_cast<int64_t>(row) * n + nb + j]
                       : 0.0f;
        bs[j][r] = kr < k && nb + j < n
                       ? wg[static_cast<int64_t>(kr) * n + nb + j]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < F_BK; ++j) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = as[j][tr * 4 + i];
          b[i] = bs[j][tc * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tr * 4 + i;
    if (row < lo || row >= hi) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = k0 + tc * 4 + jj;
      if (col < k) dx[static_cast<int64_t>(row) * k + col] = acc[i][jj];
    }
  }
}

// dw[g] = x[rows_g]^T dy[rows_g]: grid (N tile, K tile, group).
__global__ void __launch_bounds__(THREADS)
    ragged_dw_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy,
                         const int* __restrict__ offsets,
                         float* __restrict__ dw, int m, int k, int n,
                         int groups) {
  __shared__ float as[F_BK][F_TILE + 4];   // x's slice: [row][k]
  __shared__ float bs[F_BK][F_TILE + 4];   // dy's slice: [row][n]
  __shared__ int rows[2];
  const int g = blockIdx.z;
  if (threadIdx.x == 0)
    segment_rows(offsets, m, groups, g + 1, rows[0], rows[1]);
  __syncthreads();
  const int lo = rows[0], hi = rows[1];
  const int n0 = blockIdx.x * F_TILE, k0 = blockIdx.y * F_TILE;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int r0 = lo; r0 < hi; r0 += F_BK) {
    for (int e = threadIdx.x; e < F_TILE * F_BK; e += THREADS) {
      const int j = e / F_TILE, c = e % F_TILE, row = r0 + j;
      as[j][c] = row < hi && k0 + c < k
                     ? x[static_cast<int64_t>(row) * k + k0 + c]
                     : 0.0f;
      bs[j][c] = row < hi && n0 + c < n
                     ? dy[static_cast<int64_t>(row) * n + n0 + c]
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[j][tr * 4 + i];
        b[i] = bs[j][tc * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
  float* out = dw + static_cast<int64_t>(g) * k * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + tr * 4 + i;
    if (kr >= k) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tc * 4 + jj;
      if (col < n) out[static_cast<int64_t>(kr) * n + col] = acc[i][jj];
    }
  }
}

template <typename TW>
void dx_bf16(dim3 grid, cudaStream_t s, const void* dy, const void* w,
             const int* op, void* dx, int m, int k, int n, int groups,
             int vec) {
  auto* dyp = static_cast<const bf16*>(dy);
  auto* wp = static_cast<const TW*>(w);
  auto* dxp = static_cast<bf16*>(dx);
  if (vec)
    ragged_dx_kernel<true, TW><<<grid, THREADS, 0, s>>>(dyp, wp, op, dxp, m,
                                                         k, n, groups);
  else
    ragged_dx_kernel<false, TW><<<grid, THREADS, 0, s>>>(dyp, wp, op, dxp, m,
                                                          k, n, groups);
}

template <typename TW>
void dw_bf16(dim3 grid, cudaStream_t s, const void* x, const void* dy,
             const int* op, void* dw, int m, int k, int n, int groups,
             int vec) {
  auto* xp = static_cast<const bf16*>(x);
  auto* dyp = static_cast<const bf16*>(dy);
  auto* dwp = static_cast<TW*>(dw);
  if (vec)
    ragged_dw_kernel<true, TW><<<grid, THREADS, 0, s>>>(xp, dyp, op, dwp, m,
                                                         k, n, groups);
  else
    ragged_dw_kernel<false, TW><<<grid, THREADS, 0, s>>>(xp, dyp, op, dwp, m,
                                                          k, n, groups);
}

}  // namespace

// dx (m, k) from dy (m, n) and w (groups, k, n); offsets (groups + 1,)
// int32; all on the device.  fp32 != 0: dy, w, dx float32 (the CUDA
// cores); else dy and dx bf16 and w bf16, or float32 with w_fp32 != 0
// (rounded on load).  vec != 0 when k and n are multiples of 8 and every
// pointer is 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int ragged_dot_dx_launch(const void* dy, const void* w,
                                    const void* offsets, void* dx, int m,
                                    int k, int n, int groups, int vec,
                                    int fp32, int w_fp32, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (n < 0 || groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = fp32 ? F_TILE : BM;
  const long long items =
      (m + tile - 1) / tile + static_cast<long long>(groups) + 2;
  const long long col_tiles = (k + tile - 1) / tile;
  if (items > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  if (fp32)
    ragged_dx_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w), op,
        static_cast<float*>(dx), m, k, n, groups);
  else if (w_fp32)
    dx_bf16<float>(grid, s, dy, w, op, dx, m, k, n, groups, vec);
  else
    dx_bf16<bf16>(grid, s, dy, w, op, dx, m, k, n, groups, vec);
  return static_cast<int>(cudaGetLastError());
}

// dw (groups, k, n) from x (m, k) and dy (m, n); offsets (groups + 1,)
// int32.  fp32 != 0: x, dy, dw float32 (the CUDA cores); else x and dy
// bf16 and dw bf16, or float32 with w_fp32 != 0 (each sum rounded to
// bf16 first).  vec as for dx.  Returns the launch's CUDA error.
extern "C" int ragged_dot_dw_launch(const void* x, const void* dy,
                                    const void* offsets, void* dw, int m,
                                    int k, int n, int groups, int vec,
                                    int fp32, int w_fp32, void* stream) {
  if (groups <= 0 || k <= 0 || n <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = fp32 ? F_TILE : BN;
  const long long k_tiles = (k + tile - 1) / tile;
  if (k_tiles > 65535 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile),
                  static_cast<unsigned>(k_tiles),
                  static_cast<unsigned>(groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  if (fp32)
    ragged_dw_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), op,
        static_cast<float*>(dw), m, k, n, groups);
  else if (w_fp32)
    dw_bf16<float>(grid, s, x, dy, op, dw, m, k, n, groups, vec);
  else
    dw_bf16<bf16>(grid, s, x, dy, op, dw, m, k, n, groups, vec);
  return static_cast<int>(cudaGetLastError());
}

// The TMA + wgmma routes (bf16 x and dy): dx (m, k) bf16 from dy (m, n)
// and w (groups, k, n) fp32 (w_fp32 != 0, rounded on load) or bf16; dw
// (groups, k, n) in w's type from x (m, k) and dy.  k and n multiples of
// 8, x, dy and w on 16 bytes, groups <= 1024 (ops.TC_MAX_GROUPS).
// Return the launch's CUDA error (0 on success), or 100000 plus the
// CUresult of a tensor map that could not be encoded.
extern "C" int ragged_dot_dx_tc_launch(const void* dy, const void* w,
                                       const void* offsets, void* dx, int m,
                                       int k, int n, int groups, int w_fp32,
                                       void* stream) {
  using namespace tc;
  if (m <= 0 || k <= 0) return 0;
  const int esz = w_fp32 ? 4 : 2;
  if (n < 0 || groups < 0 || groups > kMaxGroups || k % 8 != 0 ||
      n % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // 64-row items when every group fits in one, else 256.
  const int bx = m <= 64 ? 64 : 256;
  CUtensorMap tmdy, tmw;
  memset(&tmdy, 0, sizeof(tmdy));
  memset(&tmw, 0, sizeof(tmw));
  if (n > 0) {   // with n == 0 no item loads: every row is zero
    const cuuint64_t ddim[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(n) * 2};
    const cuuint32_t dbox[2] = {kBK, static_cast<cuuint32_t>(bx)};
    int r = encode(&tmdy, dy, false, 2, ddim, dstride, dbox);
    if (r != 0) return 100000 + r;
    if (groups > 0) {
      const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(k),
                                  static_cast<cuuint64_t>(groups)};
      const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(n) * esz,
                                     static_cast<cuuint64_t>(k) * n * esz};
      const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(128 / esz), kBW,
                                  1};
      r = encode(&tmw, w, w_fp32 != 0, 3, wdim, wstride, wbox);
      if (r != 0) return 100000 + r;
    }
  }
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  auto* dxp = static_cast<bf16*>(dx);
  if (bx == 64)
    return w_fp32 ? launch_dx<float, 64>(tmdy, tmw, op, dxp, m, k, n, groups,
                                         sms, s)
                  : launch_dx<bf16, 64>(tmdy, tmw, op, dxp, m, k, n, groups,
                                        sms, s);
  return w_fp32 ? launch_dx<float, 256>(tmdy, tmw, op, dxp, m, k, n, groups,
                                        sms, s)
                : launch_dx<bf16, 256>(tmdy, tmw, op, dxp, m, k, n, groups,
                                       sms, s);
}

extern "C" int ragged_dot_dw_tc_launch(const void* x, const void* dy,
                                       const void* offsets, void* dw, int m,
                                       int k, int n, int groups, int w_fp32,
                                       void* stream) {
  using namespace tc;
  if (groups <= 0 || k <= 0 || n <= 0) return 0;
  if (m < 0 || groups > kMaxGroups || k % 8 != 0 || n % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmdy;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmdy, 0, sizeof(tmdy));
  if (m > 0) {   // with m == 0 every group is empty: dw is zero
    const cuuint32_t box[2] = {64, kDwRows};
    const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(k) * 2};
    int r = encode(&tmx, x, false, 2, xdim, xstride, box);
    if (r != 0) return 100000 + r;
    const cuuint64_t ddim[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(n) * 2};
    r = encode(&tmdy, dy, false, 2, ddim, dstride, box);
    if (r != 0) return 100000 + r;
  }
  const long long items = static_cast<long long>(groups) *
                          ((k + kBW - 1) / kBW) * ((n + kDwN - 1) / kDwN);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<const int*>(offsets);
  cudaError_t err;
  if (w_fp32) {
    err = cudaFuncSetAttribute(ragged_dw_tc_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDwSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ragged_dw_tc_kernel<float><<<blocks, kThreads, kDwSmem, s>>>(
        tmx, tmdy, op, static_cast<float*>(dw), m, k, n, groups);
  } else {
    err = cudaFuncSetAttribute(ragged_dw_tc_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDwSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ragged_dw_tc_kernel<bf16><<<blocks, kThreads, kDwSmem, s>>>(
        tmx, tmdy, op, static_cast<bf16*>(dw), m, k, n, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fp32 routes on the TF32 tensor cores (ragged_tf32.cuh): dx (m, k)
// from dy (m, n) and w (groups, k, n), dw (groups, k, n) from x (m, k)
// and dy, all float32; k and n multiples of 4, every pointer on 16
// bytes, groups <= 1024 (ops.fp32_tc_route).  Return the launch's CUDA
// error (0 on success), or 100000 plus the CUresult of a tensor map that
// could not be encoded.
extern "C" int ragged_dot_dx_tf32_launch(const void* dy, const void* w,
                                         const void* offsets, void* dx,
                                         int m, int k, int n, int groups,
                                         void* stream) {
  using namespace tf;
  if (m <= 0 || k <= 0) return 0;
  if (n < 0 || !takes(k, n, groups,
                      reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmdy, tmw;
  memset(&tmdy, 0, sizeof(tmdy));
  memset(&tmw, 0, sizeof(tmw));
  if (n > 0) {   // with n == 0 no item loads: every row is zero
    const cuuint64_t ddim[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(n) * 4};
    const cuuint32_t dbox[2] = {kBK, kRows};
    int r = tc::encode(&tmdy, dy, true, 2, ddim, dstride, dbox);
    if (r != 0) return 100000 + r;
    if (groups > 0) {
      const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(k),
                                  static_cast<cuuint64_t>(groups)};
      const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(n) * 4,
                                     static_cast<cuuint64_t>(k) * n * 4};
      const cuuint32_t wbox[3] = {kBK, tc::kBW, 1};
      r = tc::encode(&tmw, w, true, 3, wdim, wstride, wbox);
      if (r != 0) return 100000 + r;
    }
  }
  return launch<true>(tmdy, tmw, static_cast<const int*>(offsets),
                      static_cast<float*>(dx), m, k, n, groups,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_dot_dw_tf32_launch(const void* x, const void* dy,
                                         const void* offsets, void* dw,
                                         int m, int k, int n, int groups,
                                         void* stream) {
  using namespace tf;
  if (groups <= 0 || k <= 0 || n <= 0) return 0;
  if (m < 0 || !takes(k, n, groups,
                      reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(dw)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmdy;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmdy, 0, sizeof(tmdy));
  if (m > 0) {   // with m == 0 every group is empty: dw is zero
    const cuuint32_t box[2] = {32, kBK};
    const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(k) * 4};
    int r = tc::encode(&tmx, x, true, 2, xdim, xstride, box);
    if (r != 0) return 100000 + r;
    const cuuint64_t ddim[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t dstride[1] = {static_cast<cuuint64_t>(n) * 4};
    r = tc::encode(&tmdy, dy, true, 2, ddim, dstride, box);
    if (r != 0) return 100000 + r;
  }
  const long long items = static_cast<long long>(groups) *
                          ((k + 127) / 128) * ((n + 127) / 128);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e = tc::sm_count(&sms);
  if (e != 0) return e;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const cudaError_t err = cudaFuncSetAttribute(
      ragged_dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_dw_tf32_kernel<<<blocks, kThreads, kDwSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tmx, tmdy, static_cast<const int*>(offsets), static_cast<float*>(dw),
      m, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}
