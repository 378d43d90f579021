// The grouped (ragged) matrix product of the mixture-of-experts FFN:
// rows sorted by group, each group's rows times its own weight matrix.
// bf16 inputs (the path's) on the tensor cores with fp32 accumulation and
// one rounding to bf16; fp32 inputs (the port's fp32 compute mode) on the
// CUDA cores in fp32.
//
// The port's counterpart of jax.lax.ragged_dot as repro/models/moe.py
// (moe_ffn, :67-73) calls it.  ragged_dot is an XLA operation, not a
// Pallas kernel: the JAX package has no TPU kernel for it to replace.
//
//   x (M, K) bf16, rows sorted by group; w (G, K, N) bf16;
//   offsets (G + 1,) int32 on the device, group g the rows
//   [offsets[g], offsets[g + 1]); rows outside [offsets[0], offsets[G])
//   are zero
//   -> y (M, N) bf16,  y[r] = bf16(sum_k x[r, k] w[g(r), k, :]) in fp32.
//
// The offsets are read on the card: the caller never needs a group's
// size on the host, so a MoE layer makes no host sync (a loop of
// torch.matmul over the groups would need every size there).
//
// Bound.  2 M K N FLOP at the bf16 tensor-core rate against the bytes
// (x, every non-empty group's weights and y, each once).  mixtral's
// prefill wave (8000 rows, K = 4096, N = 14336) is 9.4e11 FLOP, 0.95 ms
// at 989e12 FLOP/s: operations bind.  A decode step (8 rows) reads the
// active experts' weights, 117 MB each: bytes bind.
//
// Design (simple first; wgmma, TMA and rounding fp32 weights on load
// are later work).  The rows are cut into 128-row tiles aligned at 0; a
// work item is one (group, row tile) pair whose rows meet, so a tile
// that spans a group edge is computed once for each of its groups with
// the other groups' rows zeroed on load and left out of the store.
// There are at most ceil(M / 128) + G such items, plus two that write
// zeros before offsets[0] and past offsets[G]; grid.y counts that many
// and each block finds its own item by walking the offsets (G is a few
// dozen at most).  A block of 8
// warps computes a 128 x 128 tile of y on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), each warp 32 x 64, from a two-stage cp.async ring
// of 32-deep K slices: x's rows as A (ldmatrix), w's rows [k][n] as B
// (ldmatrix .trans).  Rows and columns past the edges load as zeros.
// Inputs whose rows are not whole 16-byte chunks (K or N not a multiple
// of 8, or a base off 16 bytes) take plain loads instead of cp.async.
//
// fp32 (ragged_dot_f32_kernel): the same work items on 64-row tiles; a
// block of 256 threads computes 64 x 64 outputs, 4 x 4 a thread, with
// fp32 FMAs in k order from 16-deep slices in shared memory (plain
// loads).  It is what the fp32 compute mode needs to hold the plain
// version's fp32 sums, not a fast path (about 67e12 FLOP/s at best).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This block's work item, the blockIdx.y-th (segment, row tile) pair in
// row order, into item = {segment, tile's first row, lo, hi}; false when
// there is none (the grid counts the most there can be).  Segment 0 is
// the rows before offsets[0], segment s in [1, groups] group s - 1,
// segment groups + 1 the rows past offsets[groups]; the first and last
// are written as zeros.  Each segment starts where the one before it
// ended (offsets that go down make empty groups), so every row belongs
// to exactly one.  Thread 0 walks the offsets; the block reads item.
template <int TILE>
__device__ __forceinline__ bool find_item(const int* __restrict__ offsets,
                                          int m, int groups, int (&item)[4]) {
  if (threadIdx.x == 0) {
    int left = blockIdx.y, found = -1, prev = 0;
    for (int sg = 0; sg <= groups + 1 && found < 0; ++sg) {
      int lo = sg == 0 ? 0 : offsets[sg - 1];
      int hi = sg == 0 ? offsets[0] : sg <= groups ? offsets[sg] : m;
      lo = min(max(lo, prev), m);
      hi = min(max(hi, lo), m);
      prev = hi;
      if (lo >= hi) continue;
      const int t0 = lo / TILE, count = (hi - 1) / TILE - t0 + 1;
      if (left < count) {
        found = sg;
        item[1] = (t0 + left) * TILE;
        item[2] = max(lo, item[1]);
        item[3] = min(hi, item[1] + TILE);
      }
      left -= count;
    }
    item[0] = found;
  }
  __syncthreads();
  return item[0] >= 0;
}

// One K slice [kb, kb + BK) into a ring stage: A is rows [m0, m0 + BM)
// of x, zero outside [lo, hi); B is rows [kb, kb + BK) of the group's
// weights, columns [n0, n0 + BN).
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& st,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ wg,
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
    if (VEC) {
      const bool v = kk < k && col < n;
      cp_async16(smem_u32(dst),
                 v ? wg + static_cast<size_t>(kk) * n + col : wg, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = kk < k && col + j < n
                     ? wg[static_cast<size_t>(kk) * n + col + j]
                     : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    ragged_dot_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
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
    const __nv_bfloat16* wg = w + static_cast<size_t>(seg - 1) * k * n;
    const int ktiles = (k + BK - 1) / BK;
    if (ktiles > 0) load_stage<VEC>(ring[0], x, wg, m0, lo, hi, n0, 0, k, n);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles)
        load_stage<VEC>(ring[(kt + 1) & 1], x, wg, m0, lo, hi, n0,
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

// x (m, k), w (groups, k, n), offsets (groups + 1,) int32 and y (m, n),
// all on the device, bf16 (fp32 != 0: float32); vec != 0 when k and n
// are multiples of 8 and x, w and y start on 16 bytes (bf16 only).
// Returns the launch's CUDA error (0 on success).
extern "C" int ragged_dot_launch(const void* x, const void* w,
                                 const void* offsets, void* y, int m, int k,
                                 int n, int groups, int vec, int fp32,
                                 void* stream) {
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
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (vec)
    ragged_dot_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, op, yp, m, k, n,
                                                     groups);
  else
    ragged_dot_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, op, yp, m, k, n,
                                                      groups);
  return static_cast<int>(cudaGetLastError());
}
