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
// at 989e12 FLOP/s, against ~0.5 GB: operations bind.
//
// Design of the bf16 route (x bf16; w bf16, or fp32 rounded on load):
// mma.sync m16n8k16 with fp32 accumulators, a block of 8 warps computing
// a 128 x 128 output tile, each warp 32 x 64, from a two-stage ring of
// 32-deep slices (cp.async for whole 16-byte chunks; plain loads for
// ragged rows and for fp32 weights, which are rounded as they are
// stored to shared memory).
// - dx: the forward's work items ((group, 128-row tile) pairs whose rows
//   meet, found by walking the offsets; rows of other groups zeroed on
//   load and left out of the store), the output's columns over K, the
//   slices over N.  A = dy's rows (ldmatrix); B = w[g]'s rows k as they
//   are stored, n contiguous, which is mma's column-major B, so plain
//   ldmatrix serves the transposed weights.
// - dw: grid (N tile, K tile, group); each block walks its group's rows
//   in ascending order, 32 a slice, from the group's first row (so no
//   slice is shared with another group), and writes its tile once: no
//   atomics and no split over the rows across blocks (mixtral's gate/up
//   has 112 x 32 x 8 tiles).  A = x^T and B = dy, both stored row by row
//   as they are in memory, and ldmatrix .trans transposes the A slice.
// fp32 (x and w fp32): the CUDA cores, 64 x 64 outputs a block of 256
// threads, 4 x 4 a thread, fp32 FMAs in the reduction's order from
// 16-deep slices in shared memory (plain loads): the fp32 compute mode's
// route, not a fast one.
//
// Both are deterministic: every output is summed by one thread in a
// fixed order.  The launchers are plain C functions (no PyTorch headers)
// that return cudaGetLastError, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_bf16.cuh"
#include "../../csrc/sm90.cuh"
#include "ragged_items.cuh"

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
